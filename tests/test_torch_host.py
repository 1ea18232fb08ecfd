"""PyTorch port, host layer: filters, text, hashing (and the native
tokenizer), record store and paths against the JAX package; the device
rule; and the import boundary (the port imports neither jax nor the JAX
package). All comparisons are exact: these modules are copies."""

import datetime
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from c99_vectordb_tpu.storage import paths as jpaths
from c99_vectordb_tpu.storage import snapshot as jsnap
from c99_vectordb_tpu.storage.yaml_store import RecordStore as JRecordStore
from c99_vectordb_tpu.utils import filters as jfilters
from c99_vectordb_tpu.utils import hashing as jhashing
from c99_vectordb_tpu.utils import text as jtext
from c99_vectordb_tpu_torch import native as tnative
from c99_vectordb_tpu_torch.storage import paths as tpaths
from c99_vectordb_tpu_torch.storage import snapshot as tsnap
from c99_vectordb_tpu_torch.storage.yaml_store import RecordStore as TRecordStore
from c99_vectordb_tpu_torch.utils import filters as tfilters
from c99_vectordb_tpu_torch.utils import hashing as thashing
from c99_vectordb_tpu_torch.utils import text as ttext
from c99_vectordb_tpu_torch.utils.runtime import resolve_device

REPO = Path(__file__).resolve().parent.parent

TEXTS = [
    "Hello World hello",
    "the_quick brown-fox; jumps!! over 42 lazy_dogs",
    "",
    "   \t\n  ",
    "UPPER lower MiXeD 0123 _underscore_",
    "a" * 500 + " b",
    "unicode üñîсö 中文 tokens",
    "--- deleted\n",
]

FILTERS = [
    "{}", "", "source: user", "{source: user, priority: {$gte: 2}}",
    "{p: {$lte: 2}}", "{p: {$ne: 3}}", "{name: {$prefix: ab}}",
    "{name: {$contains: bc}}", "{tags: b}", "{$or: [{p: 1}, {p: 3}]}",
    "{$and: [{p: {$gte: 1}}, {source: agent}]}", "{p: {$gte: 2, $lte: 4}}",
    "{p: {$bogus: 1}}", "{n: 5}",
]

METAS = [
    {"source": "user", "priority": 3, "p": 3, "name": "abc", "tags": ["a", "b"], "n": "5"},
    {"source": "agent", "priority": 1, "p": 1, "name": "xbcx"},
    {"p": 2.5, "n": 5},
    {"other": True},
    {},
]


@pytest.mark.parametrize("expr", FILTERS)
def test_filters_match_jax_package(expr):
    jp = jfilters.parse_filter(expr)
    tp = tfilters.parse_filter(expr)
    assert jp == tp
    assert [jfilters.matches(m, jp) for m in METAS] == [tfilters.matches(m, tp) for m in METAS]


def test_filter_errors_match_jax_package():
    for bad in ("[1, 2]", "source: user, priority: {$gte: 2}"):
        with pytest.raises(Exception) as je:
            jfilters.parse_filter(bad)
        with pytest.raises(Exception) as te:
            tfilters.parse_filter(bad)
        assert type(je.value).__name__ == type(te.value).__name__


@pytest.mark.parametrize("text", TEXTS)
def test_text_and_hashing_match_jax_package(text):
    assert jtext.tokenize(text) == ttext.tokenize(text)
    assert jtext.is_blank_body(text) == ttext.is_blank_body(text)
    assert jtext.is_deleted_record({"deleted": True}, text) == ttext.is_deleted_record(
        {"deleted": True}, text)
    assert jtext.is_deleted_record(None, text) == ttext.is_deleted_record(None, text)
    jb, js = jhashing.token_features(text, 384)
    tb, ts = thashing.token_features(text, 384)
    np.testing.assert_array_equal(jb, tb)
    np.testing.assert_array_equal(js, ts)
    assert jhashing.fnv1a_64(text.encode()) == thashing.fnv1a_64(text.encode())


def test_native_tokenizer_builds_and_matches_jax_package():
    assert tnative.lib() is not None, "native build failed (g++ present in image)"
    ascii_texts = [t for t in TEXTS if t.isascii()]
    for texts in (ascii_texts, TEXTS):  # native path, then the Python fallback
        got = thashing.batch_token_features(texts, 384)
        want = jhashing.batch_token_features(texts, 384)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


STORE_CASES = [
    ("plain ascii body\n", {"k": "v"}),
    ("", None),
    ("no trailing newline", {}),
    ("trailing space \nnext\n", {"tags": ["a", "b"], "n": 3}),
    ("long " + "word " * 80 + "\n", {"long": "word " * 60}),
    ("unicode üñîсö中文\n", {"u": "éè"}),
    ("emoji \U0001f600 body\n", {"k": "v"}),
    ("plain\n", {"s": "nel\x85sep", "ls": "a b"}),
    ("ctrl\x07char\n", None),
    ("- looks like yaml\nkey: value\n", {"nested": {"a": [1, 2, {"b": "c"}]}}),
    ("dated\n", {"when": datetime.date(2024, 1, 2)}),
]


def test_record_store_dump_byte_equal(tmp_path):
    js, ts = JRecordStore(), TRecordStore()
    for body, meta in STORE_CASES:
        js.append(body, meta)
        ts.append(body, meta)
        assert js.dump() == ts.dump()
    js.save(tmp_path / "j.yaml")
    ts.save(tmp_path / "t.yaml")
    assert (tmp_path / "j.yaml").read_bytes() == (tmp_path / "t.yaml").read_bytes()
    # Each package loads the other's file to the same records.
    a = TRecordStore.load(tmp_path / "j.yaml")
    b = JRecordStore.load(tmp_path / "t.yaml")
    assert a.bodies == b.bodies and a.metas == b.metas
    ca, da = a.compact()
    cb, db = b.compact()
    assert da == db and ca.dump() == cb.dump()


def test_snapshot_cross_reads(tmp_path, monkeypatch):
    monkeypatch.setattr(jsnap, "SNAP_THRESHOLD_BYTES", 0)
    monkeypatch.setattr(tsnap, "SNAP_THRESHOLD_BYTES", 0)
    store = JRecordStore()
    for body, meta in STORE_CASES:
        store.append(body, meta)
    store.save(tmp_path / "db.yaml")
    text = (tmp_path / "db.yaml").read_text(encoding="utf-8")
    cached = tsnap.read_snapshot(tsnap.snap_path(tmp_path / "db.yaml"), text)
    assert cached is not None and cached[0] == store.bodies and cached[1] == store.metas


@pytest.mark.parametrize("base", ["notes", "/abs/db", "sub/dir/db", "my.db.v2"])
def test_paths_match_jax_package(base, tmp_path):
    assert jpaths.db_paths(base, str(tmp_path)) == tpaths.db_paths(base, str(tmp_path))


def test_device_rule(monkeypatch):
    monkeypatch.delenv("C99VDB_PLATFORM", raising=False)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("C99VDB_PLATFORM", "cpu")
    assert resolve_device(None) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    monkeypatch.delenv("C99VDB_PLATFORM")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)  # the default is cuda, never a silent CPU
    with pytest.raises(ValueError):
        resolve_device("mps")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_port_imports_no_jax():
    """Import every module of the port with jax blocked, in a fresh process
    (this one has jax loaded already), and check that nothing of the JAX
    package came along."""
    pkg = REPO / "c99_vectordb_tpu_torch"
    modules = sorted(
        "c99_vectordb_tpu_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
        for p in pkg.rglob("*.py")
    )
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'c99_vectordb_tpu' or m.startswith('c99_vectordb_tpu.'))\n"
        "bad = [m for m in bad if sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(REPO), env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "ok" in res.stdout
    assert len(modules) >= 20
    assert {"c99_vectordb_tpu_torch.ops.kmeans", "c99_vectordb_tpu_torch.ops.ivf_scan",
            "c99_vectordb_tpu_torch.ops.ivf_scan_cuda", "c99_vectordb_tpu_torch.ops.cuda_build",
            "c99_vectordb_tpu_torch.models.ivf_flat", "c99_vectordb_tpu_torch.models.ivf_pq",
            "c99_vectordb_tpu_torch.ops.adc", "c99_vectordb_tpu_torch.ops.adc_cuda",
            "c99_vectordb_tpu_torch.parallel", "c99_vectordb_tpu_torch.parallel.mesh",
            "c99_vectordb_tpu_torch.parallel.sharded",
            "c99_vectordb_tpu_torch.parallel.dryrun"} <= set(modules)
    chip = subprocess.run(
        [sys.executable, "-c",
         "import ast, sys; t = ast.parse(open('chip_smoke.py').read());"
         "names = [a.name for n in ast.walk(t) if isinstance(n, ast.Import) for a in n.names]"
         " + [n.module or '' for n in ast.walk(t) if isinstance(n, ast.ImportFrom)];"
         "bad = [n for n in names if n.split('.')[0] in ('jax', 'c99_vectordb_tpu')];"
         "sys.exit(1 if bad else 0)"],
        cwd=str(REPO), timeout=60,
    )
    assert chip.returncode == 0, "chip_smoke.py imports jax or the JAX package"
