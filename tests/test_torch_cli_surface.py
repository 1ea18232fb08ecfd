"""The PyTorch port's CLI surface beyond the golden scenarios: the device
rule (the card by default, never the CPU by itself), the verbs that never
import torch, the launchers, the reporting and timing helpers against the
JAX package's, and the ranking distance's fixed summation order, which
gives the JAX package's bits at the embedder's width."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from datetime import datetime
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cli_golden import SAVE_INPUT, Pair

from c99_vectordb_tpu.ops import distances as jdist
from c99_vectordb_tpu.utils import reporting as jrep
from c99_vectordb_tpu.utils import timing as jtiming
from c99_vectordb_tpu_torch import cli as torch_cli
from c99_vectordb_tpu_torch.ops import distances as tdist
from c99_vectordb_tpu_torch.utils import reporting as trep
from c99_vectordb_tpu_torch.utils import timing as ttiming

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cwd(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "in.yaml").write_text(SAVE_INPUT)
    return tmp_path


def run_torch(capsys, *argv):
    rc = torch_cli.main(["memo", *argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


# -- the device rule -------------------------------------------------------------

VERBS = {
    "save": ("save", "in.yaml"),
    "recall": ("recall", "tea"),
    "reindex": ("reindex",),
    "serve": ("serve", "--batch", "4"),
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("C99VDB_PLATFORM", raising=False)


@pytest.mark.parametrize("verb", sorted(VERBS))
def test_no_card_is_one_error_line(cwd, capsys, monkeypatch, no_card, verb):
    """Without C99VDB_PLATFORM the compute verbs ask for CUDA; with no card
    they print one Error line, exit 1 and touch no file."""
    monkeypatch.setattr("sys.stdin", __import__("io").StringIO("tea\n"))
    rc, out, err = run_torch(capsys, "-f", "db", *VERBS[verb])
    assert rc == 1 and out == ""
    assert err.count("\n") == 1 and err.startswith("Error: CUDA was requested")
    assert sorted(p.name for p in cwd.iterdir()) == ["in.yaml"]


def test_cpu_threshold_is_ignored(cwd, capsys, monkeypatch, no_card):
    """The JAX CLI moves corpora under C99VDB_CPU_THRESHOLD to the CPU by
    itself; the port never does (a documented deviation)."""
    monkeypatch.setenv("C99VDB_CPU_THRESHOLD", str(10**9))
    rc, out, err = run_torch(capsys, "-f", "db", "save", "in.yaml")
    assert (rc, out) == (1, "") and err.startswith("Error: CUDA was requested")
    monkeypatch.setenv("C99VDB_PLATFORM", "cpu")
    rc, out, err = run_torch(capsys, "-f", "db", "save", "in.yaml")
    assert rc == 0 and err == "" and out.startswith("Memorized:")


@pytest.mark.parametrize("platform", ["auto", "tpu", "default"])
def test_unsupported_platform_is_one_error_line(cwd, capsys, monkeypatch, platform):
    monkeypatch.setenv("C99VDB_PLATFORM", platform)
    rc, out, err = run_torch(capsys, "-f", "db", "recall", "tea")
    assert (rc, out) == (1, "")
    assert err == f"Error: unsupported device '{platform}' (expected cpu or cuda)\n"


@pytest.mark.parametrize("kind", ["sharded_flat", "sharded_ivf", "sharded_ivf_pq"])
def test_sharded_kind_is_one_error_line(cwd, capsys, monkeypatch, kind):
    """Every sharded kind is ported: save works (one rank, no process
    group) and writes the index file of that kind. An unknown kind raises
    the JAX CLI's ValueError."""
    from c99_vectordb_tpu_torch.storage.index_io import read_index

    monkeypatch.setenv("C99VDB_PLATFORM", "cpu")
    monkeypatch.setenv("C99VDB_INDEX", kind)
    rc, out, err = run_torch(capsys, "-f", "db", "save", "in.yaml")
    assert (rc, err) == (0, "")
    assert out.startswith("Memorized: 'I prefer tea over coffee' (ID: 0)\n")
    assert read_index(cwd / "db.memo", device="cpu").kind == kind
    from c99_vectordb_tpu.cli import main as jax_main

    monkeypatch.setenv("C99VDB_INDEX", f"{kind}_bogus")
    for main in (jax_main, torch_cli.main):
        with pytest.raises(ValueError, match=f"unknown C99VDB_INDEX '{kind}_bogus'"):
            main(["memo", "-f", "db2", "save", "in.yaml"])


def test_sharded_file_from_jax_is_one_error_line(cwd, capsys, monkeypatch):
    """A DB the JAX CLI saved with sharded_flat or sharded_ivf, and one
    whose index file is a JAX sharded_ivf_pq index: the port's recall reads
    each and prints the JAX CLI's bytes."""
    from c99_vectordb_tpu.cli import main as jax_main

    monkeypatch.setenv("C99VDB_PLATFORM", "cpu")
    monkeypatch.setenv("C99VDB_INDEX", "sharded_flat")
    assert jax_main(["memo", "-f", "db", "save", "in.yaml"]) == 0
    capsys.readouterr()
    monkeypatch.delenv("C99VDB_INDEX")
    assert jax_main(["memo", "-f", "db", "recall", "tea"]) == 0
    want = capsys.readouterr().out
    rc, out, err = run_torch(capsys, "-f", "db", "recall", "tea")
    assert (rc, out, err) == (0, want, "") and "] Score: " in want
    monkeypatch.setenv("C99VDB_INDEX", "sharded_ivf")
    monkeypatch.setenv("C99VDB_NLIST", "2")
    assert jax_main(["memo", "-f", "ivf", "save", "in.yaml"]) == 0
    capsys.readouterr()
    monkeypatch.delenv("C99VDB_INDEX")
    assert jax_main(["memo", "-f", "ivf", "recall", "tea"]) == 0
    want = capsys.readouterr().out
    rc, out, err = run_torch(capsys, "-f", "ivf", "recall", "tea")
    assert (rc, out, err) == (0, want, "") and "] Score: " in want
    from c99_vectordb_tpu.parallel.sharded import ShardedIVFPQIndex
    from c99_vectordb_tpu.storage.index_io import write_index

    pq = ShardedIVFPQIndex(dim=384, nlist=2, nprobe=2, m=8, ksub=16)
    rows = np.random.default_rng(0).standard_normal((64, 384)).astype(np.float32)
    pq.train(rows)
    pq.add(rows[:1], np.arange(1))
    write_index(pq, cwd / "ivf.memo")
    assert jax_main(["memo", "-f", "ivf", "recall", "tea"]) == 0
    want = capsys.readouterr().out
    rc, out, err = run_torch(capsys, "-f", "ivf", "recall", "tea")
    assert (rc, out, err) == (0, want, "") and "] Score: " in want


@pytest.mark.parametrize("argv", [("analyze", "--filter", "{source: user}"),
                                  ("analyze", "--filter", "{}", "--stats", "priority"),
                                  ("clean",)])
def test_metadata_verbs_need_no_device(cwd, capsys, monkeypatch, argv):
    """analyze and clean run whatever the device rule says (they never
    reach torch), with the JAX CLI's bytes."""
    pair = Pair(cwd, monkeypatch, capsys)
    pair.run("-f", "db", "save", "in.yaml")
    monkeypatch.setenv("C99VDB_PLATFORM", "tpu")
    rc, out, err = run_torch(capsys, "-f", "db", *argv)
    monkeypatch.setenv("C99VDB_PLATFORM", "cpu")
    assert (rc, err) == (0, "")
    if argv[0] == "analyze":
        assert pair.run_jax("-f", "db", *argv) == (rc, out, err)
    else:
        assert out.startswith("Cleared memory database")


# -- no torch import, launchers -----------------------------------------------------


@pytest.mark.parametrize("argv", [["--help"], ["-f", "db", "analyze", "--filter", "{}"],
                                  ["-f", "db", "clean"], ["-f", "db", "recall"]])
def test_verbs_without_torch(tmp_path, argv):
    """--help, analyze, clean and argument errors import no torch."""
    code = ("import sys; from c99_vectordb_tpu_torch.cli import main; "
            f"rc = main(['memo', *{argv!r}]); "
            "print('TORCH' if 'torch' in sys.modules else 'NO-TORCH', rc)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.splitlines()[-1] in ("NO-TORCH 0", "NO-TORCH 1"), out


@pytest.mark.parametrize("launcher", ["module", "memo-torch"])
def test_help_is_byte_identical(tmp_path, launcher):
    from c99_vectordb_tpu.cli import HELP_TEXT

    cmd = ([sys.executable, "-m", "c99_vectordb_tpu_torch", "--help"] if launcher == "module"
           else [str(REPO / "memo-torch"), "--help"])
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    assert (out.returncode, out.stdout, out.stderr) == (0, HELP_TEXT + "\n", "")
    assert torch_cli.HELP_TEXT == HELP_TEXT


# -- reporting and timing helpers against the JAX package's --------------------------

MATCHES = [
    (0, {"source": "user", "priority": 2, "t": "2024-01-02T10:00:00Z", "tags": ["a"]}),
    (1, {"source": "agent", "priority": 5, "t": "2024-03-04", "nested": {"x": 1}}),
    (2, {"source": "user", "priority": "7", "t": "2024-02-01T00:00:00+02:00"}),
    (5, {"source": "sys", "priority": 1.5, "z": None}),
    (9, {"source": "e", "other": "x"}),
    (11, {"source": "f", "t": "not a date"}),
]
STATS_CASES = [
    ("source", MATCHES), ("priority", MATCHES), ("t", MATCHES[:3]), ("t", MATCHES),
    ("tags", MATCHES), ("missing", MATCHES), ("priority", []),
    ("t", [(0, {"t": "2024-01-02T10:00:00"}), (1, {"t": "2024-01-01T10:00:00+05:00"})]),
]


@pytest.mark.parametrize("key,found", STATS_CASES)
def test_render_stats_matches_jax(key, found):
    assert trep.render_stats(found, key) == jrep.render_stats(found, key)


def test_table_fields_and_cells_match_jax():
    for fields in (None, ["id", "metadata"], ["id", "metadata.priority", "tags", "nested"]):
        sel = fields or jrep.default_fields(MATCHES)
        assert (fields or trep.default_fields(MATCHES)) == sel
        rows_j = [[jrep.format_cell(jrep.resolve_field(i, m, f)) for f in sel] for i, m in MATCHES]
        rows_t = [[trep.format_cell(trep.resolve_field(i, m, f)) for f in sel] for i, m in MATCHES]
        assert rows_t == rows_j
        assert trep.render_table(sel, rows_t) == jrep.render_table(sel, rows_j)
    assert trep.render_table([], []) == jrep.render_table([], []) == []


@pytest.mark.parametrize("text", ["2024-01-02T10:00:00Z", " 2024-01-02 ", "2024-13-01", "",
                                  None, 5, "2024-01-02T10:00:00+05:30"])
def test_parse_iso_datetime_matches_jax(text):
    got, want = trep.parse_iso_datetime(text), jrep.parse_iso_datetime(text)
    assert got == want and (got is None or isinstance(got, datetime))


@pytest.mark.parametrize("verbose", [False, True])
def test_stage_lines_match_jax(capsys, monkeypatch, verbose):
    monkeypatch.delenv("C99VDB_TRACE", raising=False)
    lines = []
    for mod in (jtiming, ttiming):
        with mod.stage(verbose, "embed+search"):
            pass
        err = capsys.readouterr().err
        lines.append(err.split(": ")[0] if err else err)
    assert lines[0] == lines[1] == ("[timing] embed+search" if verbose else "")


def test_stage_trace_is_a_chrome_trace(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("C99VDB_TRACE", str(tmp_path))
    with ttiming.stage(True, "load index"):
        torch.ones(8).sum()
    assert capsys.readouterr().err.startswith("[timing] load index: ")
    trace = json.loads((tmp_path / "load_index" / "trace.json").read_text())
    assert trace["traceEvents"]


# -- the ranking distance's summation order -----------------------------------------


@pytest.mark.parametrize("d", [8, 32, 64, 384, 768, 2048])
def test_ranking_bits_match_jax(d):
    """ranked_program / ranked_many_program give the JAX package's bits on
    Gaussian rows (where a different summation order shows at once), with
    padding rows and a budget that cuts the batch into chunks."""
    rng = np.random.default_rng(d)
    n, b = 700, 5
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    valid = np.ones(n, bool)
    valid[-9:] = False
    jd, ji = jdist.ranked_many_program(n, d, b)(jnp.asarray(x), jnp.asarray(ids),
                                                 jnp.asarray(valid), jnp.asarray(q))
    tx, tids, tvalid, tq = map(torch.from_numpy, (x, ids, valid, q))
    old = tdist.RANKED_MANY_BUDGET_BYTES
    try:
        tdist.RANKED_MANY_BUDGET_BYTES = 2 * n * tdist.RANKED_BYTES_PER_ROW
        td, ti = tdist.ranked_many_program(tx, tids, tvalid, tq, in_id_order=True)
    finally:
        tdist.RANKED_MANY_BUDGET_BYTES = old
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for r in range(b):
        d1, i1 = tdist.ranked_program(tx, tids, tvalid, tq[r], in_id_order=True)
        np.testing.assert_array_equal(d1.numpy(), np.asarray(jd)[r])
        np.testing.assert_array_equal(i1.numpy(), np.asarray(ji)[r])
    np.testing.assert_array_equal(tdist.pairwise_sq_l2(tq, tx).numpy(),
                                  np.asarray(jax.jit(jdist.pairwise_sq_l2)(q, x)))


def test_ranked_many_chunk():
    cap = 1 << 20
    assert tdist.ranked_many_chunk(cap) == (1 << 30) // (cap * 20) == 51
    assert tdist.ranked_many_chunk(1 << 40) == 1
