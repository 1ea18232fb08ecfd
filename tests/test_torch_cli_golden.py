"""PyTorch port's memo CLI against the JAX package's, scenario by scenario.

Every scenario of tests/test_cli_golden.py runs here as one parametrised
case: the same argv, input files and stdin go through
`c99_vectordb_tpu.cli.main` and `c99_vectordb_tpu_torch.cli.main`
(C99VDB_PLATFORM=cpu) in the same working directory. Before each
invocation the directory is snapshotted; the JAX CLI runs, its results
and files are kept, the snapshot is restored, and the port's CLI runs.
Both must give the same (rc, stdout, stderr), with `[timing] ... ms`
numbers replaced by a placeholder, and leave the same YAML bytes and the
same TPUVDB01 index bytes. The scenario then goes on from the port's
files, so the JAX CLI also reads what the port wrote.

The two golden tests that reach into the JAX package's internals
(test_cross_process_determinism, test_serve_reloads_on_external_write)
have port-side counterparts at the end of this file."""

from __future__ import annotations

import io
import os
import re
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from c99_vectordb_tpu import cli as jax_cli
from c99_vectordb_tpu_torch import cli as torch_cli

TIMING = re.compile(r"(\[timing\] [^:\n]+: )[0-9.]+( ms)")


def normalize(text: str) -> str:
    return TIMING.sub(r"\1<ms>\2", text)


def snapshot(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def restore(root: Path, files: dict[str, bytes]) -> None:
    for p in list(root.iterdir()):
        shutil.rmtree(p) if p.is_dir() else p.unlink()
    for rel, data in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(data)


def compared_files(files: dict[str, bytes]) -> dict[str, bytes]:
    """The record stores and index files (the snapshot sidecar is a cache)."""
    return {k: v for k, v in files.items() if k.endswith((".yaml", ".memo"))}


class Pair:
    """Runs one argv through both CLIs from the same directory state."""

    def __init__(self, root: Path, monkeypatch, capsys):
        self.root, self.monkeypatch, self.capsys = root, monkeypatch, capsys
        monkeypatch.chdir(root)
        monkeypatch.setenv("C99VDB_PLATFORM", "cpu")

    def _invoke(self, main, argv, stdin):
        if stdin is not None:
            self.monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
        rc = main(["memo", *argv])
        out = self.capsys.readouterr()
        return rc, normalize(out.out), normalize(out.err)

    def run_jax(self, *argv, stdin=None):
        return self._invoke(jax_cli.main, argv, stdin)

    def run_torch(self, *argv, stdin=None):
        return self._invoke(torch_cli.main, argv, stdin)

    def run(self, *argv, stdin=None):
        """Both CLIs; asserts equal results and files; returns the result."""
        before = snapshot(self.root)
        want = self.run_jax(*argv, stdin=stdin)
        want_files = compared_files(snapshot(self.root))
        restore(self.root, before)
        got = self.run_torch(*argv, stdin=stdin)
        assert got == want, (argv, want, got)
        got_files = compared_files(snapshot(self.root))
        assert sorted(got_files) == sorted(want_files), argv
        for name in want_files:
            assert got_files[name] == want_files[name], (argv, name)
        return got


@pytest.fixture
def pair(tmp_path, monkeypatch, capsys):
    return Pair(tmp_path, monkeypatch, capsys)


SAVE_INPUT = """\
---
metadata:
  source: user
  priority: 2
body: I prefer tea over coffee
---
metadata:
  source: agent
  priority: 5
  tags: [health]
body: |
  User mentioned a preference for
  morning workouts
---
metadata: {source: user, priority: 1}
body: Remember to file taxes in April
"""
UPDATE = "---\nid: 0\nmetadata: {source: user}\nbody: I now prefer coffee\n"
DELETE_1 = "---\nid: 1\nmetadata: {deleted: true}\nbody: tombstone\n"
DATES = ("---\nmetadata: {t: '2024-01-02T10:00:00Z'}\nbody: a\n"
         "---\nmetadata: {t: '2024-03-04T10:00:00Z'}\nbody: b\n")
MIXED_META = "---\nbody: no meta note\n---\nmetadata: {s: 1}\nbody: with meta note\n"
MIXED_SAVE = ("---\nid: 0\nmetadata: {source: user}\nbody: replaced zero\n"
              "---\nmetadata: {source: new}\nbody: appended note\n")
PARAGRAPHS = "---\nbody: |\n  first paragraph\n\n  second paragraph\n"
UNICODE = ("---\nmetadata: {lang: mixed}\nbody: \"caf\\u00e9 na\\u00efve \\u4e2d\\u6587 "
           "\\U0001F600 note\"\n---\nbody: |\n  indented\n    deeper line\n  back\n")
SERVE_QUERIES = "tea preference\nmorning workout\ntaxes april\n"


# A scenario is a list of steps: ("write", name, text), ("bytes", name,
# data), ("unlink", name), or ("run", argv, stdin). "{tmp}" in an argv item
# is the working directory (the golden tests pass absolute input paths).
def W(name, text):
    return ("write", name, text)


def R(*argv, stdin=None):
    return ("run", argv, stdin)


def SAVE(name="in.yaml", text=SAVE_INPUT, base="db"):
    return [W(name, text), R("-f", base, "save", "{tmp}/" + name)]


SCENARIOS = {
    # TestHelp
    "no_args_shows_help": [R()],
    "help_flag": [R("--help")],
    "missing_f": [R("recall", "hello")],
    "unknown_command": [R("-f", "db", "frobnicate")],
    # TestSaveRecall
    "save_prints_memorized_lines": SAVE(),
    "recall_text_format": SAVE() + [R("-f", "db", "recall", "-k", "1",
                                      "tea or coffee preference")],
    "recall_multiline_body_indent": SAVE() + [R("-f", "db", "recall", "-k", "1",
                                                "morning workouts preference")],
    "recall_empty_db": [R("-f", "db", "recall", "anything")],
    "recall_yaml_mode": SAVE() + [R("-f", "db", "recall", "--yaml", "-k", "2", "tea coffee")],
    "recall_yaml_empty_db": [R("-f", "db", "recall", "--yaml", "q")],
    "recall_filter_post_filters": SAVE() + [R("-f", "db", "recall", "-k", "5", "--filter",
                                              "{source: agent}", "preference")],
    "recall_unknown_flags_join_query": SAVE() + [R("-f", "db", "recall", "--bogus", "tea")],
    "recall_empty_query_error": [R("-f", "db", "recall")],
    "recall_k_clamped": SAVE() + [R("-f", "db", "recall", "-k", "1000", "tea"),
                                  R("-f", "db", "recall", "-k", "-3", "tea")],
    "recall_scores_are_squared_l2": SAVE() + [R("-f", "db", "recall", "-k", "1",
                                                "I prefer tea over coffee")],
    # TestMoreParity
    "global_flags_position_independent": [W("in.yaml", SAVE_INPUT),
                                          R("save", "{tmp}/in.yaml", "-f", "db")],
    "recall_yaml_with_filter": SAVE() + [R("-f", "db", "recall", "--yaml", "-k", "5",
                                           "--filter", "{priority: {$gte: 3}}", "preference")],
    "stats_date_range_via_cli": SAVE("d.yaml", DATES, "db3") + [
        R("-f", "db3", "analyze", "--filter", "{}", "--stats", "t")],
    "invalid_filter_after_header": SAVE() + [R("-f", "db", "recall", "--filter", "{bad: [",
                                               "q")],
    "k_requires_integer": [R("-f", "db", "recall", "-k", "abc", "q")],
    "empty_filter_string_hides_metadataless": SAVE("m.yaml", MIXED_META, "db4") + [
        R("-f", "db4", "recall", "-k", "5", "--filter", "{}", "note")],
    # TestOverwrite
    "overwrite_by_id": SAVE() + SAVE("up.yaml", UPDATE) + [
        R("-f", "db", "recall", "-k", "1", "I now prefer coffee")],
    "overwrite_missing_id_errors": SAVE() + SAVE("bad.yaml", "---\nid: 99\nbody: nope\n"),
    # TestAnalyze
    "analyze_matched_count_and_table": SAVE() + [R("-f", "db", "analyze", "--filter",
                                                   "{source: user}")],
    "analyze_fields_projection": SAVE() + [R("-f", "db", "analyze", "--filter", "{}",
                                             "--fields", "id,metadata.priority")],
    "analyze_stats_mode": SAVE() + [R("-f", "db", "analyze", "--filter", "{}", "--stats",
                                      "priority")],
    "analyze_limit_offset_paging": SAVE() + [R("-f", "db", "analyze", "--filter", "{}",
                                               "--limit", "1", "--offset", "1")],
    "analyze_filter_required": [R("-f", "db", "analyze")],
    "analyze_unknown_option_rejected": [R("-f", "db", "analyze", "--filter", "{}", "--what",
                                          "x")],
    "analyze_validation_messages": SAVE() + [
        R("-f", "db", "analyze", "--filter", "{}", "--limit", "0"),
        R("-f", "db", "analyze", "--filter", "{}", "--offset", "-1")],
    "analyze_no_metadata_records_never_match": SAVE("nm.yaml",
                                                    "---\nbody: bare note without metadata\n",
                                                    "db2") + [
        R("-f", "db2", "analyze", "--filter", "{}")],
    # TestCleanReindex
    "clean_messages": [R("-f", "db", "clean")] + SAVE() + [R("-f", "db", "clean")],
    "reindex_output_and_compaction": SAVE() + SAVE("del.yaml", DELETE_1) + [
        R("-f", "db", "reindex"),
        R("-f", "db", "analyze", "--filter", "{}", "--fields", "id")],
    "reindex_recovers_corrupt_index": SAVE() + [
        ("bytes", "db.memo", b"corrupted!"), R("-f", "db", "reindex"),
        R("-f", "db", "recall", "-k", "1", "tea coffee")],
    "clean_extra_args_rejected": [R("-f", "db", "clean", "extra"),
                                  R("-f", "db", "reindex", "extra")],
    # TestEdgePaths
    "mixed_save_overwrite_and_append": SAVE() + SAVE("mix.yaml", MIXED_SAVE) + [
        R("-f", "db", "recall", "-k", "1", "appended note")],
    "recall_with_missing_index_file": SAVE() + [
        ("unlink", "db.memo"), R("-f", "db", "recall", "tea"), R("-f", "db", "reindex"),
        R("-f", "db", "recall", "-k", "1", "tea coffee")],
    "analyze_whole_metadata_column": SAVE() + [R("-f", "db", "analyze", "--filter",
                                                 "{source: agent}", "--fields", "id,metadata")],
    "save_into_subdirectory_base": SAVE(base="deep/dir/db"),
    # TestVerbose
    "verbose_goes_to_stderr_only": SAVE() + [R("-f", "db", "-v", "reindex")],
    # TestFaissMigration
    "reference_shaped_memo_hints_reindex": SAVE() + [
        ("bytes", "db.memo", b"IxM2" + b"\x00" * 32), R("-f", "db", "recall", "-k", "1", "tea"),
        R("-f", "db", "reindex"), R("-f", "db", "recall", "-k", "1", "tea coffee")],
    # TestServe
    "serve_blocks_match_one_shot_recalls": SAVE() + [
        R("-f", "db", "recall", "-k", "2", "tea preference"),
        R("-f", "db", "recall", "-k", "2", "morning workout"),
        R("-f", "db", "serve", "-k", "2", stdin="tea preference\n\nmorning workout\n")],
    "serve_yaml_and_filter": SAVE() + [
        R("-f", "db", "recall", "--yaml", "-k", "1", "--filter", "{source: user}", "tea"),
        R("-f", "db", "serve", "--yaml", "-k", "1", "--filter", "{source: user}",
          stdin="tea\n")],
    "serve_yaml_blocks_frame_despite_blank_lines": SAVE(text=PARAGRAPHS) + [
        R("-f", "db", "serve", "--yaml", "-k", "1", stdin="first\nsecond\n")],
    "serve_rejects_positional_and_bad_filter": [
        R("-f", "db", "serve", "stray"),
        R("-f", "db", "serve", "--filter", "{bad yaml", stdin="")],
    "serve_not_in_help": [R("--help")],
    "serve_batch_matches_single_mode": SAVE() + [
        R("-f", "db", "serve", "-k", "2", stdin=SERVE_QUERIES),
        R("-f", "db", "serve", "-k", "2", "--batch", "2", stdin=SERVE_QUERIES),
        R("-f", "db", "serve", "-k", "2", "--batch", "4", stdin=SERVE_QUERIES)],
    "serve_batch_blank_line_flushes": SAVE() + [
        R("-f", "db", "serve", "-k", "1", "--batch", "64", stdin="tea\n\nworkout\n")],
    "serve_batch_with_filter_matches_single": SAVE() + [
        R("-f", "db", "serve", "--yaml", "-k", "1", "--filter", "{source: user}",
          stdin="tea\nworkout\n"),
        R("-f", "db", "serve", "--yaml", "-k", "1", "--filter", "{source: user}", "--batch",
          "2", stdin="tea\nworkout\n")],
    "serve_batch_rejects_bad_values": [
        R("-f", "db", "serve", "--batch"), R("-f", "db", "serve", "--batch", "zero"),
        R("-f", "db", "serve", "--batch", "0")],
    # Beyond the golden file: the -v timing and unreadable-index lines,
    # bodies that stress the YAML emitters, soft deletes.
    "verbose_recall_and_serve_timing": SAVE() + [
        R("-f", "db", "-v", "recall", "-k", "1", "tea"),
        R("-v", "-f", "db", "serve", "-k", "1", "--batch", "2", stdin=SERVE_QUERIES)],
    "verbose_save_over_unreadable_index": SAVE() + [
        ("bytes", "db.memo", b"TPUVDB01garbage"),
        W("more.yaml", "---\nbody: one more note about tea\n"),
        R("-f", "db", "-v", "save", "{tmp}/more.yaml"),
        R("-f", "db", "recall", "-k", "3", "tea")],
    "unicode_and_indented_bodies": SAVE(text=UNICODE) + [
        R("-f", "db", "recall", "--yaml", "-k", "2", "note deeper"),
        R("-f", "db", "recall", "-k", "2", "café"),
        R("-f", "db", "analyze", "--filter", "{lang: mixed}", "--fields", "id,lang")],
    "soft_deleted_record_not_recalled": SAVE() + SAVE("del.yaml", DELETE_1) + [
        R("-f", "db", "recall", "-k", "3", "morning workouts"),
        R("-f", "db", "serve", "--yaml", "-k", "3", "--batch", "3", stdin=SERVE_QUERIES)],
}


def play(pair: Pair, steps) -> list:
    results = []
    tmp = str(pair.root)
    for step in steps:
        kind = step[0]
        if kind == "write":
            (pair.root / step[1]).write_text(step[2])
        elif kind == "bytes":
            (pair.root / step[1]).write_bytes(step[2])
        elif kind == "unlink":
            (pair.root / step[1]).unlink()
        else:
            argv = [a.replace("{tmp}", tmp) for a in step[1]]
            results.append(pair.run(*argv, stdin=step[2]))
    return results


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(pair, name):
    results = play(pair, SCENARIOS[name])
    assert results and all(isinstance(rc, int) for rc, _, _ in results)


# -- port-side counterparts of the two tests that reach into internals ---------


def test_cross_process_determinism(pair):
    """Vectors saved by one process match a query embedded afresh: the
    stored row and a new embedding of the same text are identical, and the
    JAX package's reader finds the same row at distance 0."""
    play(pair, SAVE())
    from c99_vectordb_tpu.storage.index_io import read_index as jax_read
    from c99_vectordb_tpu_torch.ops.embed import embed_text
    from c99_vectordb_tpu_torch.storage.index_io import read_index

    index = read_index(pair.root / "db.memo", device="cpu")
    q = embed_text("I prefer tea over coffee", device="cpu")
    dists, ids = index.search(q[None], k=1)
    assert ids[0, 0] == 0
    assert dists[0, 0] < 1e-6
    np.testing.assert_array_equal(index.reconstruct(0), q)
    jd, ji = jax_read(pair.root / "db.memo").search(q[None], k=1)
    assert ji[0, 0] == 0 and jd[0, 0] < 1e-6


def test_serve_reloads_on_external_write(pair, monkeypatch):
    """A serving process answers from the CURRENT DB after another writer
    republished it (the stat-keyed reload): the same stream through both
    CLIs, each mutated by its own package's save."""
    from c99_vectordb_tpu import commands as jax_commands
    from c99_vectordb_tpu_torch import commands as torch_commands

    play(pair, SAVE())
    root = pair.root
    (root / "extra.yaml").write_text("---\nbody: zebra safari trip\n")

    class FeedAndMutate(io.StringIO):
        """Stdin that appends a new record between the two queries."""

        def __init__(self, commands):
            super().__init__()
            self.commands = commands

        def __iter__(self):
            for item in ["workout\n", "MUTATE", "zebra safari\n"]:
                if item == "MUTATE":
                    assert self.commands.cmd_save("db", str(root / "extra.yaml"),
                                                  str(root), False) == 0
                    future = time.time() + 2
                    for n in ("db.yaml", "db.memo"):
                        os.utime(root / n, (future, future))
                    continue
                yield item

    before = snapshot(root)
    monkeypatch.setattr("sys.stdin", FeedAndMutate(jax_commands))
    want = pair.run_jax("-f", "db", "serve", "-k", "1")
    restore(root, before)
    monkeypatch.setattr("sys.stdin", FeedAndMutate(torch_commands))
    got = pair.run_torch("-f", "db", "serve", "-k", "1")
    assert got == want
    assert got[0] == 0 and "zebra safari trip" in got[1]
