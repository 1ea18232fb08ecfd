"""memo-compatible command-line interface of the PyTorch/CUDA port.

Public surface (the same as the JAX package's cli.py):

    memo --help
    memo -f <base> [-v] save <yaml_file>
    memo -f <base> [-v] recall [-k <N>] [--filter <expr>] [--yaml] <query>
    memo -f <base> [-v] analyze --filter <expr> [--fields <list>]
                               [--stats <key>] [--limit <N>] [--offset <N>]
    memo -f <base> [-v] clean
    memo -f <base> [-v] reindex

plus the `serve` extension verb (absent from --help). Parsing is
hand-rolled (no argparse) to keep the reference CLI's exact behaviors:
unknown recall flags join the query string, -k is clamped to [1, MAX_K],
and every error is a single `Error: ...` line on stderr with exit code 1.
The compute verbs run on the device rule's device (commands.py); --help,
analyze, clean and argument errors never import torch.
"""

from __future__ import annotations

import os
import sys
from typing import Any

from .constants import DEFAULT_ANALYZE_LIMIT, DEFAULT_ANALYZE_OFFSET, DEFAULT_K, MAX_K

HELP_TEXT = """\
Usage:
  memo --help
  memo -f <base> [-v] save <yaml_file>
  memo -f <base> [-v] recall [-k <N>] [--filter <expr>] [--yaml] <query>
  memo -f <base> [-v] analyze --filter <expr> [--fields <list>] [--stats <key>] [--limit <N>] [--offset <N>]
  memo -f <base> [-v] clean
  memo -f <base> [-v] reindex

Commands:
  save                Insert/update memory records from YAML input file
  recall              Semantic recall from <base>.memo + <base>.yaml
  analyze             Metadata-only reporting from <base>.yaml
  clean               Remove <base>.memo and <base>.yaml
  reindex             Rebuild <base>.memo from <base>.yaml (full regenerate)

Options:
  -f <base>           REQUIRED DB basename
  -v                 Verbose logs to stderr
  <yaml_file>        YAML file for save input (single or multi-doc using ---)
                     Each doc requires: metadata: <map>, body: <string>
                     Optional per-doc id: <int> to overwrite existing record
  --filter <expr>    Filter recall results by metadata
  --yaml             recall only: emit YAML results with id, score, body
  --fields <list>    analyze only: comma-separated columns (e.g. id,source,metadata)
  --stats <key>      analyze only: cardinality + numeric/date-like range for key
  --limit <N>        analyze only: max rows to print (default: 100)
  --offset <N>       analyze only: rows to skip before printing (default: 0)
  --help             Show this help"""


def print_help() -> None:
    print(HELP_TEXT)


def _err(msg: str) -> None:
    print(f"Error: {msg}", file=sys.stderr)


def split_global_args(argv: list[str]) -> tuple[dict[str, Any] | None, int]:
    """Extract -v / -f from anywhere in argv; the rest stay positional."""
    db_base: str | None = None
    verbose = False
    positional: list[str] = []

    i = 1
    while i < len(argv):
        arg = argv[i]
        if arg == "-v":
            verbose = True
            i += 1
        elif arg == "-f":
            if i + 1 >= len(argv):
                _err("-f requires a value")
                return None, 1
            db_base = argv[i + 1]
            if db_base.strip() == "":
                _err("-f requires a non-empty value")
                return None, 1
            i += 2
        else:
            positional.append(arg)
            i += 1

    return {"db_base": db_base, "verbose": verbose, "positional": positional}, 0


def _parse_recall_flags(
    args: list[str], unknown_joins_query: bool
) -> tuple[dict[str, Any] | None, int]:
    """Shared -k/--filter/--yaml loop for recall and serve. recall joins
    unknown tokens into the query (reference behavior); serve — an
    extension verb with no positional query — rejects them."""
    k = DEFAULT_K
    filter_expr: str | None = None
    as_yaml = False
    query_parts: list[str] = []

    i = 0
    while i < len(args):
        arg = args[i]
        if arg == "-k":
            if i + 1 >= len(args):
                _err("-k requires an integer")
                return None, 1
            try:
                k = int(args[i + 1])
            except ValueError:
                _err("-k requires an integer")
                return None, 1
            i += 2
        elif arg == "--filter":
            if i + 1 >= len(args):
                _err("--filter requires a filter expression")
                return None, 1
            filter_expr = args[i + 1]
            i += 2
        elif arg == "--yaml":
            as_yaml = True
            i += 1
        elif unknown_joins_query:
            # Unknown tokens (including unknown flags) join the query.
            query_parts.append(arg)
            i += 1
        else:
            _err(f"unknown serve option '{arg}'")
            return None, 1

    k = max(1, min(k, MAX_K))
    return {
        "k": k,
        "filter_expr": filter_expr,
        "as_yaml": as_yaml,
        "query": " ".join(query_parts).strip(),
    }, 0


def parse_recall_args(args: list[str]) -> tuple[dict[str, Any] | None, int]:
    parsed, rc = _parse_recall_flags(args, unknown_joins_query=True)
    if rc != 0:
        return None, rc
    assert parsed is not None
    if not parsed["query"]:
        _err("recall requires <query>")
        return None, 1
    return parsed, 0


def parse_serve_args(args: list[str]) -> tuple[dict[str, Any] | None, int]:
    """serve takes recall's flags (-k / --filter / --yaml) but NO query —
    queries arrive one per stdin line (unknown tokens are errors). Its
    one extra flag, --batch N, answers stdin queries in device batches of
    up to N (a blank line or EOF flushes a partial batch early)."""
    batch = 1
    rest: list[str] = []
    i = 0
    while i < len(args):
        if args[i] == "--batch":
            if i + 1 >= len(args):
                _err("--batch requires an integer")
                return None, 1
            try:
                batch = int(args[i + 1])
            except ValueError:
                _err("--batch requires an integer")
                return None, 1
            if batch < 1:
                _err("--batch must be >= 1")
                return None, 1
            i += 2
        else:
            rest.append(args[i])
            i += 1
    parsed, rc = _parse_recall_flags(rest, unknown_joins_query=False)
    if rc != 0:
        return None, rc
    assert parsed is not None
    # 1024 = the largest measured serving batch (BASELINE.md round 5);
    # beyond it the (B, cap) ranking's memory grows with no dispatch win.
    parsed["batch"] = min(batch, 1024)
    return parsed, 0


def parse_analyze_args(args: list[str]) -> tuple[dict[str, Any] | None, int]:
    filter_expr: str | None = None
    fields: list[str] | None = None
    stats_key: str | None = None
    limit = DEFAULT_ANALYZE_LIMIT
    offset = DEFAULT_ANALYZE_OFFSET

    def take_value(i: int, missing_msg: str) -> str | None:
        if i + 1 >= len(args):
            _err(missing_msg)
            return None
        return args[i + 1]

    i = 0
    while i < len(args):
        arg = args[i]
        if arg == "--filter":
            value = take_value(i, "--filter requires a filter expression")
            if value is None:
                return None, 1
            filter_expr = value
            i += 2
        elif arg == "--fields":
            value = take_value(i, "--fields requires a comma-separated field list")
            if value is None:
                return None, 1
            parsed = [f.strip() for f in value.split(",") if f.strip()]
            if not parsed:
                _err("--fields requires at least one field")
                return None, 1
            fields = parsed
            i += 2
        elif arg == "--stats":
            value = take_value(i, "--stats requires a key")
            if value is None:
                return None, 1
            stats_key = value.strip()
            if not stats_key:
                _err("--stats requires a non-empty key")
                return None, 1
            i += 2
        elif arg == "--limit":
            value = take_value(i, "--limit requires an integer")
            if value is None:
                return None, 1
            try:
                limit = int(value)
            except ValueError:
                _err("--limit requires an integer")
                return None, 1
            i += 2
        elif arg == "--offset":
            value = take_value(i, "--offset requires an integer")
            if value is None:
                return None, 1
            try:
                offset = int(value)
            except ValueError:
                _err("--offset requires an integer")
                return None, 1
            i += 2
        else:
            _err(f"unknown analyze option '{arg}'")
            return None, 1

    if filter_expr is None:
        _err("analyze requires --filter <expr>")
        return None, 1

    return {
        "filter_expr": filter_expr,
        "fields": fields,
        "stats_key": stats_key,
        "limit": limit,
        "offset": offset,
    }, 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv) if argv is None else argv
    parsed, rc = split_global_args(argv)
    if rc != 0:
        return rc
    assert parsed is not None

    positional = parsed["positional"]
    if not positional or positional[0] in {"--help", "help"}:
        print_help()
        return 0

    command = positional[0]
    db_base = parsed["db_base"]
    if db_base is None:
        _err("-f <base> is required")
        print_help()
        return 1
    verbose = parsed["verbose"]
    user_cwd = os.getcwd()

    from . import commands  # deferred: keeps --help fast

    if command == "clean":
        if len(positional) != 1:
            _err("clean does not accept extra arguments")
            return 1
        return commands.cmd_clean(db_base, user_cwd)

    if command == "reindex":
        if len(positional) != 1:
            _err("reindex does not accept extra arguments")
            return 1
        return commands.cmd_reindex(db_base, user_cwd, verbose)

    if command == "save":
        if len(positional) != 2:
            _err("save requires exactly one <yaml_file>")
            return 1
        return commands.cmd_save(db_base, positional[1], user_cwd, verbose)

    if command == "recall":
        args, rc = parse_recall_args(positional[1:])
        if rc != 0:
            return rc
        assert args is not None
        return commands.cmd_recall(
            db_base,
            args["query"],
            args["k"],
            args["filter_expr"],
            args["as_yaml"],
            user_cwd,
            verbose=verbose,
        )

    if command == "serve":
        args, rc = parse_serve_args(positional[1:])
        if rc != 0:
            return rc
        assert args is not None
        return commands.cmd_serve(
            db_base,
            args["k"],
            args["filter_expr"],
            args["as_yaml"],
            user_cwd,
            verbose=verbose,
            batch=args["batch"],
        )

    if command == "analyze":
        args, rc = parse_analyze_args(positional[1:])
        if rc != 0:
            return rc
        assert args is not None
        return commands.cmd_analyze(
            db_base,
            args["filter_expr"],
            args["fields"],
            args["stats_key"],
            args["limit"],
            args["offset"],
            user_cwd,
        )

    _err(f"unknown command '{command}'")
    print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
