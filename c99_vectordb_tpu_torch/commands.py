"""The five verbs (save / recall / analyze / clean / reindex), the `serve`
extension verb, and the index construction they share with the API (the
engine choice and the full rebuild from the record store). Counterpart of
the JAX package's commands.py.

Each verb is a stateless load -> mutate -> write over the two-file DB
(<base>.yaml source of truth, <base>.memo derived index) and prints the
same bytes as the JAX package's CLI: results on stdout, `Error: ...`
diagnostics and -v logs on stderr, exit codes 0/1.

Device: the compute verbs (save, reindex, recall, serve) run where
utils/runtime.resolve_device says: C99VDB_PLATFORM=cpu|cuda, else cuda.
Unlike the JAX CLI, no corpus size moves the work to the CPU
(C99VDB_CPU_THRESHOLD is not read). A device that cannot be had, like an
index kind that is not ported yet, is one `Error:` line and exit code 1.
analyze, clean and argument errors never import torch: the compute stack
is imported inside the compute verbs.
"""

from __future__ import annotations

import functools
import os
import sys
from typing import Any

import numpy as np
import yaml

from .constants import DIM, SCORE_SKIP_THRESHOLD
from .storage.paths import db_paths, ensure_parent
from .storage.yaml_store import RecordStore, block_str
from .utils.filters import matches, parse_filter
from .utils.reporting import default_fields, format_cell, render_stats, render_table, resolve_field
from .utils.text import is_blank_body


def vlog(enabled: bool, msg: str) -> None:
    if enabled:
        print(msg, file=sys.stderr)


def _fail(msg: str) -> int:
    print(f"Error: {msg}", file=sys.stderr)
    return 1


def _load_store(yaml_path) -> RecordStore:
    return RecordStore.load(yaml_path)


def _compute_verb(verb):
    """Run a compute verb with `device=` the device rule's device. The
    rule's refusal (no card, an unknown device name) ends the verb with
    one `Error:` line."""

    @functools.wraps(verb)
    def run(*args, **kwargs):
        from .utils.runtime import resolve_device

        try:
            device = resolve_device()
        except (RuntimeError, ValueError) as e:
            return _fail(str(e))
        return verb(*args, device=device, **kwargs)

    return run


def auto_nlist(corpus_size: int) -> int:
    """IVF cell count for a corpus when C99VDB_NLIST is unset: 4 * sqrt(N)
    rounded up to a 128 multiple (the FAISS 4-16 * sqrt(N) sizing rule;
    4096 at 1M), clamped to [64, 8192]; 64 at memo scale (<= 4096)."""
    if corpus_size <= 4096:
        return 64
    raw = 4.0 * float(corpus_size) ** 0.5
    aligned = -(-int(raw) // 128) * 128
    return min(8192, aligned)


def make_index(corpus_size: int | None = None, device=None):
    """Build an empty index of the configured family on `device`.

    C99VDB_INDEX = flat (default) | ivf_flat | ivf_pq | sharded_flat | sharded_ivf |
    sharded_ivf_pq.
    C99VDB_SCAN_DTYPE =
    float32 | bfloat16 | int8 selects the scan store of flat and ivf_flat.
    For the IVF families: C99VDB_NLIST (else auto_nlist(corpus_size) when
    the caller knows the corpus size, else 64), C99VDB_NPROBE (8),
    C99VDB_PAD_CAP; for ivf_flat C99VDB_RERANK_DTYPE = float32 | bfloat16;
    for ivf_pq C99VDB_PQ_M (8), C99VDB_PQ_KSUB (256, or 16 for nibble-packed
    4-bit codes) and C99VDB_OPQ (on unless empty, 0 or false).
    sharded_flat (float32 or int8 scan store), sharded_ivf (C99VDB_NLIST,
    C99VDB_NPROBE, C99VDB_SCAN_DTYPE = float32 | int8, C99VDB_RERANK_DTYPE =
    float32 | bfloat16 with int8) and sharded_ivf_pq (C99VDB_NLIST,
    C99VDB_NPROBE, C99VDB_PQ_M, C99VDB_PQ_KSUB, C99VDB_OPQ) shard over the
    world's ranks (parallel/mesh.default_data_mesh: one rank without a
    process group)."""
    kind = os.environ.get("C99VDB_INDEX", "flat").strip().lower()
    scan_dtype = os.environ.get("C99VDB_SCAN_DTYPE", "float32").strip() or "float32"
    if kind == "flat":
        from .models.flat import FlatIndex

        return FlatIndex(dim=DIM, scan_dtype=scan_dtype, device=device)
    if kind == "sharded_flat":
        from .parallel.sharded import ShardedFlatIndex

        return ShardedFlatIndex(dim=DIM, scan_dtype=scan_dtype, device=device)
    nlist_env = os.environ.get("C99VDB_NLIST", "").strip()
    if nlist_env:
        nlist = int(nlist_env)
    elif corpus_size is not None:
        nlist = auto_nlist(corpus_size)
    else:
        nlist = 64
    nprobe = int(os.environ.get("C99VDB_NPROBE", "8"))
    pad_cap_env = os.environ.get("C99VDB_PAD_CAP", "").strip()
    pad_cap = int(pad_cap_env) if pad_cap_env else None
    if kind == "ivf_flat":
        from .models.ivf_flat import IVFFlatIndex

        rerank_dtype = os.environ.get("C99VDB_RERANK_DTYPE", "float32").strip() or "float32"
        return IVFFlatIndex(dim=DIM, nlist=nlist, nprobe=nprobe, scan_dtype=scan_dtype,
                            rerank_dtype=rerank_dtype, pad_cap=pad_cap, device=device)
    if kind == "sharded_ivf":
        from .parallel.sharded import ShardedIVFIndex

        rerank_dtype = os.environ.get("C99VDB_RERANK_DTYPE", "float32").strip() or "float32"
        return ShardedIVFIndex(dim=DIM, nlist=nlist, nprobe=nprobe, scan_dtype=scan_dtype,
                               rerank_dtype=rerank_dtype, device=device)
    pq = {"m": int(os.environ.get("C99VDB_PQ_M", "8")),
          "ksub": int(os.environ.get("C99VDB_PQ_KSUB", "256")),
          "opq": os.environ.get("C99VDB_OPQ", "").strip() not in ("", "0", "false")}
    if kind == "ivf_pq":
        from .models.ivf_pq import IVFPQIndex

        return IVFPQIndex(dim=DIM, nlist=nlist, nprobe=nprobe, pad_cap=pad_cap, device=device,
                          **pq)
    if kind == "sharded_ivf_pq":
        from .parallel.sharded import ShardedIVFPQIndex

        return ShardedIVFPQIndex(dim=DIM, nlist=nlist, nprobe=nprobe, device=device, **pq)
    raise ValueError(f"unknown C99VDB_INDEX '{kind}'")


def build_index_from_store(bodies: list[str], verbose: bool = False, device=None):
    """Embed every non-blank body in ONE batched device program and build
    a fresh index; the (n, dim) embedding is made on the device, and an IVF
    index trains on it (nlist sized from the corpus) before the add. Under
    `verbose` it logs the rebuild and, for an IVF index on a heavy-tailed
    corpus, the geometry warning (devbuild.geometry_advice)."""
    from .ops.embed import embed_texts_device

    keep_ids = [i for i, body in enumerate(bodies) if not is_blank_body(body or "")]
    index = make_index(corpus_size=len(keep_ids), device=device)
    if keep_ids:
        vectors = embed_texts_device([bodies[i] for i in keep_ids], device=index.device)
        if hasattr(index, "train") and not getattr(index, "is_trained", True):
            index.train(vectors)
        index.add(vectors, np.asarray(keep_ids, dtype=np.int64))
    vlog(
        verbose,
        f"Rebuilt index with {len(keep_ids)} vectors "
        f"(skipped {len(bodies) - len(keep_ids)} blank records)",
    )
    if verbose and keep_ids and hasattr(index, "geometry_diagnostic"):
        from .models.devbuild import geometry_advice

        advice = geometry_advice(index.geometry_diagnostic())
        if advice:
            vlog(verbose, f"Warning: {advice}")
    return index


# -- clean ---------------------------------------------------------------


def cmd_clean(db_base: str, user_cwd: str) -> int:
    index_path, yaml_path = db_paths(db_base, user_cwd)
    removed_any = False
    for p in (index_path, yaml_path):
        try:
            p.unlink()
            removed_any = True
        except FileNotFoundError:
            pass
        except OSError as e:
            return _fail(f"failed to remove {p}: {e}")
    # The derived snapshot sidecar (storage/snapshot.py) goes silently: it
    # is not part of the two-file model, so the verb's output never names it.
    from .storage.snapshot import snap_path

    try:
        snap_path(yaml_path).unlink(missing_ok=True)
    except OSError:
        pass

    verb = "Cleared memory database" if removed_any else "Database already empty"
    print(f"{verb} ({index_path}, {yaml_path})")
    return 0


# -- reindex ---------------------------------------------------------------


@_compute_verb
def cmd_reindex(db_base: str, user_cwd: str, verbose: bool, *, device) -> int:
    from .storage.index_io import write_index

    index_path, yaml_path = db_paths(db_base, user_cwd)
    try:
        store = _load_store(yaml_path)
    except Exception as e:
        return _fail(f"failed to load database YAML '{yaml_path}': {e}")

    compacted, dropped = store.compact()
    compacted.save(yaml_path)  # canonicalize formatting + persist re-sequenced ids

    index = build_index_from_store(compacted.bodies, verbose, device=device)
    ensure_parent(index_path)
    write_index(index, index_path)
    print(f"Rebuilt index from {yaml_path.name}")
    print(f"Wrote index: {index_path.name}")
    if dropped > 0:
        print(f"Compacted: dropped {dropped} blank/deleted entries")
    return 0


# -- save -------------------------------------------------------------------


def parse_save_input(path) -> list[dict[str, Any]]:
    """Validate the save input file: multi-doc YAML, each doc requiring a
    non-empty string `body`, optional map `metadata`, optional int `id`."""
    if not path.exists():
        raise ValueError(f"failed to read input file '{path}'")
    # libyaml's C parser when present: the same typed results as SafeLoader
    # (same resolvers and constructors, storage/yaml_store.py), ~8.5x faster.
    loader = getattr(yaml, "CSafeLoader", yaml.SafeLoader)
    entries: list[dict[str, Any]] = []
    for doc in yaml.load_all(path.read_text(encoding="utf-8"), Loader=loader):
        if doc is None:
            continue
        if not isinstance(doc, dict):
            raise ValueError("each YAML document must be a mapping")
        if "body" not in doc:
            raise ValueError("each YAML document requires 'body'")
        body = doc.get("body")
        if not isinstance(body, str) or body.strip() == "":
            raise ValueError("body must be a non-empty string")
        metadata = doc.get("metadata")
        if metadata is not None and not isinstance(metadata, dict):
            raise ValueError("metadata must be a mapping when provided")
        entry: dict[str, Any] = {"body": body, "metadata": metadata}
        if "id" in doc:
            if not isinstance(doc["id"], int) or doc["id"] < 0:
                raise ValueError("id must be a non-negative integer when provided")
            entry["id"] = int(doc["id"])
        entries.append(entry)
    if not entries:
        raise ValueError("input YAML contains no entries")
    return entries


@_compute_verb
def cmd_save(db_base: str, input_file: str, user_cwd: str, verbose: bool, *, device) -> int:
    from pathlib import Path

    from .ops.embed import embed_texts_device
    from .storage.index_io import load_index_or_fresh, write_index

    index_path, yaml_path = db_paths(db_base, user_cwd)
    try:
        entries = parse_save_input(Path(input_file))
    except ValueError as e:
        return _fail(str(e))

    try:
        store = _load_store(yaml_path)
    except Exception as e:
        return _fail(f"failed to load database YAML '{yaml_path}': {e}")

    index = load_index_or_fresh(
        index_path,
        dim=DIM,
        verbose_log=lambda m: vlog(verbose, m),
        fresh_factory=lambda: make_index(device=device),
        device=device,
    )
    existing_ids = set(int(i) for i in index.ids())
    had_overwrite = False
    appended: list[tuple[int, str]] = []

    for entry in entries:
        body = entry["body"]
        metadata = entry.get("metadata")
        override_id = entry.get("id")
        if override_id is not None:
            # The overwrite target must be a live indexed record.
            if override_id >= len(store) or override_id not in existing_ids:
                return _fail(f"override id {override_id} does not exist")
            store.overwrite(override_id, body, metadata)
            had_overwrite = True
            print(f"Memorized: '{body}' (ID: {override_id})")
        else:
            new_id = store.append(body, metadata)
            appended.append((new_id, body))
            print(f"Memorized: '{body}' (ID: {new_id})")

    if had_overwrite:
        # Any overwrite invalidates stored vectors -> full batched rebuild.
        index = build_index_from_store(store.bodies, verbose, device=device)
    elif appended:
        vectors = embed_texts_device([body for _, body in appended], device=index.device)
        index.add(vectors, np.asarray([rid for rid, _ in appended], dtype=np.int64))

    ensure_parent(index_path)
    write_index(index, index_path)
    store.save(yaml_path)
    return 0


# -- recall -------------------------------------------------------------------


@_compute_verb
def cmd_recall(
    db_base: str,
    query: str,
    k: int,
    filter_expr: str | None,
    as_yaml: bool,
    user_cwd: str,
    verbose: bool = False,
    *,
    device,
) -> int:
    from .storage.index_io import load_index_or_fresh
    from .utils.timing import stage

    index_path, yaml_path = db_paths(db_base, user_cwd)
    try:
        with stage(verbose, "load-yaml"):
            store = _load_store(yaml_path)
    except Exception as e:
        return _fail(f"failed to load database YAML '{yaml_path}': {e}")

    with stage(verbose, "load-index"):
        index = load_index_or_fresh(index_path, dim=DIM, device=device)

    return _recall_once(store, index, query, k, filter_expr, as_yaml, verbose)


def _recall_once(store, index, query: str, k: int, filter_expr: str | None,
                 as_yaml: bool, verbose: bool, *, ranked=None) -> int:
    """One recall against an ALREADY-LOADED store and index, shared by the
    one-shot verb (cmd_recall) and the resident-index serve loop
    (cmd_serve), so both print the same bytes per query.

    `ranked` optionally injects a ranking computed on the device, (dists,
    ids, n): serve's --batch mode ranks many queries in one call
    (index.ranked_many_device) and replays each row through this display
    path."""
    from .ops.embed import embed_texts_device
    from .utils.timing import stage

    if not as_yaml:
        print(f"Top {k} results:")
    if index.ntotal == 0:
        if as_yaml:
            print(yaml.safe_dump({"results": []}, sort_keys=False).strip())
        return 0

    # Embed the query and rank every row on the device (an exhaustive
    # k = ntotal search). The ranking stays there; the display loop pulls
    # doubling O(k)-sized chunks of it as filter and blank misses widen the
    # window, so a large store never crosses to the host whole.
    ranked_handle = ranked
    if ranked_handle is None:
        with stage(verbose, "embed+search"):
            q_vec = embed_texts_device([query], device=index.device)[0]
            # None: the family has no ranking on the device for this
            # configuration (a refine=False IVFPQIndex).
            ranked_handle = index.ranked_all_device(q_vec)
            if ranked_handle is None:
                dists, ids = index.ranked_all(q_vec)

    active_filter: dict[str, Any] | None = None
    if filter_expr is not None:
        # Parsed AFTER the header and the search, as the reference CLI does
        # (it prints "Top k results:" before touching the filter).
        try:
            active_filter = parse_filter(filter_expr)
        except Exception as e:
            return _fail(f"invalid --filter expression: {e}")

    pulled_rows = [0]

    def _ranked_pairs():
        """(dist, id) pairs in ranked order, pulled chunk-wise from a
        ranking on the device (whole from a host ranking)."""
        if ranked_handle is None:
            yield from zip(dists.tolist(), ids.tolist())
            return
        d_dev, i_dev, n = ranked_handle
        ofs = 0
        chunk = max(64, 4 * k)
        while ofs < n:
            step = min(chunk, n - ofs)
            d_np = d_dev[ofs : ofs + step].cpu().numpy()
            i_np = i_dev[ofs : ofs + step].cpu().numpy()
            pulled_rows[0] += step
            yield from zip(d_np.tolist(), i_np.tolist())
            ofs += step
            chunk *= 2

    shown = 0
    yaml_results: list[dict[str, Any]] = []
    for dist, doc_id in _ranked_pairs():
        if shown >= k:
            break
        if dist < SCORE_SKIP_THRESHOLD:  # vestigial parity branch, never true under L2
            continue
        if doc_id < 0 or doc_id >= len(store):
            continue
        if active_filter is not None:
            metadata = store.meta_at(doc_id) or {}
            # Post-filter: records without metadata never match.
            if not metadata or not matches(metadata, active_filter):
                continue
        body = store.bodies[doc_id] or ""
        if is_blank_body(body):
            continue
        if as_yaml:
            yaml_results.append({"id": doc_id, "score": float(dist), "body": block_str(body)})
        else:
            print(f"  [{doc_id}] Score: {dist:.4f} |")
            for line in body.splitlines() or [""]:
                print(f"      {line}")
        shown += 1

    if ranked_handle is not None:
        vlog(
            verbose,
            f"recall ranking pulled {pulled_rows[0]}/{index.ntotal} rows "
            "host-side (chunked device ranking)",
        )
    if as_yaml:
        print(yaml.safe_dump({"results": yaml_results}, sort_keys=False).strip())
    return 0


@_compute_verb
def cmd_serve(
    db_base: str,
    k: int,
    filter_expr: str | None,
    as_yaml: bool,
    user_cwd: str,
    verbose: bool = False,
    batch: int = 1,
    *,
    device,
) -> int:
    """Resident-index recall loop, an EXTENSION verb (absent from --help):
    load the store and the index ONCE, then answer one query per stdin line
    with the exact recall output block until EOF. Framing: plain blocks end
    with ONE EMPTY LINE (every in-block line is prefixed; even an empty
    body line renders as 6 spaces); --yaml blocks end with a `...` line
    (YAML's document-end marker, which cannot appear at column 0 inside
    the indented dump, while a blank line can, in a multi-paragraph body).

    --batch N answers the queries in groups of up to N: a group is ranked
    on the device in sub-batches whose outputs stay under
    ops/distances.RANKED_MANY_BUDGET_BYTES, each printed before the next
    is ranked, with the same bytes as one query at a time."""
    from .ops.distances import ranked_many_chunk
    from .ops.embed import embed_texts_device
    from .storage.index_io import load_index_or_fresh

    index_path, yaml_path = db_paths(db_base, user_cwd)
    try:
        store = _load_store(yaml_path)
    except Exception as e:
        return _fail(f"failed to load database YAML '{yaml_path}': {e}")

    if filter_expr is not None:
        # Fail fast at startup: a bad filter would otherwise surface only
        # at the first query.
        try:
            parse_filter(filter_expr)
        except Exception as e:
            return _fail(f"invalid --filter expression: {e}")

    index = load_index_or_fresh(index_path, dim=DIM, device=device)
    vlog(verbose, f"serving {len(store)} records (resident index); "
                  "one query per line, EOF ends")

    def _stat_key(path):
        try:
            st = path.stat()
        except OSError:
            return None
        # st_ino included: writers publish via atomic rename (a new inode
        # every write) while mtime_ns has kernel-tick granularity.
        return (st.st_mtime_ns, st.st_size, st.st_ino)

    served_state = (_stat_key(yaml_path), _stat_key(index_path))

    def _reload_if_changed() -> int:
        nonlocal store, index, served_state
        state = (_stat_key(yaml_path), _stat_key(index_path))
        if state != served_state:
            # Another process republished the DB: reload so answers reflect
            # it (MemoDB's stat-keyed caches, the same rule). Unchanged
            # files cost two stat calls.
            try:
                store = _load_store(yaml_path)
            except Exception as e:
                return _fail(f"failed to load database YAML '{yaml_path}': {e}")
            index = load_index_or_fresh(index_path, dim=DIM, device=device)
            served_state = state
            vlog(verbose, f"reloaded {len(store)} records (DB files changed)")
        return 0

    if batch <= 1:
        for line in sys.stdin:
            query = line.strip()
            if not query:
                continue
            if _reload_if_changed() != 0:
                return 1
            _recall_once(store, index, query, k, filter_expr, as_yaml, verbose)
            # Block terminator for stream readers (see docstring).
            print("..." if as_yaml else "", flush=True)
        return 0

    # --batch N: queries accumulate until N are pending, a BLANK LINE
    # arrives (the explicit flush marker; blank lines are no-ops in
    # single-query mode, so the framing stays compatible), or EOF. A flush
    # embeds the pending queries in one call, keeps the block on the
    # device, and ranks it in sub-batches (ranked_many_chunk of the
    # ranking's rows), replaying each row through the shared display path.
    pending: list[str] = []

    def _flush() -> int:
        if not pending:
            return 0
        if _reload_if_changed() != 0:
            return 1
        rows = index.ranked_rows() if index.ntotal > 0 else None
        # No batched ranking (an empty index, a refine=False IVFPQIndex):
        # each query takes the one-query route, the same computation.
        q = None if rows is None else embed_texts_device(pending, device=index.device)
        step = len(pending) if rows is None else ranked_many_chunk(rows)
        for s0 in range(0, len(pending), step):
            out = None if q is None else index.ranked_many_device(q[s0 : s0 + step])
            for qi, query in enumerate(pending[s0 : s0 + step]):
                _recall_once(store, index, query, k, filter_expr, as_yaml, verbose,
                             ranked=None if out is None else (out[0][qi], out[1][qi], out[2]))
                print("..." if as_yaml else "", flush=True)
        pending.clear()
        return 0

    for line in sys.stdin:
        query = line.strip()
        if not query:
            if _flush() != 0:
                return 1
            continue
        pending.append(query)
        if len(pending) >= batch:
            if _flush() != 0:
                return 1
    return _flush()


# -- analyze --------------------------------------------------------------------


def cmd_analyze(
    db_base: str,
    filter_expr: str,
    fields: list[str] | None,
    stats_key: str | None,
    limit: int,
    offset: int,
    user_cwd: str,
) -> int:
    if not filter_expr.strip():
        return _fail("analyze requires --filter <expr>")
    if limit < 1:
        return _fail("--limit must be >= 1")
    if offset < 0:
        return _fail("--offset must be >= 0")

    _, yaml_path = db_paths(db_base, user_cwd)
    try:
        store = _load_store(yaml_path)
    except Exception as e:
        return _fail(f"failed to load database YAML '{yaml_path}': {e}")

    try:
        active_filter = parse_filter(filter_expr)
    except Exception as e:
        return _fail(f"invalid --filter expression: {e}")

    # Metadata-only full scan: never touches the index or embeddings.
    found: list[tuple[int, dict[str, Any]]] = []
    for doc_id, _, metadata in store:
        metadata = metadata or {}
        if metadata and matches(metadata, active_filter):
            found.append((doc_id, metadata))

    print(f"Matched: {len(found)}")
    if stats_key is not None:
        for line in render_stats(found, stats_key):
            print(line)
        return 0

    selected = fields if fields else default_fields(found)
    if not selected:
        selected = ["id"]
    page = found[offset : offset + limit]
    rows = [
        [format_cell(resolve_field(doc_id, metadata, f)) for f in selected]
        for doc_id, metadata in page
    ]
    headers = ["ID" if f == "id" else f for f in selected]
    for line in render_table(headers, rows):
        print(line)
    return 0
