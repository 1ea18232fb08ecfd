#!/usr/bin/env python3
"""One follower rank of a sharded cell (entries/sharded_search.py starts
ranks 1 .. W-1 with it; rank 0 is the run itself).

    python3 portbench/shard_rank.py --rank R --world W --port P --seed S \\
        --device cuda|cpu --spec JSON

Joins the process group at tcp://127.0.0.1:P as rank R (NCCL on cuda:R,
or gloo on the cpu), ingests its own rows of the corpus that --spec's
"corpus" names with the index that its "system" names, then follows rank
0's requests until rank 0 stops it. Dies with the process that started
it. Writes only to standard error; its last line gives the requests it
served and its peak host RSS.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import signal
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

PR_SET_PDEATHSIG = 1


def die_with_parent() -> None:
    """SIGKILL this process when the process that started it ends."""
    parent = os.getppid()
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != parent:   # the parent ended before the call
        os._exit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--spec", type=json.loads, required=True)
    args = ap.parse_args(argv)
    die_with_parent()

    import torch
    import torch.distributed as dist

    from portbench import harness

    entry = harness.load_module("entries", "sharded_search")
    device = torch.device("cuda", args.rank) if args.device == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    entry.init_group(device, args.rank, args.world, args.port)
    try:
        server, staged = entry.build_rank(args.spec, args.seed, args.rank, args.world, device)
        served = server.follow()
    finally:
        dist.destroy_process_group()
    print(f"portbench: shard rank {args.rank} staged {staged} live rows, served {served} "
          f"requests, peak host RSS {entry.peak_rss_mib():.1f} MiB", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
