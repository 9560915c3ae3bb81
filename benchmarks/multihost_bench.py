#!/usr/bin/env python3
"""Weak-scaling over REAL process boundaries (gloo-coordinated CPU 'pod').

Unlike the in-process virtual mesh (weak_scaling.py), this spawns separate
OS processes that bring up ``jax.distributed`` against a localhost
coordinator — the collectives genuinely cross process boundaries through
gloo, the same code path a multi-host run takes (with TCP loopback instead of
real network latencies). Work per device is fixed; efficiency = t(1 proc)/t(N proc).

CAVEAT as with weak_scaling.py: this host has 4 physical cores shared by all
processes, so the printed efficiency mixes algorithmic overhead with core
oversubscription; treat it as an upper bound on the cross-process
coordination cost, not a pod measurement.

Run: python benchmarks/multihost_bench.py [--per-dev-mb 2]
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_group(n_procs: int, mb_per_dev: float) -> str:
    coordinator = f"localhost:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.setdefault("JAX_COMPILATION_CACHE_DIR", str(ROOT / ".jax_cache"))
    # Pin each process to its own SINGLE vCPU (same per-process budget at
    # every N, up to N=4 on this 4-vCPU host) so the efficiency figure
    # measures cross-process coordination, not core oversubscription.
    import shutil

    def pin(pid: int) -> list[str]:
        if shutil.which("taskset") and (os.cpu_count() or 0) >= n_procs:
            return ["taskset", "-c", str(pid)]
        return []

    procs = [
        subprocess.Popen(
            [*pin(pid), sys.executable, str(ROOT / "benchmarks/_mh_bench_worker.py"),
             coordinator, str(n_procs), str(pid), str(mb_per_dev)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env,
        )
        for pid in range(n_procs)
    ]
    out = ""
    for p in procs:
        o, _ = p.communicate(timeout=500)
        if p.returncode != 0:
            raise SystemExit(f"worker rc={p.returncode}")
        out += o.decode()
    return out.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-dev-mb", type=float, default=3.0)
    ap.add_argument(
        "--procs", type=str, default="1,2,4",
        help="comma-separated process counts (each pinned to 1 vCPU)",
    )
    args = ap.parse_args()
    for n in (int(x) for x in args.procs.split(",")):
        print(run_group(n, args.per_dev_mb), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
