#!/usr/bin/env python3
"""Weak-scaling sweep of the sharded codec (BASELINE.md target: >= 85%
efficiency at 2+ hosts).

Meant for several devices (drop the CPU pinning below, or use
``parallel.multihost`` across hosts): fixed per-device work, efficiency =
t(1)/t(N). The SPMD program's communication is one 256-count ``psum`` per
file (encode) and one 1 B/chunk ``all_gather`` per sync pass (decode), so
near-flat scaling is expected.

As written it uses N virtual CPU devices that share the host's cores, so
the printed "efficiency" measures core oversubscription, NOT the algorithm
— treat its output as a functional check only.

Run: python benchmarks/weak_scaling.py [--per-dev-mb 2]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).parent.parent
sys.path.insert(0, str(ROOT))

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

from entreepy_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

use_compile_cache()


def corpus(n_bytes: int) -> bytes:
    src = (ROOT / "tests/data/a_midsummer_nights_dream.txt").read_bytes()
    return (src * (-(-n_bytes // len(src))))[:n_bytes]


def best_of(fn, iters=3):
    fn()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-dev-mb", type=float, default=2.0)
    args = ap.parse_args()

    from entreepy_tpu.format import compress_host
    from entreepy_tpu.parallel import compress_sharded, decompress_sharded, make_mesh

    base = None
    rows = []
    for n in (1, 2, 4, 8):
        data = corpus(int(args.per_dev_mb * 1e6) * n)
        mesh = make_mesh(n)
        et = compress_host(data)
        assert decompress_sharded(et, mesh) == data
        t_dec = best_of(lambda: decompress_sharded(et, mesh))
        t_enc = best_of(lambda: compress_sharded(data, mesh, block_bytes=4096))
        if base is None:
            base = (t_enc, t_dec)
        rows.append({
            "devices": n,
            "corpus_MB": round(len(data) / 1e6, 1),
            "encode_s": round(t_enc, 3),
            "decode_s": round(t_dec, 3),
            "weak_eff_encode": round(base[0] / t_enc, 3),
            "weak_eff_decode": round(base[1] / t_dec, 3),
        })
        print(json.dumps(rows[-1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
