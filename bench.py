#!/usr/bin/env python3
"""Headline benchmark: decode throughput on a ~5.2 MB Shakespeare corpus.

The reference's published headline number (README.md:53, reproduced in
BASELINE.md) is decompression of the ~5.2 MB Complete Works of Shakespeare in
11.8 s (~0.44 MB/s) on an M2 MacBook Air. The corpus is synthesized offline
at the same scale and symbol statistics by tiling the ~112 KB
`a_midsummer_nights_dream.txt` fixture to 5.2 MB.

Prints ONE JSON line:
  {"metric": "decode_throughput_5MB", "value": <MB/s>, "unit": "MB/s",
   "vs_baseline": <value / 0.44>, "device": {...}, <device fields>}

The headline measures the framework's auto backend end-to-end (bytes in ->
bytes out). The device fields time the GPU path in this same process: the
device encode and decode end to end, and the two hand-written kernels alone
(one-pass decode, block pack), each ending in ``block_until_ready``. The
device part needs a GPU: without one the run fails (it never reports CPU
times under device names).
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

from entreepy_tpu.utils.compile_cache import use_compile_cache

BASELINE_DECODE_MBPS = 0.44  # README.md:53: 5.2 MB in 11.8 s
TARGET_BYTES = 5_200_000


def build_corpus() -> bytes:
    src = (Path(__file__).parent / "tests/data/a_midsummer_nights_dream.txt").read_bytes()
    reps = -(-TARGET_BYTES // len(src))
    return (src * reps)[:TARGET_BYTES]


def median_ms(fn, warmup: int = 1, iters: int = 10):
    """(last result, median wall ms); ``fn`` must block on its own result."""
    out = None
    for _ in range(warmup):
        out = fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times)) * 1e3


def device_probe(data: bytes, et: bytes) -> dict:
    """GPU times of the shipped device path (ms, medians of 10)."""
    import jax
    import jax.numpy as jnp

    from entreepy_tpu import compress, decompress
    from entreepy_tpu.format import parse_header
    from entreepy_tpu.format.fsm8 import build_byte_fsm
    from entreepy_tpu.ops.bitpack import code_table_cols, pack_blocks
    from entreepy_tpu.ops.decode8 import (
        DEFAULT_CHUNK_BYTES, _table_T_bf16, build_fused, bytes_to_cols,
        run_fused_decode,
    )
    from entreepy_tpu.ops.encode import DEFAULT_BLOCK_BYTES, _bucket
    from entreepy_tpu.utils.stitch import split_blocks

    out = {}
    got, out["decode_e2e_ms"] = median_ms(lambda: decompress(et, backend="device"))
    assert got == data, "device decode differs from the input"
    got, out["encode_e2e_ms"] = median_ms(lambda: compress(data, backend="device"))
    assert got == et, "device encode differs from the host codec"

    hdr = parse_header(et)
    fsm = build_byte_fsm(hdr.table)
    buf = np.frombuffer(et, np.uint8)[hdr.body_start :]
    lanes = -(-buf.size // DEFAULT_CHUNK_BYTES)
    padded = np.zeros(lanes * DEFAULT_CHUNK_BYTES, np.uint8)
    padded[: buf.size] = buf
    cols = bytes_to_cols(padded, lanes, DEFAULT_CHUNK_BYTES)
    t_fused, m, mt, s = build_fused(fsm)
    args = (cols, _table_T_bf16(fsm), t_fused, jnp.int32(lanes), m, mt, s)
    _, out["fused_decode_ms"] = median_ms(lambda: jax.block_until_ready(
        run_fused_decode(*args, packed=m <= 3, n_valid=jnp.int32(buf.size))
    ))

    arr = np.frombuffer(data, np.uint8)
    blocks, valid = split_blocks(arr, DEFAULT_BLOCK_BYTES)
    pad = _bucket(blocks.shape[0]) - blocks.shape[0]
    blocks = jnp.asarray(np.pad(blocks, ((0, pad), (0, 0))))
    valid = jnp.asarray(np.pad(valid, (0, pad)))
    codetbl = jnp.asarray(code_table_cols(hdr.table.codes, hdr.table.lengths),
                          jnp.bfloat16)
    _, out["pack_ms"] = median_ms(lambda: jax.block_until_ready(
        pack_blocks(blocks, valid, codetbl)
    ))
    out["decode_e2e_MBps"] = len(data) / 1e3 / out["decode_e2e_ms"]
    out["encode_e2e_MBps"] = len(data) / 1e3 / out["encode_e2e_ms"]
    return out


def main() -> int:
    use_compile_cache()
    import jax

    from entreepy_tpu import compress, decompress

    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"bench.py needs a GPU (JAX backend: {jax.default_backend()})"
        )

    data = build_corpus()
    mb = len(data) / 1e6
    et, t_enc = median_ms(lambda: compress(data), iters=13)
    out, t_dec = median_ms(lambda: decompress(et), iters=13)
    if out != data:
        print(json.dumps({"metric": "decode_throughput_5MB", "value": 0.0,
                          "unit": "MB/s", "vs_baseline": 0.0}))
        return 1
    dev = device_probe(data, et)
    d0 = jax.devices()[0]
    dec_mbps = mb / (t_dec / 1e3)
    print(
        f"corpus={len(data)}B compressed={len(et)}B ratio={len(data)/len(et):.2f} "
        f"encode={t_enc:.1f}ms ({mb / (t_enc / 1e3):.1f} MB/s) "
        f"decode={t_dec:.1f}ms ({dec_mbps:.1f} MB/s) "
        + " ".join(f"{k}={v}" for k, v in dev.items()),
        file=sys.stderr,
    )
    line = {
        "metric": "decode_throughput_5MB",
        "value": dec_mbps,
        "unit": "MB/s",
        "vs_baseline": dec_mbps / BASELINE_DECODE_MBPS,
        "device": {"platform": d0.platform, "kind": d0.device_kind,
                   "count": len(jax.devices())},
        **dev,
    }
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
