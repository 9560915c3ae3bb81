#!/usr/bin/env python3
"""Smoke test of the device codec on one GPU (or the sharded codec on four).

Runs the codec through the entry points a user calls — ``compress`` and
``decompress`` with ``backend="device"`` and with auto routing, and the CLI
— on corpora of the sizes its users run: the reference's 5.2 MB headline
text, 100 MB of text (enwik8 scale), and 16 MB each of random and of
skewed bytes. Every corpus is built from ``--seed`` and the texts in
``tests/data/``; nothing is downloaded. Then each hand-written kernel
(``entreepy_tpu/ops/kernels.py``) runs on the card beside the plain XLA
form it replaces, and their outputs are compared and timed.

Correctness is exact equality: every ``.et`` must be byte-identical to the
plain reference ``format.compress_host`` and every decode must return the
input bytes, because the codec is lossless; kernel and XLA outputs must be
bit-identical, because every table value is an integer <= 255 (exact in
bf16) and nothing else is rounded. Any failed check raises, and the script
exits non-zero.

    python chip_smoke.py              # one GPU
    python chip_smoke.py --chips 4    # the sharded codec over four GPUs

With ``--chips 4`` only the sharded phases run (100 MB of text, both
decode routes, auto routing) and are compared with ``compress_host``. The
last line of standard output is the JSON result; it is printed only when
every phase passed. Without a GPU the script exits non-zero before any
phase.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from contextlib import contextmanager
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MB = 1_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, iters: int = 10) -> float:
    """Median wall time of ``fn`` (which blocks on its result) after one
    warm-up call, in ms."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


# ---------------------------------------------------------------- corpora


def text_corpus(n_bytes: int, seed: int) -> bytes:
    """``n_bytes`` of text: whole lines of tests/data/*.txt drawn at random
    (seeded), so the stream is not periodic the way a tiled file is."""
    lines = []
    for p in sorted((ROOT / "tests/data").glob("*.txt")):
        lines += p.read_bytes().splitlines(keepends=True)
    pool = np.frombuffer(b"".join(lines), np.uint8)
    lens = np.array([len(x) for x in lines], np.int64)
    starts = np.cumsum(lens) - lens
    rng = np.random.default_rng(seed)
    out, have = [], 0
    while have < n_bytes:  # ~10 MB per round keeps the index arrays small
        idx = rng.integers(0, len(lines), 10 * MB // int(lens.mean()))
        ln = lens[idx]
        pos = np.repeat(starts[idx] - (np.cumsum(ln) - ln), ln)
        piece = pool[pos + np.arange(pos.size)]
        out.append(piece)
        have += piece.size
    return np.concatenate(out)[:n_bytes].tobytes()


def random_corpus(n_bytes: int, seed: int) -> bytes:
    """Uniform random bytes: all 256 codes are 8 bits long (m = 1)."""
    return np.random.default_rng(seed).integers(0, 256, n_bytes, np.uint8).tobytes()


def skewed_corpus(n_bytes: int, seed: int) -> bytes:
    """One byte at ~95%, 15 others share the rest: the common byte gets a
    1-bit code, so one compressed byte can hold 8 symbols (m > 3)."""
    rng = np.random.default_rng(seed)
    other = rng.integers(0, 15, n_bytes).astype(np.uint8) + ord("b")
    return np.where(rng.random(n_bytes) < 0.95, np.uint8(ord("a")), other).tobytes()


# ---------------------------------------------------------------- helpers


@contextmanager
def xla_passes():
    """Run the per-byte passes as the plain XLA scans the kernels replace
    (decode passes and pack), everything else unchanged."""
    from entreepy_tpu.ops import decode8, kernels

    saved = decode8.pass_impl, kernels.use_kernels
    decode8.pass_impl = lambda: "scan"
    kernels.use_kernels = lambda: False
    try:
        yield
    finally:
        decode8.pass_impl, kernels.use_kernels = saved


def same(a, b, what: str) -> None:
    import jax

    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b), strict=True):
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape or not np.array_equal(x, y):
            raise AssertionError(f"{what}: kernel and XLA outputs differ")


def gather_scan_pass(xs, nxt, rows, entries, n_valid, mask_shift: int):
    """The one-pass decode as a plain ``lax.scan`` with the per-step lookup
    written as a gather (``rows[:, state*256 + byte]``) instead of the
    twin's one-hot product — the second plain form the kernel must beat."""
    import jax
    import jax.numpy as jnp

    k, lanes = xs.shape
    pos0 = jnp.arange(lanes, dtype=jnp.int32) * k
    low = jnp.int32((1 << mask_shift) - 1) if mask_shift else None

    def step(state, x):
        byte, kk = x
        idx = state * 256 + byte.astype(jnp.int32)
        v = rows[:, idx]
        if mask_shift:
            v = v.at[0].set(jnp.where(pos0 + kk < n_valid, v[0], v[0] & low))
        return nxt[idx], v

    exits, vals = jax.lax.scan(step, entries, (xs, jnp.arange(k, dtype=jnp.int32)))
    return vals, exits


# ---------------------------------------------------------------- phases


def roundtrip(name: str, data: bytes, auto: bool = False) -> bytes:
    """Device compress + decompress of one corpus against compress_host."""
    from entreepy_tpu import api, compress, decompress
    from entreepy_tpu.format import compress_host
    from entreepy_tpu.ops import decode8, encode

    t0 = time.perf_counter()
    ref = compress_host(data, strict=False)
    t_host = time.perf_counter() - t0
    tiles0 = encode.stats["encode_tiles"], decode8.stats["decode_tiles"]
    t0 = time.perf_counter()
    et = compress(data, strict=False, backend="device")
    t_enc = time.perf_counter() - t0
    assert et == ref, f"{name}: device .et differs from compress_host"
    t0 = time.perf_counter()
    out = decompress(ref, backend="device")
    t_dec = time.perf_counter() - t0
    assert out == data, f"{name}: device decode differs from the input"
    enc_tiles = encode.stats["encode_tiles"] - tiles0[0]
    dec_tiles = decode8.stats["decode_tiles"] - tiles0[1]
    log(f"[{name}] {len(data)} B -> {len(ref)} B: device .et == compress_host, "
        f"device decode == input (first calls, compile included: encode "
        f"{t_enc:.2f} s, decode {t_dec:.2f} s; compress_host {t_host:.2f} s; "
        f"encode tiles {enc_tiles}, decode tiles {dec_tiles})")
    if auto:
        assert enc_tiles > 1 and dec_tiles > 1, f"{name}: the tiled paths did not run"
        for n in (len(data), len(ref)):
            got = api._pick_backend(None, n)
            assert got == "device", f"{name}: auto routing chose {got!r} for {n} B"
        assert compress(data, strict=False) == ref, f"{name}: auto .et differs"
        assert decompress(ref) == data, f"{name}: auto decode differs"
        log(f"[{name}] auto routing chose 'device' for compress ({len(data)} B) "
            f"and decompress ({len(ref)} B); both round-trip exactly")
    return ref


def e2e_kernel_vs_xla(name: str, data: bytes, et: bytes, pairs: int) -> None:
    """Device compress and decompress end to end, with the kernels and with
    the XLA scans in their place, interleaved (kernel, XLA, XLA, kernel, ...)
    after a warm-up of each, so drift on the host hits both sides alike."""
    from entreepy_tpu import compress, decompress

    def enc():
        assert compress(data, strict=False, backend="device") == et

    def dec():
        assert decompress(et, backend="device") == data

    def run(fn, side: str) -> float:
        t0 = time.perf_counter()
        if side == "xla":
            with xla_passes():
                fn()
        else:
            fn()
        return time.perf_counter() - t0

    for what, fn in (("encode", enc), ("decode", dec)):
        run(fn, "kernels"), run(fn, "xla")  # warm-up
        times = {"kernels": [], "xla": []}
        for i in range(pairs):
            for side in (("kernels", "xla") if i % 2 == 0 else ("xla", "kernels")):
                times[side].append(run(fn, side))
        k, x = (np.array(times[s]) * 1e3 for s in ("kernels", "xla"))
        log(f"[{name}] e2e {what}: kernels {np.median(k):.3f} ms, XLA scans "
            f"{np.median(x):.3f} ms (medians of {pairs} interleaved pairs; the "
            f"kernels faster in {int((k < x).sum())} of {pairs}; {CARD})")


def kernels_vs_xla(name: str, data: bytes, et: bytes) -> None:
    """Each kernel beside its plain XLA form at this corpus's real width
    (the first tile where the codec tiles): bit-identical, and timed."""
    import jax
    import jax.numpy as jnp

    from entreepy_tpu.format import parse_header
    from entreepy_tpu.format.fsm8 import build_byte_fsm
    from entreepy_tpu.ops import decode8, kernels
    from entreepy_tpu.ops.bitpack import (
        code_table_cols, compact_payload_plane, grouped_counts_plane,
        histogram_device, pack_blocks_jit, plane_cap_g,
    )
    from entreepy_tpu.ops.encode import DEFAULT_BLOCK_BYTES, TILE_BLOCKS, _bucket
    from entreepy_tpu.utils.stitch import split_blocks

    def line(what, k_ms, x_ms, x_name="XLA scan", extra=""):
        log(f"[{name}] {what}: kernel {k_ms:.4f} ms, {x_name} {x_ms:.4f} ms "
            f"(median of 10, {CARD}){extra}")

    # ---- decode: one-pass (rows) decode, its single pass, the state mode
    hdr = parse_header(et)
    fsm = build_byte_fsm(hdr.table)
    chunk = decode8.DEFAULT_CHUNK_BYTES
    body = np.frombuffer(et, np.uint8)[hdr.body_start:][: decode8.TILE_LANES * chunk]
    lanes = -(-body.size // chunk)
    padded = np.zeros(lanes * chunk, np.uint8)
    padded[: body.size] = body
    cols = decode8.bytes_to_cols(padded, lanes, chunk)
    tbl = decode8._table_T_bf16(fsm)
    t_fused, m, mt, s = decode8.build_fused(fsm)
    packed = m <= 3
    nv = jnp.int32(body.size)
    args = (cols, tbl, t_fused, jnp.int32(lanes), m, mt, s)
    run = {impl: partial(decode8.fsm8_decode_fused, packed=packed, impl=impl)
           for impl in ("kernel", "scan")}
    outs = {impl: f(*args, n_valid=nv) for impl, f in run.items()}
    same(outs["kernel"], outs["scan"], f"{name} one-pass decode")
    assert not bool(outs["kernel"][2]), f"{name}: self-sync did not converge"
    times = {impl: median_ms(lambda f=f: jax.block_until_ready(f(*args, n_valid=nv)))
             for impl, f in run.items()}
    line(f"one-pass decode ({lanes} lanes x {chunk} B, m={m}, "
         f"{'packed' if packed else f'{m + 1} rows'})", times["kernel"], times["scan"])

    # one pass from the converged entries: kernel, one-hot scan, gather scan
    exits = outs["scan"][1]
    entries = jnp.concatenate([jnp.zeros(1, jnp.int32), exits[:-1]])
    shift = 8 * m if packed else 0
    nxt, rows = kernels.fused_lookup(t_fused, m, mt, s, packed)
    xs8 = decode8.byte_rows(cols, "kernel")
    xs32 = decode8.byte_rows(cols, "scan")
    one = {  # name -> (jitted pass, its arrays)
        "kernel": (jax.jit(partial(kernels.fsm_pass, mode="rows", mask_shift=shift)),
                   (xs8, nxt, entries, rows, nv)),
        "scan": (jax.jit(lambda x, t, e, v: decode8.fused_pass(
            x, t, e, m, mt, s, packed, v, "scan")[::-1]), (xs32, t_fused, entries, nv)),
        "gather": (jax.jit(partial(gather_scan_pass, mask_shift=shift)),
                   (xs8, nxt, rows, entries, nv)),
    }
    res = {k: f(*a) for k, (f, a) in one.items()}
    want = res["kernel"]
    if packed:
        want = (want[0][:, 0, :], want[1])
        res["gather"] = (res["gather"][0][:, 0, :], res["gather"][1])
    same(want, res["scan"], f"{name} fused pass (one-hot scan)")
    same(want, res["gather"], f"{name} fused pass (gather scan)")
    t1 = {k: median_ms(lambda f=f, a=a: jax.block_until_ready(f(*a)))
          for k, (f, a) in one.items()}
    line("one fused pass", t1["kernel"], t1["scan"],
         extra=f"; gather scan {t1['gather']:.4f} ms")

    st = {impl: partial(decode8.fsm8_decode, impl=impl) for impl in ("kernel", "scan")}
    same(st["kernel"](cols, tbl, jnp.int32(lanes)), st["scan"](cols, tbl, jnp.int32(lanes)),
         f"{name} state decode")
    ts = {k: median_ms(lambda f=f: jax.block_until_ready(f(cols, tbl, jnp.int32(lanes))))
          for k, f in st.items()}
    line("state-mode decode (sync + state passes)", ts["kernel"], ts["scan"])

    # the decode's on-device compaction (dense, no sort) and the sort one
    # the sharded route uses: XLA only, printed for the record
    if packed:
        vals = outs["kernel"][0]
        sub = decode8.SUB_BYTES_FETCH
        cap = decode8.packed_sym_cap(decode8.packed_mini_totals(vals, m, sub=sub),
                                     m, chunk, sub=sub)
        td = median_ms(lambda: jax.block_until_ready(
            decode8.compact_symbols_dense(vals, m)))
        tsort = median_ms(lambda: jax.block_until_ready(
            decode8.compact_symbols_packed(vals, m, cap, sub=sub)))
        log(f"[{name}] XLA decode compaction: dense {td:.4f} ms, per-subgroup "
            f"sort {tsort:.4f} ms (median of 10, {CARD})")

    # ---- encode: the pack, the histogram and the plane sort
    arr = np.frombuffer(data, np.uint8)[: TILE_BLOCKS * DEFAULT_BLOCK_BYTES]
    blocks, valid = split_blocks(arr, DEFAULT_BLOCK_BYTES)
    pad = _bucket(blocks.shape[0]) - blocks.shape[0]
    blocks = jnp.asarray(np.pad(blocks, ((0, pad), (0, 0))))
    valid = jnp.asarray(np.pad(valid, (0, pad)))
    codetbl = jnp.asarray(code_table_cols(hdr.table.codes, hdr.table.lengths),
                          jnp.bfloat16)
    pk = kernels.pack_blocks_kernel(blocks, valid, codetbl)
    same(pk, pack_blocks_jit(blocks, valid, codetbl), f"{name} pack")
    tp = [median_ms(lambda f=f: jax.block_until_ready(f(blocks, valid, codetbl)))
          for f in (kernels.pack_blocks_kernel, pack_blocks_jit)]
    line(f"pack ({blocks.shape[0]} blocks x {DEFAULT_BLOCK_BYTES} B)", *tp)

    hist_in = jnp.asarray(np.pad(arr, (0, _bucket(arr.size) - arr.size)))
    th = median_ms(lambda: jax.block_until_ready(
        histogram_device(hist_in, jnp.int32(arr.size))))
    counts_g = np.asarray(grouped_counts_plane(pk[1]))
    cap = plane_cap_g(int(counts_g.max(initial=0)), DEFAULT_BLOCK_BYTES)
    tc = median_ms(lambda: jax.block_until_ready(compact_payload_plane(*pk, cap)))
    log(f"[{name}] XLA encode histogram {th:.4f} ms, plane sort compaction "
        f"{tc:.4f} ms ({arr.size} B, median of 10, {CARD})")


def cli_phase(data: bytes, ref: bytes) -> None:
    """The CLI round trip, in this process (a second process on the card
    would fail for want of device memory)."""
    import tempfile

    from entreepy_tpu.cli import main as cli_main

    with tempfile.TemporaryDirectory() as d:
        src = Path(d) / "text.txt"
        src.write_bytes(data)
        assert cli_main(["c", str(src), "--backend", "device"]) == 0
        et_path = Path(str(src) + ".et")
        assert et_path.read_bytes() == ref, "CLI .et differs from compress_host"
        assert cli_main(["d", str(et_path), "--backend", "device"]) == 0
        out = (Path(d) / "decoded_text.txt").read_bytes()
        assert out == data, "CLI decode differs from the input"
    log(f"[cli] c/d --backend device on {len(data)} B: .et == compress_host, "
        "decoded == input")


def single_card(seed: int) -> None:
    from bench import build_corpus
    from entreepy_tpu.ops import decode8

    text5 = build_corpus()
    ref5 = roundtrip("text-5.2MB", text5)
    text100 = text_corpus(100 * MB, seed)
    ref100 = roundtrip("text-100MB", text100, auto=True)
    rnd = random_corpus(16 << 20, seed + 1)
    ref_rnd = roundtrip("random-16MB", rnd)
    skw = skewed_corpus(16 << 20, seed + 2)
    ref_skw = roundtrip("skewed-16MB", skw)
    cli_phase(text5, ref5)

    e2e_kernel_vs_xla("text-5.2MB", text5, ref5, pairs=20)
    e2e_kernel_vs_xla("text-100MB", text100, ref100, pairs=12)
    for name, data, et in (("text-5.2MB", text5, ref5), ("text-100MB", text100, ref100),
                           ("random-16MB", rnd, ref_rnd), ("skewed-16MB", skw, ref_skw)):
        kernels_vs_xla(name, data, et)

    assert decode8.stats["host_fallbacks"] == 0, (
        f"self-sync host fallback fired {decode8.stats['host_fallbacks']} times")
    log("[fallback] the self-sync host fallback did not fire on any corpus")


def four_cards(seed: int) -> None:
    import jax

    from entreepy_tpu import api, compress, decompress
    from entreepy_tpu.format import compress_host
    from entreepy_tpu.ops import decode8
    from entreepy_tpu.parallel import compress_sharded, decompress_sharded, make_mesh

    assert len(jax.devices()) == 4, f"--chips 4 needs 4 GPUs, found {len(jax.devices())}"
    data = text_corpus(100 * MB, seed)
    ref = compress_host(data)
    mesh = make_mesh()
    for attempt in ("first call", "warm"):
        t0 = time.perf_counter()
        et = compress_sharded(data, mesh)
        t_enc = time.perf_counter() - t0
        assert et == ref, "compress_sharded .et differs from compress_host"
        times = []
        for expand in (True, False):
            t0 = time.perf_counter()
            out = decompress_sharded(ref, mesh, device_expand=expand)
            times.append(time.perf_counter() - t0)
            assert out == data, f"decompress_sharded(device_expand={expand}) differs"
        log(f"[text-100MB sharded x4] {attempt}: compress_sharded == compress_host "
            f"({t_enc:.2f} s); decompress_sharded == input with device_expand=True "
            f"({times[0]:.2f} s) and False ({times[1]:.2f} s)")
    for n in (len(data), len(ref)):
        got = api._pick_backend(None, n)
        assert got == "sharded", f"auto routing chose {got!r} for {n} B"
    assert compress(data) == ref and decompress(ref) == data
    log("[text-100MB sharded x4] auto routing chose 'sharded' both ways; "
        "round trip exact")
    assert decode8.stats["host_fallbacks"] == 0, "self-sync host fallback fired"


CARD = ""


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="corpus seed")
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded phases over four GPUs")
    opts = ap.parse_args()
    if not (ROOT / "entreepy_tpu").is_dir() or not (ROOT / "bench.py").is_file():
        print("error: chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from entreepy_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    import jax

    if jax.default_backend() != "gpu":
        print(f"error: no GPU (JAX backend: {jax.default_backend()})", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    CARD = smi.splitlines()[0]
    t0 = time.perf_counter()
    (four_cards if opts.chips == 4 else single_card)(opts.seed)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    d0 = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
