"""Hand-written GPU kernels for the codec's two serial hot loops.

Both loops walk a chain of data-dependent steps per vector lane: the decode
FSM (one transition per compressed byte, 512 bytes per chunk lane) and the
encode bit-packer (one code append per input byte, 1024 bytes per block
lane). Their plain XLA forms are ``lax.scan`` loops (``ops/decode8.py``
``_scan_pass`` / ``_fused_scan_pass``, ``ops/bitpack.py``
``pack_blocks_scan``): every step is at least one kernel launch and spends
a [lanes, 256] one-hot product on what is one table lookup. Here each
program owns LANE_BLOCK lanes, one thread per lane, and a loop inside the
program runs every step with the carried state in registers; the per-step
lookup is a gather from a table of at most 256 KB, which stays in cache.

Pallas through Triton (``backend="triton"``); ``interpret=True`` runs the
same kernels on the CPU, which is how the tests pin them to their XLA
twins. :func:`use_kernels` is the one place that chooses kernel or XLA.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Lanes per program (one thread per lane; the tail program is masked).
# Swept on an H100 80GB HBM3 at a 400 W limit: the state-mode pass over
# 6000 lanes x 512 random bytes took 0.44/0.34/0.37/0.37 ms at 32/64/128/256
# lanes per program; the pack of 5.2 MB of text was flat (0.58-0.65 ms).
LANE_BLOCK = 64
_NUM_WARPS = LANE_BLOCK // 32
N_BYTES = 256


def use_kernels() -> bool:
    """True where the hand-written kernels compile: a CUDA GPU backend.
    Everything else (CPU meshes, tests) runs the XLA scans."""
    return jax.default_backend() == "gpu"


def _whole(a) -> pl.BlockSpec:
    """Every program sees all of ``a`` (the lookup tables, scalars)."""
    return pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)


def _lanes(n_lanes: int):
    """This program's lane ids and the mask of those that exist."""
    lane = pl.program_id(0) * LANE_BLOCK + jnp.arange(LANE_BLOCK, dtype=jnp.int32)
    return lane, lane < n_lanes


def _fsm_kernel(x_ref, nxt_ref, entries_ref, nv_ref, *refs, mode: str,
                n_lanes: int, k_start: int, k_total: int, n_rows: int,
                mask_shift: int):
    """One lane block walks bytes ``k_start..k_total`` from its entry
    states. ``mode``: "sync" writes only the exit states, "states" also the
    pre-transition state per byte, "rows" the ``n_rows`` int32 lookup rows
    per byte. ``mask_shift`` > 0 zeroes the bits at and above it in row 0
    for bytes at lane-linear positions >= n_valid (padding)."""
    lane, live = _lanes(n_lanes)
    rows_ref = refs[0] if mode == "rows" else None
    out_ref = refs[-2] if mode != "sync" else None
    exits_ref = refs[-1]
    if mask_shift:
        thresh = nv_ref[0] - lane * k_total
        low = jnp.int32((1 << mask_shift) - 1)

    def step(k, state):
        byte = plgpu.load(x_ref.at[k, :], mask=live, other=0).astype(jnp.int32)
        idx = state * N_BYTES + byte
        if mode == "states":
            plgpu.store(out_ref.at[k, :], state.astype(jnp.uint8), mask=live)
        elif mode == "rows":
            for r in range(n_rows):
                v = rows_ref[r, idx]
                if r == 0 and mask_shift:
                    v = jnp.where(k < thresh, v, v & low)
                plgpu.store(out_ref.at[k, r, :], v, mask=live)
        return nxt_ref[idx]

    state = plgpu.load(entries_ref, mask=live, other=0)
    state = jax.lax.fori_loop(k_start, k_total, step, state)
    plgpu.store(exits_ref, state, mask=live)


@partial(jax.jit, static_argnames=("mode", "k_start", "mask_shift",
                                   "interpret"))
def fsm_pass(xs, nxt, entries, rows=None, n_valid=None, *, mode: str,
             k_start: int = 0, mask_shift: int = 0, interpret: bool = False):
    """One FSM pass over byte rows ``xs`` uint8[K, lanes] from per-lane
    ``entries`` int32[lanes]. ``nxt`` int32[S*256] is the next state of
    (state, byte) at ``state*256 + byte``; ``rows`` int32[R, S*256] the
    per-(state, byte) output rows of mode "rows".

    Returns exits int32[lanes] ("sync"), (states uint8[K, lanes], exits)
    ("states") or (vals int32[K, R, lanes], exits) ("rows")."""
    k, lanes = xs.shape
    lane_blk = pl.BlockSpec((LANE_BLOCK,), lambda i: (i,))
    nv = jnp.reshape(jnp.int32(0) if n_valid is None else n_valid, (1,))
    args = [xs, nxt, entries, nv]
    in_specs = [pl.BlockSpec((k, LANE_BLOCK), lambda i: (0, i)), _whole(nxt),
                lane_blk, _whole(nv)]
    out_shape = [jax.ShapeDtypeStruct((lanes,), jnp.int32)]
    out_specs = [lane_blk]
    n_rows = 0
    if mode == "states":
        out_shape.insert(0, jax.ShapeDtypeStruct((k, lanes), jnp.uint8))
        out_specs.insert(0, pl.BlockSpec((k, LANE_BLOCK), lambda i: (0, i)))
    elif mode == "rows":
        n_rows = rows.shape[0]
        args.append(rows)
        in_specs.append(_whole(rows))
        out_shape.insert(0, jax.ShapeDtypeStruct((k, n_rows, lanes), jnp.int32))
        out_specs.insert(
            0, pl.BlockSpec((k, n_rows, LANE_BLOCK), lambda i: (0, 0, i))
        )
    elif mode != "sync":
        raise ValueError(f"unknown fsm_pass mode {mode!r}")
    out = pl.pallas_call(
        partial(_fsm_kernel, mode=mode, n_lanes=lanes, k_start=k_start,
                k_total=k, n_rows=n_rows, mask_shift=mask_shift),
        grid=(pl.cdiv(lanes, LANE_BLOCK),),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name=f"fsm8_{mode}",
    )(*args)
    return out[0] if mode == "sync" else tuple(out)


def fused_lookup(t_fused, m: int, mt: int, s: int, packed: bool):
    """One-pass decode table (``format.fsm8.fused_decode_tensors``, bf16
    [256, 2s+9(mt+2)]) -> (nxt int32[s*256], rows int32[R, s*256]): the
    combine of ``ops/decode8._fused_scan_pass`` evaluated once for every
    (state, byte), so the kernel's per-byte work is two gathers. ``rows`` is
    the masked-packing word ``raw << 8m | slot_j << 8(m-1-j)`` (R = 1) when
    ``packed``, else raw followed by the m symbol slots (R = m+1) — the twin's
    rows bit for bit (raw = count, or 16 for an invalid transition)."""
    n_p = 9
    t = t_fused.astype(jnp.int32)  # exact: every value is an integer <= 255
    mg = t[:, :s].T  # [s, 256]
    pv = t[:, s : 2 * s].T
    p = pv & 15
    b = jnp.arange(N_BYTES)[None, :]

    def tail(j):  # tail block j, selected by (byte, p) -> [s, 256]
        return t[:, 2 * s + j * n_p : 2 * s + (j + 1) * n_p][b, p]

    tcv = tail(0)
    inv = (pv >= 16) | ((p > 0) & (tcv >= 16))
    raw = jnp.where(inv, 16, (p > 0).astype(jnp.int32) + (tcv & 15))
    slots = [mg] + [tail(1 + j) for j in range(m - 1)]
    nxt = jnp.where(p > 0, tail(mt + 1), mg)
    if packed:
        word = raw << (8 * m)
        for j, sl in enumerate(slots):
            word = word | (sl << (8 * (m - 1 - j)))
        rows = word[None]
    else:
        rows = jnp.stack([raw] + slots)
    return nxt.reshape(-1), rows.reshape(rows.shape[0], -1)


def _pack_kernel(x_ref, valid_ref, len_ref, code_ref, words_ref, emitted_ref,
                 acc_ref, nbits_ref, *, n_lanes: int, steps: int):
    """One lane block packs its blocks: per byte a gather of (length, code)
    and a 64-bit accumulator held as two uint32 halves, emitting the high
    word whenever it fills (the exact step of ``bitpack.pack_blocks_scan``)."""
    _, live_lane = _lanes(n_lanes)
    valid = plgpu.load(valid_ref, mask=live_lane, other=0)
    u32 = jnp.uint32

    def step(t, carry):
        acc_hi, acc_lo, nbits = carry
        byte = plgpu.load(x_ref.at[t, :], mask=live_lane, other=0).astype(jnp.int32)
        live = t < valid
        length = jnp.where(live, len_ref[byte], 0)
        code = jnp.where(live, code_ref[byte], u32(0))
        s = nbits + length  # <= 63
        fits = s <= 32
        hi = jnp.where(
            fits,
            code << jnp.clip(32 - s, 0, 31).astype(u32),
            code >> jnp.clip(s - 32, 0, 31).astype(u32),
        )
        lo = jnp.where(fits, u32(0), code << jnp.clip(64 - s, 0, 31).astype(u32))
        acc_hi = acc_hi | hi
        acc_lo = acc_lo | lo
        emit = s >= 32
        plgpu.store(words_ref.at[t, :], acc_hi, mask=live_lane)
        plgpu.store(emitted_ref.at[t, :], emit.astype(jnp.int8), mask=live_lane)
        acc_hi = jnp.where(emit, acc_lo, acc_hi)
        acc_lo = jnp.where(emit, u32(0), acc_lo)
        nbits = jnp.where(emit, s - 32, s)
        return acc_hi, acc_lo, nbits

    zero = jnp.zeros(LANE_BLOCK, u32)
    acc_hi, _, nbits = jax.lax.fori_loop(
        0, steps, step, (zero, zero, jnp.zeros(LANE_BLOCK, jnp.int32))
    )
    plgpu.store(acc_ref, acc_hi, mask=live_lane)
    plgpu.store(nbits_ref, nbits, mask=live_lane)


@partial(jax.jit, static_argnames=("interpret",))
def pack_blocks_kernel(blocks, valid, codetbl, interpret: bool = False):
    """Kernel twin of ``ops.bitpack.pack_blocks_scan``, same contract:
    blocks uint8[lanes, steps], valid int32[lanes], codetbl bf16[256, 5]
    (``bitpack.code_table_cols``) -> (words uint32[lanes, steps], emitted
    bool[lanes, steps], acc uint32[lanes], nbits int32[lanes])."""
    lanes, steps = blocks.shape
    t = codetbl.astype(jnp.int32)  # exact: values <= 255
    length = t[:, 0]
    code = ((t[:, 1] << 24) | (t[:, 2] << 16) | (t[:, 3] << 8) | t[:, 4]).astype(
        jnp.uint32
    )
    rows = pl.BlockSpec((steps, LANE_BLOCK), lambda i: (0, i))
    lane_blk = pl.BlockSpec((LANE_BLOCK,), lambda i: (i,))
    words, emitted, acc, nbits = pl.pallas_call(
        partial(_pack_kernel, n_lanes=lanes, steps=steps),
        grid=(pl.cdiv(lanes, LANE_BLOCK),),
        in_specs=[rows, lane_blk, _whole(length), _whole(code)],
        out_specs=[rows, rows, lane_blk, lane_blk],
        out_shape=[
            jax.ShapeDtypeStruct((steps, lanes), jnp.uint32),
            jax.ShapeDtypeStruct((steps, lanes), jnp.int8),
            jax.ShapeDtypeStruct((lanes,), jnp.uint32),
            jax.ShapeDtypeStruct((lanes,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="pack_blocks",
    )(blocks.T, valid, length, code)
    return words.T, emitted.T.astype(bool), acc, nbits
