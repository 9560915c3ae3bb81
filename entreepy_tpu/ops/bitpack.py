"""Device-side encode: histogram + block-parallel bit packing.

Block-parallel replacement for the reference's serial hot loop
(``encode.zig:301-319``: one ``writeBits(..., 1)`` call per output bit):

* blocks = vector lanes; each lane walks its block's bytes carrying a
  64-bit accumulator (two u32 halves). A full u32 word is emitted
  *densely* per (step, lane) with a flag; a compaction (device sort here,
  or the host runtime) gathers the flagged words into per-block payloads.
* on the GPU the walk is a hand-written kernel (``ops/kernels.py``
  ``pack_blocks_kernel``: one thread per lane, the (code, length) lookup a
  gather from the 256-entry code table). Its XLA twin,
  :func:`pack_blocks_scan`, is a ``lax.scan`` whose per-byte lookup is
  ``onehot(byte) @ code_table`` — a [lanes, 256] x [256, 5] bf16 product;
  the 32-bit code is split into four 8-bit limb columns so every table
  value is <= 255 and bf16 accumulation is exact.

Within a block the pack is bit-exact with the reference's single serial
stream; independent blocks shard across devices and are stitched at bit
granularity afterwards (utils/stitch.py).
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

U32 = jnp.uint32
HIST_COLS = 4096  # bytes per histogram scan step


@jax.jit
def histogram_device(data: jax.Array, valid_len: jax.Array) -> jax.Array:
    """256-bin histogram of ``data[:valid_len]`` -> int32[256].

    ``data`` is uint8, zero-padded to a multiple of HIST_COLS. Compare-reduce
    over byte columns instead of bincount (which XLA lowers to a scatter).
    """
    cols = data.reshape(-1, HIST_COLS)
    sym = jnp.arange(256, dtype=jnp.int32)

    def step(acc, row):
        return acc + jnp.sum(row[:, None].astype(jnp.int32) == sym[None, :], axis=0), None

    counts, _ = jax.lax.scan(step, jnp.zeros(256, jnp.int32), cols)
    pad = data.shape[0] - valid_len
    return counts.at[0].add(-pad.astype(jnp.int32))


def code_table_cols(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """[256, 5] float32 columns: code length + 4 big-endian byte limbs of the
    right-aligned 32-bit code. All values <= 255 -> exact in bf16 matmuls."""
    t = np.zeros((256, 5), dtype=np.float32)
    t[:, 0] = lengths
    for i in range(4):
        t[:, 1 + i] = (codes >> (24 - 8 * i)) & 0xFF
    return t


def pack_blocks_scan(
    blocks: jax.Array,  # uint8[lanes, steps] zero-padded
    valid: jax.Array,  # int32[lanes] real byte count per block
    codetbl: jax.Array,  # bf16[256, 5] from code_table_cols
):
    """Pack every block independently (traceable core — also used per-shard
    inside shard_map by the multi-device path).

    Returns (words uint32[lanes, steps] — dense emission slots, emitted
    bool[lanes, steps], acc uint32[lanes] — final partial word MSB-aligned,
    nbits int32[lanes] — bits held in acc). Block b's bitstream is its
    flagged words in step order followed by nbits of acc.
    """
    lanes, steps = blocks.shape
    sym = jnp.arange(256, dtype=jnp.int32)
    xs = (blocks.T.astype(jnp.int32), jnp.arange(steps, dtype=jnp.int32))

    def step(carry, x):
        acc_hi, acc_lo, nbits = carry
        byte, j = x
        oh = (byte[:, None] == sym[None, :]).astype(jnp.bfloat16)
        vals = jnp.dot(oh, codetbl, preferred_element_type=jnp.float32)
        live = j < valid
        length = jnp.where(live, vals[:, 0].astype(jnp.int32), 0)
        limbs = vals[:, 1:5].astype(U32)
        code = jnp.where(
            live,
            (limbs[:, 0] << 24) | (limbs[:, 1] << 16) | (limbs[:, 2] << 8) | limbs[:, 3],
            jnp.uint32(0),
        )

        s = nbits + length  # <= 63
        fits = s <= 32
        hi = jnp.where(
            fits,
            code << jnp.clip(32 - s, 0, 31).astype(U32),
            code >> jnp.clip(s - 32, 0, 31).astype(U32),
        )
        lo = jnp.where(fits, jnp.uint32(0), code << jnp.clip(64 - s, 0, 31).astype(U32))
        acc_hi = acc_hi | hi
        acc_lo = acc_lo | lo

        emit = s >= 32
        word = acc_hi
        acc_hi = jnp.where(emit, acc_lo, acc_hi)
        acc_lo = jnp.where(emit, jnp.uint32(0), acc_lo)
        nbits = jnp.where(emit, s - 32, s)
        return (acc_hi, acc_lo, nbits), (word, emit)

    zero_u = jnp.zeros(lanes, U32)
    init = (zero_u, zero_u, jnp.zeros(lanes, jnp.int32))
    (acc_hi, _, nbits), (words, emitted) = jax.lax.scan(step, init, xs)
    return words.T, emitted.T, acc_hi, nbits


pack_blocks_jit = jax.jit(pack_blocks_scan)


def pack_blocks(blocks, valid, codetbl):
    """Pack every block with this backend's implementation: the kernel on
    the GPU, the XLA scan elsewhere (same outputs, bit for bit)."""
    from .kernels import pack_blocks_kernel, use_kernels

    if use_kernels():
        return pack_blocks_kernel(blocks, valid, codetbl)
    return pack_blocks_jit(blocks, valid, codetbl)


@jax.jit
def emitted_counts(emitted: jax.Array) -> jax.Array:
    """Per-lane emitted-word counts — the tiny (4 B/block) fetch that sizes
    the compact payload before :func:`compact_payload_device` traces."""
    return jnp.sum(emitted.astype(jnp.int32), axis=1)


CAP_ROUND = 64  # payload columns round up to this (bounds jit recompiles)


def payload_cap(max_count: int, steps: int) -> int:
    """Static payload width for compact_payload_device: covers every lane's
    words + the final partial word, rounded to CAP_ROUND columns."""
    return min(-(-(max_count + 2) // CAP_ROUND) * CAP_ROUND, steps + 2)


@partial(jax.jit, static_argnames=("cap",))
def compact_payload_device(words, emitted, acc, nbits, cap: int):
    """Device-side stream compaction of the dense emission slots.

    Replaces host compaction on the device/sharded encode paths so only
    ~compressed bytes cross D2H (and the network under multi-host) instead of the
    4 B-per-input-byte dense slots. The compaction is a per-lane stable
    SORT — emitted words get keys 0..count-1 (their compact position),
    holes sort to the back. The final partial word then lands at column
    ``count`` via a one-hot OR.

    Returns (payload uint32[lanes, cap], bit_lens int32[lanes]) — exactly
    the rows ``assemble_payloads`` builds on host. ``cap`` must exceed every
    lane's emitted count (size it with :func:`emitted_counts` +
    :func:`payload_cap`).
    """
    lanes, steps = words.shape
    e = emitted.astype(jnp.int32)
    cum = jnp.cumsum(e, axis=1)
    counts = cum[:, -1]
    iota = jnp.arange(steps, dtype=jnp.int32)[None, :]
    key = jnp.where(emitted, cum - 1, steps + iota)
    vals = jnp.where(emitted, jax.lax.bitcast_convert_type(words, jnp.int32), 0)
    _, sorted_vals = jax.lax.sort_key_val(key, vals, dimension=1)
    take = min(cap, steps)
    payload = sorted_vals[:, :take]
    if cap > steps:
        payload = jnp.pad(payload, ((0, 0), (0, cap - steps)))
    j = jnp.arange(cap, dtype=jnp.int32)[None, :]
    acc_i = jax.lax.bitcast_convert_type(acc, jnp.int32)
    payload = payload | jnp.where(j == counts[:, None], acc_i[:, None], 0)
    bit_lens = counts * 32 + nbits
    return jax.lax.bitcast_convert_type(payload, jnp.uint32), bit_lens


FLAT_ROUND = 4096  # flat payload words round up to this (16 KiB granularity)


def flat_cap(total_words: int, round_to: int = FLAT_ROUND) -> int:
    """Static flat-payload length covering ``total_words`` (= sum of every
    lane's emitted count + one partial word per lane)."""
    return max(round_to, -(-total_words // round_to) * round_to)


# Stage-1 subgroup width (slots); must divide the block size. The trade is
# U-shaped: narrow subgroups shrink the stage-1 sort but inflate stage 2's
# global grid (lanes*(G*cap_g+1) elements via per-subgroup cap slack).
# Chosen on the first target hardware; not yet measured on the H100
# (ROADMAP, Speed). Env knob for sweeps.
SUB_STEPS = int(os.environ.get("ENTREEPY_SUB_STEPS", "1024"))
CAP_G_ROUND = 16  # subgroup payload caps round up to this (bounds recompiles)


def sub_for(steps: int) -> int:
    """Stage-1 subgroup width for a ``steps``-slot dense grid: sort cost
    grows superlinearly with the sorted width, so the per-lane compaction
    runs on SUB_STEPS-slot subgroups whenever they tile."""
    return SUB_STEPS if steps % SUB_STEPS == 0 else steps


def grouped_counts(emitted: jax.Array) -> jax.Array:
    """Per-(lane, subgroup) emitted-word counts int32[lanes, G] — the tiny
    sizing fetch for :func:`compact_payload_flat`'s static subgroup cap."""
    lanes, steps = emitted.shape
    sub = sub_for(steps)
    return jnp.sum(emitted.reshape(lanes, steps // sub, sub).astype(jnp.int32), axis=2)


def payload_cap_g(max_g: int, steps: int) -> int:
    """Static subgroup payload width: covers the fullest subgroup, rounded
    to CAP_G_ROUND columns (the final partial word rides stage 2's extra
    per-lane slot, so no +1 here)."""
    sub = sub_for(steps)
    return min(-(-max(max_g, 1) // CAP_G_ROUND) * CAP_G_ROUND, sub)


@partial(jax.jit, static_argnames=("cap_g", "cap_total"))
def compact_payload_flat(words, emitted, acc, nbits, cap_g: int, cap_total: int):
    """Two-stage device compaction to ONE flat word stream.

    Stage 1: per-(lane, SUB_STEPS-slot subgroup) key-val sort packs emitted
    words to each subgroup's front -> [lanes, G, cap_g]. Subgrouping
    matters in both directions: narrow sorts are cheap (sort networks grow
    ~log^2(width)) but loose per-subgroup caps inflate stage 2's grid.
    Stage 2: a 1-D sort over the [lanes*(G*cap_g+1)] grid (one extra slot
    per lane carries the final partial word) packs every lane's live words
    into a single flat array in lane order — the fetched volume is the
    compressed stream + one rounding, independent of lane bucketing and
    subgroup cap slack.

    ``cap_g`` must cover the fullest subgroup (size with
    :func:`grouped_counts` + :func:`payload_cap_g`); if it does not, the
    returned ``bit_lens`` are poisoned to -1 so callers fail loudly rather
    than silently dropping words.

    Returns (flat uint32[cap_total], nwords int32[lanes] = count+1 per lane,
    bit_lens int32[lanes]). Lane l's words live at
    ``flat[sum(nwords[:l]) : sum(nwords[:l+1])]``.
    """
    lanes, steps = words.shape
    sub = sub_for(steps)
    g = steps // sub
    cg = min(cap_g, sub)
    w3 = jax.lax.bitcast_convert_type(words, jnp.int32).reshape(lanes, g, sub)
    e3 = emitted.reshape(lanes, g, sub)
    cum = jnp.cumsum(e3.astype(jnp.int32), axis=2)
    iota = jnp.arange(sub, dtype=jnp.int32)[None, None, :]
    key = jnp.where(e3, cum - 1, sub + iota)
    _, vs = jax.lax.sort_key_val(key, jnp.where(e3, w3, 0), dimension=2)
    pay = vs[:, :, :cg]  # [lanes, G, cap_g]
    counts_g = cum[:, :, -1]  # [lanes, G]
    counts = jnp.sum(counts_g, axis=1)  # [lanes]
    overflow = jnp.max(counts_g) > cg

    acc_col = jax.lax.bitcast_convert_type(acc, jnp.int32)[:, None]
    arr = jnp.concatenate([pay.reshape(lanes, g * cg), acc_col], axis=1)
    jj = jnp.arange(cg, dtype=jnp.int32)[None, None, :]
    live = jnp.concatenate(
        [
            (jj < counts_g[:, :, None]).reshape(lanes, g * cg),
            jnp.ones((lanes, 1), bool),
        ],
        axis=1,
    ).reshape(-1)
    n = lanes * (g * cg + 1)
    gcum = jnp.cumsum(live.astype(jnp.int32))
    gi = jnp.arange(n, dtype=jnp.int32)
    key2 = jnp.where(live, gcum - 1, n + gi)
    vals = jnp.where(live, arr.reshape(-1), 0)
    _, svals = jax.lax.sort_key_val(key2, vals)
    take = min(cap_total, n)
    flat = svals[:take]
    if cap_total > n:
        flat = jnp.pad(flat, (0, cap_total - n))
    nwords = counts + 1  # emitted count + the partial word
    bit_lens = jnp.where(overflow, -1, counts * 32 + nbits)
    return jax.lax.bitcast_convert_type(flat, jnp.uint32), nwords, bit_lens


# Plane-compaction subgroup width (slots): single-stage compaction packs
# live words per subgroup and the HOST slices live prefixes from the
# fetched plane (the decode-side plane trick) — no global stage-2 sort.
# Narrow subgroups cut per-subgroup work; wide ones cut cap slack (fetch
# inflation: ~1.7x at 256 on text). Chosen on the first target hardware;
# the sort's time on the H100 is in PERF.md.
PLANE_SUB = int(os.environ.get("ENTREEPY_PLANE_SUB", "256"))


def plane_sub_for(steps: int) -> int:
    return PLANE_SUB if steps % PLANE_SUB == 0 else steps


def grouped_counts_plane(emitted: jax.Array) -> jax.Array:
    """Per-(lane, plane-subgroup) emitted-word counts int32[lanes, G] — the
    tiny sizing fetch for :func:`compact_payload_plane`'s static cap."""
    lanes, steps = emitted.shape
    sub = plane_sub_for(steps)
    return jnp.sum(emitted.reshape(lanes, steps // sub, sub).astype(jnp.int32), axis=2)


def plane_cap_g(max_g: int, steps: int) -> int:
    """Static subgroup payload width for the plane compaction, rounded to
    CAP_G_ROUND columns (bounds jit recompiles)."""
    sub = plane_sub_for(steps)
    return min(-(-max(max_g, 1) // CAP_G_ROUND) * CAP_G_ROUND, sub)


@partial(jax.jit, static_argnames=("cap_g",))
def compact_payload_plane(words, emitted, acc, nbits, cap_g: int):
    """SINGLE-stage device compaction: per-(lane, PLANE_SUB-slot subgroup)
    key-val sort packs emitted words to each subgroup's front; the host
    fetches the [lanes, G*cap_g + 1] plane (the final partial word rides
    the last column) plus the tiny counts grid and concatenates live
    prefixes (:func:`assemble_plane_payload` — the decode-side plane
    trick). Skips :func:`compact_payload_flat`'s global stage-2 sort
    entirely; the fetch is ~cap_g/avg_subgroup_fill of the compressed size
    instead of exactly 1x (PLANE_SUB trades sort width against this
    slack).

    ``cap_g`` must cover the fullest subgroup (size with
    :func:`grouped_counts_plane` + :func:`plane_cap_g`); if it does not,
    ``bit_lens`` are poisoned to -1 (stitch_flat_payload raises).

    Reference counterpart: the serial bit-writer tail ``encode.zig:301-319``
    (the reference never compacts — it writes bits serially in place).

    Returns (plane uint32[lanes, G*cap_g + 1], counts_g int32[lanes, G],
    bit_lens int32[lanes]).
    """
    lanes, steps = words.shape
    sub = plane_sub_for(steps)
    g = steps // sub
    cg = min(cap_g, sub)
    w3 = jax.lax.bitcast_convert_type(words, jnp.int32).reshape(lanes, g, sub)
    e3 = emitted.reshape(lanes, g, sub)
    cum = jnp.cumsum(e3.astype(jnp.int32), axis=2)
    iota = jnp.arange(sub, dtype=jnp.int32)[None, None, :]
    key = jnp.where(e3, cum - 1, sub + iota)
    _, vs = jax.lax.sort_key_val(key, jnp.where(e3, w3, 0), dimension=2)
    pay = vs[:, :, :cg]  # [lanes, G, cap_g]
    counts_g = cum[:, :, -1]  # [lanes, G]
    counts = jnp.sum(counts_g, axis=1)
    overflow = jnp.max(counts_g) > cg
    acc_col = jax.lax.bitcast_convert_type(acc, jnp.int32)[:, None]
    plane = jnp.concatenate([pay.reshape(lanes, g * cg), acc_col], axis=1)
    bit_lens = jnp.where(overflow, -1, counts * 32 + nbits)
    return (
        jax.lax.bitcast_convert_type(plane, jnp.uint32),
        counts_g,
        bit_lens,
    )


def assemble_plane_payload(
    plane: np.ndarray, counts_g: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Host tail of :func:`compact_payload_plane`: slice each subgroup's
    live prefix (+ the per-lane final partial word) out of the fetched
    plane in one boolean extraction. Returns (flat uint32 — every block's
    words back to back, nwords int64[lanes] = count + 1) for
    ``stitch_flat_payload``."""
    lanes, g = counts_g.shape
    cap_g = (plane.shape[1] - 1) // g if g else 0
    jmask = (
        np.arange(cap_g, dtype=np.int64)[None, None, :]
        < counts_g[:, :, None]
    ).reshape(lanes, g * cap_g)
    mask = np.concatenate([jmask, np.ones((lanes, 1), bool)], axis=1)
    flat = np.ascontiguousarray(plane)[mask]  # row-major == (lane, subgroup, slot)
    nwords = counts_g.sum(axis=1).astype(np.int64) + 1
    return flat, nwords


def assemble_payloads(
    words: np.ndarray, emitted: np.ndarray, acc: np.ndarray, nbits: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Host compaction of the dense emission slots.

    Returns (payload uint32[lanes, cap_words] — each row the block's packed
    stream, bit_lens int64[lanes]). Dispatches to the C++ runtime
    (entreepy_tpu/runtime) when available, else vectorized numpy.
    """
    from .. import runtime

    native = runtime.assemble_payloads(words, emitted, acc, nbits)
    if native is not None:
        return native
    return _assemble_payloads_np(words, emitted, acc, nbits)


def _assemble_payloads_np(
    words: np.ndarray, emitted: np.ndarray, acc: np.ndarray, nbits: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    lanes, steps = emitted.shape
    counts = emitted.sum(axis=1).astype(np.int64)
    bit_lens = (counts * 32 + nbits).astype(np.int64)
    cap = int(counts.max()) + 1 if lanes else 1

    payload = np.zeros((lanes, cap), dtype=np.uint32)
    rows, _ = np.nonzero(emitted)
    starts = np.cumsum(counts) - counts
    within = np.arange(rows.size, dtype=np.int64) - starts[rows]
    payload[rows, within] = words[emitted]
    payload[np.arange(lanes), counts] = acc  # final partial word (nbits bits)
    return payload, bit_lens.astype(np.int64)
