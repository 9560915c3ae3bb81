"""Chunk-parallel Huffman decode, byte-granularity FSM (second generation).

Replaced the gen-1 nibble FSM scan (removed in 0.3 — see git history)
with half the sequential steps, ~10x less device->host traffic, and an
exact corrupt-stream error. The reference's serial hot loop is
``decode.zig:143-203`` (~0.44 MB/s); design here:

1. The body splits into fixed-size byte chunks; chunk := one vector lane.
   Byte columns come from a reshape — no gather/scatter on the input.
2. One FSM transition per lane is a lookup ``T[state, byte]``. On the GPU
   a hand-written kernel (ops/kernels.py) walks each lane's bytes with the
   state in a register and gathers from the table; the plain XLA twin
   (CPU meshes, tests) is a ``lax.scan`` whose step is the exact one-hot
   product ``onehot(byte) @ T^T`` ([lanes, 256] x [256, S] in bf16 — exact,
   every value <= 255) plus an S-wide one-hot row select.
3. Chunks after the first start mid-codeword with an unknown state. Prefix
   codes self-synchronize, so entry states are solved to a fixed point — but
   unlike the first-generation decoder, the initial guess comes from a cheap
   *suffix* sync pass (the last SYNC_WINDOW bytes of each chunk: the exit
   state only depends on the recent past once the chunk has locked on), so
   the typical total cost is ~1.15 passes instead of 3.
4. The host-expansion route outputs only the per-byte *state sequence*
   (uint8 per compressed byte). Symbols are reconstructed host-side with
   one vectorized ``syms[state, byte]`` lookup (C++ runtime
   et_fsm8_expand, numpy fallback), which also enforces the two decode
   invariants the first generation lacked on device:

   * no invalid transition is consumed before the symbol count is met
     ("invalid bitstream", matching the host LUT walk / native.cpp:93), and
   * the decoded symbols' code lengths sum to the body's exact bit count
     (+ <8 pad bits) — a truncated-but-plausible stream cannot validate.

   The on-device route (:func:`decode_body_device_full`, the GPU default)
   emits the symbols themselves from one fused pass and enforces the same
   invariants from per-lane metadata.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..format.etformat import parse_header
from ..format.fsm8 import ByteFsm, build_byte_fsm
from ..format.huffman import CodeTable
from .kernels import fsm_pass, fused_lookup, use_kernels

DEFAULT_CHUNK_BYTES = 512
# Suffix bytes per chunk for the entry-state first guess. ONE missed guess
# anywhere forces a whole extra fused pass over every lane (the fixed point
# re-runs full passes), so the window is sized for zero misses, not for
# minimal sync work: on the 5.2 MB text corpus w=64 missed exactly 1 of
# 5958 lanes while w=128 missed none.
SYNC_WINDOW = int(os.environ.get("ENTREEPY_SYNC_WINDOW", "128"))
MAX_SYNC_PASSES = 24
# Compaction subgroup width for on-device consumers of the symbol plane:
# narrow subgroups keep the per-subgroup sort small at the price of cap
# slack in the plane. Chosen on the first target hardware and not yet
# measured on the H100 (ROADMAP, Speed). Env knob for sweeps.
SUB_BYTES = int(os.environ.get("ENTREEPY_SUB_BYTES", "8"))
# Host-fetch consumers (sharded/multihost decode) keep wider subgroups: their
# symbol plane crosses D2H, so the per-subgroup cap slack is link
# bandwidth there, not just device memory (~1.15x fetch at 32 vs ~1.7x at
# 8 on text).
SUB_BYTES_FETCH = int(os.environ.get("ENTREEPY_SUB_BYTES_FETCH", "32"))
CAP_SYM_ROUND = 16  # per-subgroup symbol caps round up to this

# Counters for callers that must see which route ran: ``host_fallbacks``
# counts decodes whose chunk self-sync did not converge and that ran the
# exact serial host decoder instead (periodic streams can defeat self-sync;
# the fallback keeps them correct but off the device); ``decode_tiles``
# counts the tiles of the streaming decode.
stats = {"host_fallbacks": 0, "decode_tiles": 0}


def pass_impl() -> str:
    """Per-byte pass implementation for this backend: the hand-written
    kernels on the GPU, the XLA scans elsewhere. Tests also pass
    "interpret" (the kernels through the Pallas interpreter)."""
    return "kernel" if use_kernels() else "scan"


def host_fallback_decode(buf: np.ndarray, table: CodeTable,
                         n_symbols: int) -> np.ndarray:
    """Exact serial host decode of a body whose chunk self-sync did not
    converge (same exact-bit invariant as every other path)."""
    from .. import format as _fmt
    from ..format.hostcodec import _check_stream_bits

    stats["host_fallbacks"] += 1
    lut = _fmt.build_decode_lut(table)
    out = _fmt.unpack_body_host(buf.tobytes(), lut, n_symbols)
    _check_stream_bits(out, table.lengths, buf.size)
    return out


def bytes_to_cols(padded: np.ndarray, lanes: int, k: int) -> jax.Array:
    """uint8[lanes*k] -> int32[lanes, k] byte columns. The H2D transfer
    ships uint8 (1 B/byte); the widening cast runs on device."""
    return jnp.asarray(padded.reshape(lanes, k)).astype(jnp.int32)


def _table_T_bf16(fsm: ByteFsm) -> jax.Array:
    """bf16[256, S]: T^T so `onehot(byte) @ T^T` selects per-lane next-state
    rows (exact: every value <= 255)."""
    return jnp.asarray(fsm.sync_table().T, jnp.bfloat16)


def _scan_pass(cols_T, table_T, entries, emit: bool):
    """One full FSM pass over [K, lanes] byte columns from per-lane entry
    states. Returns (exits, states [K, lanes] pre-transition or None)."""
    s_iota = jnp.arange(table_T.shape[1], dtype=jnp.int32)

    def step(state, x):
        ohB = (x[:, None] == jnp.arange(256, dtype=jnp.int32)[None, :]).astype(
            jnp.bfloat16
        )
        rows = jnp.dot(ohB, table_T, preferred_element_type=jnp.float32)  # [lanes, S]
        sel = (state[:, None] == s_iota[None, :]).astype(jnp.float32)
        nxt = jnp.sum(rows * sel, axis=1).astype(jnp.int32)
        return nxt, state if emit else None

    exits, states = jax.lax.scan(step, entries, cols_T)
    return exits, states


def byte_rows(cols, impl: str):
    """int32[lanes, K] byte columns -> the [K, lanes] rows a pass walks
    (uint8 for the kernels, which read 1 B per byte)."""
    return cols.T if impl == "scan" else cols.T.astype(jnp.uint8)


def state_tables(table_T, impl: str):
    """Next-state table in the form the pass ``impl`` reads: the bf16
    [256, S] one-hot operand for the scans, int32[S*256] (index
    ``state*256 + byte``) for the kernels."""
    if impl == "scan":
        return table_T
    return table_T.T.astype(jnp.int32).reshape(-1)


def sync_exits(xs, tbl, k0: int, impl: str):
    """Exit states of a pass over bytes ``k0..K`` of every lane of ``xs``
    (:func:`byte_rows`), started at the root (the suffix sync)."""
    zeros = jnp.zeros(xs.shape[1], jnp.int32)
    if impl == "scan":
        return _scan_pass(xs[k0:], tbl, zeros, False)[0]
    return fsm_pass(xs, tbl, zeros, mode="sync", k_start=k0,
                    interpret=impl == "interpret")


def state_pass(xs, tbl, entries, impl: str):
    """Full pass from ``entries`` -> (exits int32[lanes], pre-transition
    states uint8[K, lanes])."""
    if impl == "scan":
        exits, states = _scan_pass(xs, tbl, entries, True)
        return exits, states.astype(jnp.uint8)
    states, exits = fsm_pass(xs, tbl, entries, mode="states",
                             interpret=impl == "interpret")
    return exits, states


@partial(jax.jit, static_argnames=("max_passes", "impl"))
def fsm8_decode(cols, table_T, n_real_lanes, max_passes: int = MAX_SYNC_PASSES,
                impl: str = "scan"):
    """Decode all chunks -> (states uint8[lanes, K] pre-transition state per
    byte, unconverged bool).

    cols: int32[lanes, K]; table_T: bf16[256, S]; n_real_lanes: i32 scalar —
    lanes beyond it are padding, excluded from the fixed-point test.
    """
    lanes, k = cols.shape
    xs = byte_rows(cols, impl)  # [K, lanes]
    tbl = state_tables(table_T, impl)
    real = jnp.arange(lanes, dtype=jnp.int32) < n_real_lanes

    # Entry-state first guess: sync only each chunk's suffix from the root —
    # the exit state forgets the entry within a few codewords.
    suffix_exits = sync_exits(xs, tbl, k - min(SYNC_WINDOW, k), impl)
    entries0 = jnp.concatenate([jnp.zeros(1, jnp.int32), suffix_exits[:-1]])

    # Full passes to the fixed point (entries[0] = root is forced, so any
    # fixed point is the exact solution by induction along the chain).
    def cond(c):
        entries, prev, _, it = c
        return jnp.logical_and(
            it < max_passes, jnp.any(jnp.logical_and(entries != prev, real))
        )

    def body(c):
        entries, _, _, it = c
        exits, states = state_pass(xs, tbl, entries, impl)
        new_entries = jnp.concatenate([jnp.zeros(1, jnp.int32), exits[:-1]])
        return new_entries, entries, states, it + 1

    states0 = jnp.zeros((k, lanes), jnp.uint8)
    entries, prev, states, _ = jax.lax.while_loop(
        cond, body, (entries0, entries0 - 1, states0, jnp.int32(0))
    )
    unconverged = jnp.any(jnp.logical_and(entries != prev, real))
    return states.T, unconverged


def expand_states(
    states: np.ndarray,
    body: np.ndarray,
    fsm: ByteFsm,
    n_symbols: int,
) -> np.ndarray:
    """(per-byte pre-states, body bytes) -> uint8[n_symbols] in stream order.

    Dispatches to the C++ runtime when available, else vectorized numpy.
    Raises on invalid transitions, early stream end, and on the exact-bit
    invariant: sum(code lengths of output) must land in the body's final
    byte (i.e. the stream is neither truncated nor over-long).
    """
    from .. import runtime
    from ..format.hostcodec import _check_end_byte

    n = body.size
    st = np.ascontiguousarray(states.reshape(-1)[:n], dtype=np.uint8)

    res = runtime.fsm8_expand(st, body, fsm.counts, fsm.syms, n_symbols)
    if res is not None:
        out, end_byte = res
    else:
        cnt = fsm.counts[st, body].astype(np.int64)  # [n], -1 invalid
        cum = np.cumsum(np.maximum(cnt, 0))
        done = int(np.searchsorted(cum, n_symbols, side="left"))
        if done >= n or cum[done] < n_symbols:
            raise ValueError(
                f"bitstream ended early: decoded {int(cum[-1]) if n else 0} "
                f"of {n_symbols} symbols"
            )
        if (cnt[: done + 1] < 0).any():
            raise ValueError("invalid bitstream: unreachable trie edge")
        sy = fsm.syms[st[: done + 1], body[: done + 1]]  # [m, 8]
        mask = np.arange(8, dtype=np.int64)[None, :] < cnt[: done + 1, None]
        out = sy[mask][:n_symbols]
        end_byte = done

    # Exact-bit invariant: the n_symbols-th symbol must complete in the
    # final body byte (= the code lengths account for every bit except the
    # final byte's zero padding).
    _check_end_byte(end_byte, n, n_symbols)
    return out


def decode_body_device(
    body: bytes | np.ndarray,
    table: CodeTable,
    n_symbols: int,
    *,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    fsm: ByteFsm | None = None,
) -> np.ndarray:
    """Decode a packed body with ``table`` -> uint8[n_symbols] (host array)."""
    if n_symbols == 0:
        return np.zeros(0, dtype=np.uint8)
    from ..utils.trace import phase

    fsm = fsm or build_byte_fsm(table)
    buf = (
        np.frombuffer(body, dtype=np.uint8)
        if isinstance(body, (bytes, bytearray, memoryview))
        else np.asarray(body, dtype=np.uint8)
    )

    lanes = max(1, -(-buf.size // chunk_bytes))
    padded = np.zeros(lanes * chunk_bytes, dtype=np.uint8)
    padded[: buf.size] = buf
    with phase("device_fsm8_decode", n_symbols):
        cols = bytes_to_cols(padded, lanes, chunk_bytes)
        states, unconverged = fsm8_decode(
            cols, _table_T_bf16(fsm), jnp.int32(lanes), impl=pass_impl()
        )
    if bool(unconverged):
        return host_fallback_decode(buf, table, n_symbols)
    with phase("device_fetch_expand", n_symbols):
        return expand_states(np.asarray(states), buf, fsm, n_symbols)


def validate_chunk_meta(counts: np.ndarray, w_inv: np.ndarray, n_symbols: int) -> None:
    """Serial-exact accept/reject from per-chunk metadata: ``counts[c]`` =
    symbols chunk c emits, ``w_inv[c]`` = symbols emitted before chunk c's
    FIRST invalid transition (-1 if none). An invalid transition raises iff
    it is consumed — i.e. lies at-or-before the byte where the n_symbols-th
    symbol completes — matching :func:`expand_states` / the serial walk."""
    total = int(counts.sum())
    if total < n_symbols:
        raise ValueError(
            f"bitstream ended early: decoded {total} of {n_symbols} symbols"
        )
    starts = np.cumsum(counts) - counts
    if bool(((w_inv >= 0) & (starts + w_inv < n_symbols)).any()):
        raise ValueError("invalid bitstream: unreachable trie edge")


@partial(jax.jit, static_argnames=("m",))
def _expand_scan(cols, states, t_exp, m: int):
    """XLA-scan expand (CPU meshes / fallback): see expand_pass_device."""
    lanes, k = cols.shape
    s = t_exp.shape[1] // (m + 1)
    s_iota = jnp.arange(s, dtype=jnp.int32)
    b_iota = jnp.arange(256, dtype=jnp.int32)

    def step(_, x):
        byte, st = x  # [lanes] each
        oh_b = (byte[:, None] == b_iota[None, :]).astype(jnp.bfloat16)
        tmp = jnp.dot(oh_b, t_exp, preferred_element_type=jnp.float32)
        mask = (st[:, None] == s_iota[None, :]).astype(jnp.float32)
        vals = jnp.sum(tmp.reshape(lanes, m + 1, s) * mask[:, None, :], axis=2)
        return None, vals  # [lanes, m+1]

    _, vals = jax.lax.scan(step, None, (cols.T, states.T.astype(jnp.int32)))
    raw = vals[..., 0].astype(jnp.int32)  # [K, lanes]
    syms = vals[..., 1:].transpose(0, 2, 1).astype(jnp.uint8)  # [K, m, lanes]
    return raw, syms


@partial(jax.jit, static_argnames=("m",))
def _expand_mask(raw, syms, n_valid, m: int, pos0=0):
    """Shared tail: apply the real-byte mask and unpack count|invalid.
    ``pos0`` offsets the absolute byte positions (sharded callers pass the
    shard's global start so padding past ``n_valid`` masks correctly)."""
    k, lanes = raw.shape
    pos = pos0 + jnp.arange(lanes, dtype=jnp.int32)[None, :] * k + jnp.arange(
        k, dtype=jnp.int32
    )[:, None]
    real = pos < n_valid
    counts = jnp.where(real, raw & 15, 0)
    inv = jnp.logical_and(real, raw >= 16)
    return counts, inv, syms


@partial(jax.jit, static_argnames=("m", "mt"))
def _expand_scan_split(cols, states, t_split, m: int, mt: int):
    """XLA-scan split-table expand (``ENTREEPY_EXPAND=split``): same
    (raw, syms) outputs as :func:`_expand_scan`."""
    lanes, k = cols.shape
    n_p = 9
    s = (t_split.shape[1] - n_p * (mt + 1)) // 2
    s_iota = jnp.arange(s, dtype=jnp.int32)
    b_iota = jnp.arange(256, dtype=jnp.int32)
    p_iota = jnp.arange(n_p, dtype=jnp.int32)

    def step(_, x):
        byte, st = x  # [lanes] each
        oh_b = (byte[:, None] == b_iota[None, :]).astype(jnp.bfloat16)
        tmp = jnp.dot(oh_b, t_split, preferred_element_type=jnp.float32)
        mask = (st[:, None] == s_iota[None, :]).astype(jnp.float32)
        fs = jnp.sum(tmp[:, :s] * mask, axis=1).astype(jnp.int32)
        pv = jnp.sum(tmp[:, s : 2 * s] * mask, axis=1).astype(jnp.int32)
        p = pv & 15
        mask_p = (p[:, None] == p_iota[None, :]).astype(jnp.float32)
        tail = tmp[:, 2 * s :].reshape(lanes, mt + 1, n_p)
        tvals = jnp.sum(tail * mask_p[:, None, :], axis=2).astype(jnp.int32)
        tc = tvals[:, 0]
        inv = (pv >= 16) | (tc >= 16)
        count = (p > 0).astype(jnp.int32) + (tc & 15)
        raw = jnp.where(inv, 16, count)
        slots = [fs] + [tvals[:, 1 + j] for j in range(m - 1)]
        return None, (raw, jnp.stack(slots, axis=0))  # [lanes], [m, lanes]

    _, (raw, syms) = jax.lax.scan(step, None, (cols.T, states.T.astype(jnp.int32)))
    return raw, syms.astype(jnp.uint8)  # [K, lanes], [K, m, lanes]


@partial(jax.jit, static_argnames=("m", "mt", "s"))
def _fused_scan_pass(cols_T, t_fused, entries, m: int, mt: int, s: int):
    """XLA-scan twin of the one-pass kernel (``fsm_pass`` mode "rows"): one
    [lanes, 2s+9(mt+2)] contraction per byte drives the state chain and the
    symbol emission together. Returns (raw [K, lanes], syms uint8[K, m,
    lanes], exits [lanes])."""
    lanes = cols_T.shape[1]
    n_p = 9
    s_iota = jnp.arange(s, dtype=jnp.int32)
    b_iota = jnp.arange(256, dtype=jnp.int32)
    p_iota = jnp.arange(n_p, dtype=jnp.int32)

    def step(state, byte):
        oh_b = (byte[:, None] == b_iota[None, :]).astype(jnp.bfloat16)
        tmp = jnp.dot(oh_b, t_fused, preferred_element_type=jnp.float32)
        mask = (state[:, None] == s_iota[None, :]).astype(jnp.float32)
        mg = jnp.sum(tmp[:, :s] * mask, axis=1).astype(jnp.int32)
        pv = jnp.sum(tmp[:, s : 2 * s] * mask, axis=1).astype(jnp.int32)
        p = pv & 15
        mask_p = (p[:, None] == p_iota[None, :]).astype(jnp.float32)
        tail = tmp[:, 2 * s :].reshape(lanes, mt + 2, n_p)
        tvals = jnp.sum(tail * mask_p[:, None, :], axis=2).astype(jnp.int32)
        tcv = tvals[:, 0]
        inv = (pv >= 16) | ((p > 0) & (tcv >= 16))
        count = (p > 0).astype(jnp.int32) + (tcv & 15)
        raw = jnp.where(inv, 16, count)
        slots = [mg] + [tvals[:, 1 + j] for j in range(m - 1)]
        tend = tvals[:, mt + 1]
        nxt = jnp.where(p > 0, tend, mg)
        return nxt, (raw, jnp.stack(slots, axis=0))

    exits, (raw, syms) = jax.lax.scan(step, entries, cols_T)
    return raw, syms.astype(jnp.uint8), exits  # [K, lanes], [K, m, lanes]


def unpack_fused_rows(words, m: int):
    """Inverse of :func:`pack_fused_rows_masked` -> (raw [K, lanes], syms
    uint8[K, m, lanes]). Pure elementwise shifts — XLA fuses these into
    whatever consumes them."""
    raw = jax.lax.shift_right_logical(words, 8 * m)
    syms = jnp.stack(
        [
            (jax.lax.shift_right_logical(words, 8 * (m - 1 - j)) & 255).astype(
                jnp.uint8
            )
            for j in range(m)
        ],
        axis=1,
    )
    return raw, syms


def pack_fused_rows_masked(raw, syms, n_valid, m: int):
    """Scan twin of the kernel's in-kernel count mask: pack (raw [K, lanes],
    syms [K, m, lanes]) into one int32 word per byte whose count byte is
    zeroed at lane-linear positions >= ``n_valid`` (padding) — bit-identical
    to the packed rows of ``fsm_pass`` mode "rows". Symbol slot bytes ride
    verbatim (dead slots carry table garbage; every consumer gates on the
    count byte)."""
    k, lanes = raw.shape
    pos = jnp.arange(lanes, dtype=jnp.int32)[None, :] * k + jnp.arange(
        k, dtype=jnp.int32
    )[:, None]
    word = jnp.where(pos < n_valid, raw, 0) << (8 * m)
    for j in range(m):
        word = word | (syms[:, j, :].astype(jnp.int32) << (8 * (m - 1 - j)))
    return word


def fused_tables(t_fused, m: int, mt: int, s: int, packed: bool, impl: str):
    """One-pass decode table in the form the pass ``impl`` reads: the bf16
    one-hot operand for the scans, (next-state, rows) lookups for the
    kernels (``kernels.fused_lookup``)."""
    if impl == "scan":
        return t_fused
    return fused_lookup(t_fused, m, mt, s, packed)


def fused_pass(xs, tbl, entries, m: int, mt: int, s: int, packed: bool,
               n_valid, impl: str):
    """One full one-pass sweep from ``entries`` -> (exits int32[lanes],
    vals): int32[K, m+1, lanes] rows (raw, then the m symbol slots), or the
    MASKED one-word rows [K, lanes] when ``packed``."""
    if impl == "scan":
        raw, syms, exits = _fused_scan_pass(xs, tbl, entries, m, mt, s)
        if packed:
            return exits, pack_fused_rows_masked(raw, syms, n_valid, m)
        return exits, jnp.concatenate(
            [raw[:, None, :], syms.astype(jnp.int32)], axis=1
        )
    nxt, rows = tbl
    vals, exits = fsm_pass(
        xs, nxt, entries, rows, n_valid, mode="rows",
        mask_shift=8 * m if packed else 0, interpret=impl == "interpret",
    )
    return exits, vals[:, 0, :] if packed else vals


@partial(jax.jit, static_argnames=("m", "mt", "s", "packed", "max_passes",
                                   "impl"))
def fsm8_decode_fused(cols, table_T, t_fused, n_real_lanes, m: int, mt: int,
                      s: int, packed: bool = False,
                      max_passes: int = MAX_SYNC_PASSES, entry0=None,
                      n_valid=None, impl: str = "scan"):
    """One-pass decode: cols int32[lanes, K] -> (vals int32[K, m+1, lanes]
    packed rows — or [K, lanes] MASKED one-word rows when ``packed``
    (``n_valid`` required) — exits int32[lanes], unconverged). ``entry0``
    pins the first lane's entry state (default 0 = stream start; body tiles
    chain the previous tile's last exit here). ``impl`` picks the per-byte
    passes (:func:`pass_impl`)."""
    lanes, k = cols.shape
    if packed and (n_valid is None or m > 3):
        raise ValueError(f"packed fused rows need m <= 3 (m={m}) and n_valid")
    xs = byte_rows(cols, impl)
    ftbl = fused_tables(t_fused, m, mt, s, packed, impl)
    real = jnp.arange(lanes, dtype=jnp.int32) < n_real_lanes
    e0 = jnp.zeros(1, jnp.int32) if entry0 is None else jnp.reshape(
        entry0, (1,)
    ).astype(jnp.int32)

    suffix_exits = sync_exits(
        xs, state_tables(table_T, impl), k - min(SYNC_WINDOW, k), impl
    )
    entries0 = jnp.concatenate([e0, suffix_exits[:-1]])

    def cond(c):
        entries, prev, _, _, it = c
        return jnp.logical_and(
            it < max_passes, jnp.any(jnp.logical_and(entries != prev, real))
        )

    def body(c):
        entries, _, _, _, it = c
        exits, vals = fused_pass(xs, ftbl, entries, m, mt, s, packed, n_valid,
                                 impl)
        new_entries = jnp.concatenate([e0, exits[:-1]])
        return new_entries, entries, vals, exits, it + 1

    vals0 = jnp.zeros((k, lanes) if packed else (k, m + 1, lanes), jnp.int32)
    exits0 = jnp.zeros(lanes, jnp.int32)
    entries, prev, vals, exits, _ = jax.lax.while_loop(
        cond, body, (entries0, entries0 - 1, vals0, exits0, jnp.int32(0))
    )
    unconverged = jnp.any(jnp.logical_and(entries != prev, real))
    return vals, exits, unconverged


def build_fused(fsm: ByteFsm):
    """One-pass decode table -> (table bf16, m, mt, s). See
    ``format.fsm8.fused_decode_tensors``."""
    from ..format.fsm8 import fused_decode_tensors

    t, m, mt, s = fused_decode_tensors(fsm)
    return jnp.asarray(t, jnp.bfloat16), m, mt, s


def run_fused_decode(cols, table_T, t_fused, n_real_lanes, m: int, mt: int,
                     s: int, packed: bool = False, entry0=None,
                     n_valid=None):
    """:func:`fsm8_decode_fused` with the passes of this backend
    (:func:`pass_impl`). Returns (vals int32[K, m+1, lanes] — MASKED
    [K, lanes] words when ``packed``, which requires ``n_valid`` — exits
    int32[lanes], unconverged)."""
    return fsm8_decode_fused(cols, table_T, t_fused, n_real_lanes, m, mt, s,
                             packed=packed, entry0=entry0, n_valid=n_valid,
                             impl=pass_impl())


def _sub_width(k: int, sub: int | None) -> int:
    """Resolve a compaction subgroup width: explicit ``sub`` (host-fetch
    callers pass SUB_BYTES_FETCH), else the on-device SUB_BYTES default;
    either falls back to the whole chunk when it doesn't tile."""
    s = sub if sub else SUB_BYTES
    return s if k % s == 0 else k


def packed_counts_inv(words, m: int):
    """counts int32[K, lanes] and inv bool[K, lanes] straight off MASKED
    packed fused words (``word >> 8m`` is 0 for padding bytes, 16 for
    invalid transitions, the symbol count otherwise) — no unpack, no
    position grid, no re-mask."""
    raw = jax.lax.shift_right_logical(words, 8 * m)
    return raw & 15, raw >= 16


@partial(jax.jit, static_argnames=("m", "sub"))
def packed_mini_totals(words, m: int, sub: int | None = None):
    """Per-(subgroup, lane) symbol totals straight from MASKED packed fused
    words (the :func:`sym_cap` sizing reduce without materializing counts
    in HBM). Returns int32[Gs, lanes]."""
    k, lanes = words.shape
    counts, _ = packed_counts_inv(words, m)
    sb = _sub_width(k, sub)
    return jnp.sum(counts.reshape(k // sb, sb, lanes), axis=1)


@partial(jax.jit, static_argnames=("m", "cap_sym", "sub"))
def compact_symbols_packed(words, m: int, cap_sym: int,
                           sub: int | None = None):
    """MASKED packed fused words -> compacted symbol plane via the
    per-subgroup sort of :func:`compact_symbols_device` (the host-fetch /
    multi-host layout: cap slack there is link bandwidth, so subgroups
    stay wide — on-device consumers use :func:`compact_symbols_dense`
    instead). Same returns as :func:`compact_symbols_device`."""
    counts, inv = packed_counts_inv(words, m)
    _, syms = unpack_fused_rows(words, m)
    return compact_symbols_device(counts, inv, syms, m, cap_sym, sub=sub)


def _masked_meta(counts, inv):
    """Per-lane (lane_tot, w_inv) from per-byte counts/inv WITHOUT a
    K-long cumsum: two-level hierarchical prefix (a flat ``jnp.cumsum``
    over [512, lanes] once cost more than the whole fused pass; not yet
    re-measured on the H100). w_inv = symbols emitted before the lane's first invalid byte,
    1 << 30 when none (:func:`validate_chunk_meta`'s sentinel)."""
    k, lanes = counts.shape
    g2 = 8 if k % 8 == 0 else 1
    c3 = counts.reshape(k // g2, g2, lanes)
    cums = jnp.cumsum(c3, axis=1) - c3
    mini = cums[:, -1, :] + c3[:, -1, :]
    g_start = jnp.cumsum(mini, axis=0) - mini
    lane_tot = g_start[-1] + mini[-1]
    big = jnp.int32(1 << 30)
    inv3 = inv.reshape(k // g2, g2, lanes)
    w_inv = jnp.where(inv3, g_start[:, None, :] + cums, big).min(axis=(0, 1))
    return lane_tot, w_inv


@partial(jax.jit, static_argnames=("m",))
def compact_symbols_dense(words, m: int):
    """MASKED packed fused words -> the DENSE symbol plane: row ``k*m + j``
    of the plane is byte ``m-1-j`` of word ``k`` verbatim, mini_tot is the
    per-byte count — i.e. subgroup width 1, cap = m, and NO reorder at all.
    Dead slots carry table garbage; every consumer (extraction, checksum)
    gates on mini_tot, so nothing ever reads them. This is the on-device
    consumer's default: the per-subgroup sort exists to cut plane slack
    for host fetches, but on the 5.2 MB text corpus the swept cap equals
    the full subgroup anyway (zero slack saved). Returns (plane uint8[K*m, lanes],
    mini_tot int32[K, lanes], lane_tot int32[lanes], w_inv int32[lanes],
    1 << 30 = none)."""
    k, lanes = words.shape
    counts, inv = packed_counts_inv(words, m)
    plane = jnp.stack(
        [
            (jax.lax.shift_right_logical(words, 8 * (m - 1 - j)) & 255).astype(
                jnp.uint8
            )
            for j in range(m)
        ],
        axis=1,
    ).reshape(k * m, lanes)
    lane_tot, w_inv = _masked_meta(counts, inv)
    return plane, counts, lane_tot, w_inv


def expand_pass_split(cols, states, t_split, n_valid, m: int, mt: int, pos0=0):
    """Split-table variant of :func:`expand_pass_device` (same outputs):
    ``2S + 9(mt+1)``-wide contraction instead of ``(m+1)S`` — see
    ``format.fsm8.split_expand_tensors`` for the decomposition."""
    raw, syms = _expand_scan_split(cols, states, t_split, m, mt)
    return _expand_mask(raw, syms, n_valid, m, pos0)


def build_expand(fsm: ByteFsm):
    """Expand tables for the current mode -> (table bf16, m, mt).
    ``mt`` is None in fused mode (ENTREEPY_EXPAND=fused; default split,
    the narrower table)."""
    from ..format.fsm8 import expand_tensors, split_expand_tensors

    if os.environ.get("ENTREEPY_EXPAND") == "fused":
        t, m = expand_tensors(fsm)
        return jnp.asarray(t, jnp.bfloat16), m, None
    t, m, mt = split_expand_tensors(fsm)
    return jnp.asarray(t, jnp.bfloat16), m, mt


def run_expand(cols, states, t, n_valid, m: int, mt, pos0=0):
    """Dispatch on the :func:`build_expand` table kind."""
    if mt is None:
        return expand_pass_device(cols, states, t, n_valid, m, pos0)
    return expand_pass_split(cols, states, t, n_valid, m, mt, pos0)


def expand_pass_device(cols, states, t_exp, n_valid, m: int, pos0=0):
    """Per-byte symbol emission ON DEVICE (no serial chain: states are the
    decode passes' precomputed output, so every byte's lookup is
    independent). XLA scan; the two-pass route behind the one-pass
    default.

    cols/states: int32/uint8[lanes, K]; t_exp: bf16[256, (m+1)*S] from
    ``format.fsm8.expand_tensors`` (block 0 packs count + 16*invalid);
    n_valid: total real body bytes. Returns (counts int32[K, lanes], inv
    bool[K, lanes], syms uint8[K, m, lanes] — byte-major, slot, lane) —
    dense slots, compacted by :func:`compact_symbols_device`.
    """
    raw, syms = _expand_scan(cols, states, t_exp, m)
    return _expand_mask(raw, syms, n_valid, m, pos0)


@partial(jax.jit, static_argnames=("m", "cap_sym", "sub"))
def compact_symbols_device(counts, inv, syms, m: int, cap_sym: int,
                           sub: int | None = None):
    """Dense per-byte symbol slots -> per-lane compacted symbol columns.

    One per-lane sort packs each lane's symbols to the column front
    (keys = per-lane stream position). Everything stays in the expand
    pass's [K*, lanes] layout
    — keys build contiguously and the sort runs along dim 0, so no
    multi-MB transposes enter the pipeline. The lanes are NOT flattened
    into one stream on device — a measured global 1-D sort over the
    ~n_symbols grid cost more than the whole FSM decode — the host fetches
    [cap_sym, lanes] (~cap_sym/avg of the output bytes: ~1.7x at the
    SUB_BYTES=8 default, ~1.15x at 32 — see the SUB_BYTES note) and
    concatenates the live column prefixes. Also returns per-lane totals
    and first-invalid offsets for :func:`validate_chunk_meta`.

    The sort runs per SUB_BYTES-byte SUBGROUP of each chunk (sorting-network
    cost grows ~log^2 of the sorted width), so ``cap_sym`` is a per-subgroup cap and the plane is a grid of
    mini-lane segments: row ``g*cap_sym+j`` of column ``l`` is slot ``j``
    of subgroup ``g`` of lane ``l``. Stream order = lane-major, then
    subgroup, then slot.

    counts/inv: int32/bool[K, lanes]; syms: uint8[K, m, lanes].
    Returns (plane uint8[Gs*cap_sym, lanes], mini_tot int32[Gs, lanes],
    lane_tot int32[lanes], w_inv int32[lanes], 1<<30 = none).
    """
    k, lanes = counts.shape
    sb = _sub_width(k, sub)
    gs = k // sb
    sg = sb * m  # slots per subgroup
    if sg >= 1 << 22:
        # subgroup positions must survive the << 8 pack without touching
        # the sign bit
        raise ValueError(f"sub_bytes*m = {sg} exceeds the 2^22 sort bound")
    c3 = counts.reshape(gs, sb, lanes)
    cums = jnp.cumsum(c3, axis=1) - c3  # symbols before byte, per subgroup
    mini_tot = cums[:, -1, :] + c3[:, -1, :]  # [Gs, lanes]
    # lane totals + first-invalid offsets from the subgroup hierarchy (no
    # flat K-long cumsum, see _masked_meta)
    big = jnp.int32(1 << 30)
    g_start = jnp.cumsum(mini_tot, axis=0) - mini_tot  # [Gs, lanes]
    lane_tot = g_start[-1] + mini_tot[-1]
    inv3 = inv.reshape(gs, sb, lanes)
    w_inv = jnp.where(inv3, g_start[:, None, :] + cums, big).min(axis=(0, 1))

    cap_g = min(cap_sym, sg)
    # ONE word per slot — (position << 8) | symbol — so the sort moves half
    # the bytes a (key, value) pair sort would; dead slots carry position
    # ``sg`` (> every live position) and sink to the bottom of their
    # subgroup. int16 when the packed value fits (sg <= 127 — the default
    # sb=32/m<=3 gives sg=96): halves the sorted bytes again.
    j = jnp.arange(m, dtype=jnp.int32)[None, None, :, None]
    pos = jnp.where(
        j < c3[:, :, None, :], cums[:, :, None, :] + j, sg
    )  # [Gs, sb, m, lanes]
    pos = pos.reshape(gs, sg, lanes)
    packed = (pos << 8) | jnp.where(
        pos < sg, syms.reshape(gs, sg, lanes).astype(jnp.int32), 0
    )
    if sg <= 127:  # sg << 8 | sym fits int16's positive range
        packed = packed.astype(jnp.int16)
    sv = jnp.sort(packed, axis=1).astype(jnp.int32)
    plane = (sv[:, :cap_g, :] & 255).astype(jnp.uint8)
    if cap_sym > sg:
        plane = jnp.pad(plane, ((0, 0), (0, cap_sym - sg), (0, 0)))
    # An under-sized static cap would silently truncate a subgroup; poison
    # lane_tot so validate_chunk_meta rejects loudly instead. (Callers size
    # cap_sym from the fetched mini-total max, so this cannot fire there.)
    overflow = jnp.max(mini_tot) > cap_g
    lane_tot = jnp.where(overflow, -1, lane_tot)
    return plane.reshape(gs * cap_sym, lanes), mini_tot, lane_tot, w_inv


def sym_cap(counts, m: int, sub: int | None = None):
    """Static per-subgroup symbol cap for :func:`compact_symbols_device`:
    fetches the subgroup totals' max (tiny) and rounds to CAP_SYM_ROUND
    columns (bounds jit recompiles). The subgroup width is derived from
    ``counts.shape[0]`` (the chunk size), same as the compaction itself."""
    k = counts.shape[0]
    sb = _sub_width(k, sub)
    mini = jnp.sum(counts.reshape(k // sb, sb, counts.shape[1]), axis=1)
    mx = max(int(jnp.max(mini)), 1)
    return min(-(-mx // CAP_SYM_ROUND) * CAP_SYM_ROUND, sb * m)


def packed_sym_cap(mini, m: int, k: int, sub: int | None = None) -> int:
    """Static per-subgroup symbol cap from :func:`packed_mini_totals` output
    (the packed-mode twin of :func:`sym_cap`, shared by every packed call
    site so the cap rule lives in one place): fetches the mini-total max
    (tiny) and rounds to CAP_SYM_ROUND columns (bounds jit recompiles)."""
    sb = _sub_width(k, sub)
    mx = max(int(jnp.max(mini)), 1)
    return min(-(-mx // CAP_SYM_ROUND) * CAP_SYM_ROUND, sb * m)


def extract_plane_symbols(plane, mini_tot) -> np.ndarray:
    """Compacted symbol plane -> flat uint8 symbols in (lane, subgroup,
    slot) stream order. Boolean extraction flattens row-major — exactly
    stream order, all in C (no per-lane python loop)."""
    mt = np.asarray(mini_tot, dtype=np.int64)  # [Gs, lanes]
    gs, lanes = mt.shape
    plane_np = np.asarray(plane).reshape(gs, -1, lanes)  # [Gs, cap_g, lanes]
    cap_g = plane_np.shape[1]
    arr = plane_np.transpose(2, 0, 1)  # [lanes, Gs, cap_g]
    mask = np.arange(cap_g, dtype=np.int64)[None, None, :] < mt.T[:, :, None]
    return arr[mask]


def plane_checksum(plane, mini_tot, lane_tot, cap_sym: int, n_sym: int,
                   start=0):
    """Position-weighted checksum of a compacted symbol plane's live prefix
    (jittable; int32 wrapping — compare modulo 2^32). The device-side
    verification primitive the benches sync on instead of fetching the
    decoded bytes (through a slow link the fetch would swamp compute;
    correctness is pinned by comparing against :func:`plane_checksum_host`
    on the source bytes). ``start`` is the plane's global symbol offset
    (tiled callers pass the tile's start so the trailing padding-derived
    symbol masks out); positions in the XOR stay plane-LOCAL on both sides.
    Returns (checksum, total live symbols incl. any trailing extra)."""
    gs = mini_tot.shape[0]
    pl3 = plane.reshape(gs, cap_sym, -1)
    lane_start = (jnp.cumsum(lane_tot) - lane_tot)[None, None, :]
    if gs % 8 == 0:
        # two-level exclusive prefix: the dense plane's gs = K makes a flat
        # cumsum here as costly as the K-long one _masked_meta avoids
        m3 = mini_tot.reshape(gs // 8, 8, -1)
        inner = jnp.cumsum(m3, axis=1) - m3
        outer_tot = inner[:, -1, :] + m3[:, -1, :]
        outer = jnp.cumsum(outer_tot, axis=0) - outer_tot
        mini_start = (outer[:, None, :] + inner).reshape(gs, 1, -1)
    else:
        mini_start = (jnp.cumsum(mini_tot, axis=0) - mini_tot)[:, None, :]
    j = jnp.arange(cap_sym, dtype=jnp.int32)[None, :, None]
    pos_l = lane_start + mini_start + j  # plane-local symbol order
    live = (
        (j < mini_tot[:, None, :]) & (start + pos_l < n_sym)
    ).astype(jnp.int32)
    chk = jnp.sum((pl3.astype(jnp.int32) ^ (pos_l & 0xFF)) * live)
    return chk, jnp.sum(lane_tot)


def plane_checksum_host(data: np.ndarray, start: int, tot: int,
                        n_sym: int) -> int:
    """Expected value of :func:`plane_checksum` over the source bytes:
    ``data[start : min(start+tot, n_sym)]`` XORed with plane-local
    positions. Compare modulo 2^32 (the device accumulates in int32)."""
    seg = data[start: min(start + tot, n_sym)].astype(np.int64)
    return int(np.sum(seg ^ (np.arange(seg.size) & 0xFF)))


def assemble_symbol_planes(
    planes, minis, lane_tots, w_invs, n_symbols, table, n_body
) -> np.ndarray:
    """Fetch + validate + concatenate compacted symbol planes (the shared
    tail of every on-device expansion path; the streaming tiled decode
    passes one list entry per tile, untiled paths a singleton): applies the
    serial-exact accept/reject (:func:`validate_chunk_meta`) over the
    concatenated per-lane metadata, slices each mini-lane's live segment
    prefix in (lane, subgroup) stream order, trims to ``n_symbols``, and
    enforces the exact-bit invariant."""
    from ..format.hostcodec import _check_stream_bits

    counts_np = np.concatenate(
        [np.asarray(c, dtype=np.int64) for c in lane_tots]
    )
    w_inv_np = np.concatenate([np.asarray(w, dtype=np.int64) for w in w_invs])
    w_inv_np[w_inv_np >= (1 << 30)] = -1
    validate_chunk_meta(counts_np, w_inv_np, n_symbols)
    out = np.concatenate(
        [extract_plane_symbols(p, mt_) for p, mt_ in zip(planes, minis)]
    )[:n_symbols]
    if out.size < n_symbols:
        raise ValueError(
            f"bitstream ended early: decoded {out.size} of {n_symbols} symbols"
        )
    _check_stream_bits(out, table.lengths, n_body)
    return out


def assemble_symbol_plane(
    plane, mini_tot, lane_tot, w_inv, n_symbols, table, n_body
) -> np.ndarray:
    """Singleton wrapper of :func:`assemble_symbol_planes`."""
    return assemble_symbol_planes(
        [plane], [mini_tot], [lane_tot], [w_inv], n_symbols, table, n_body
    )


def decode_body_device_full(
    body: bytes | np.ndarray,
    table: CodeTable,
    n_symbols: int,
    *,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    fsm: ByteFsm | None = None,
) -> np.ndarray:
    """End-to-end ON-DEVICE decode: FSM passes -> device symbol expansion ->
    device compaction; the host only fetches tiny per-lane metadata and the
    final flat symbol stream (= the decompressed bytes). The GPU route
    (:func:`device_e2e_default`); the CPU backend keeps the C++ expansion
    of :func:`decode_body_device`. Reference counterpart
    ``decode.zig:143-203``.
    """
    if n_symbols == 0:
        return np.zeros(0, dtype=np.uint8)
    from ..utils.trace import phase

    fsm = fsm or build_byte_fsm(table)
    buf = (
        np.frombuffer(body, dtype=np.uint8)
        if isinstance(body, (bytes, bytearray, memoryview))
        else np.asarray(body, dtype=np.uint8)
    )
    lanes = max(1, -(-buf.size // chunk_bytes))
    mode = os.environ.get("ENTREEPY_EXPAND", "onepass")
    if mode == "onepass" and 0 < TILE_LANES < lanes:
        # Bodies past one tile stream through the bounded-memory tiled path
        # (ENTREEPY_TILE_LANES=0 disables; the tiled route exists only for
        # the default one-pass pipeline — the two-pass ENTREEPY_EXPAND
        # modes stay untiled).
        return decode_body_device_tiled(
            buf, table, n_symbols, chunk_bytes=chunk_bytes, fsm=fsm
        )
    padded = np.zeros(lanes * chunk_bytes, dtype=np.uint8)
    padded[: buf.size] = buf
    n_valid = jnp.int32(buf.size)

    with phase("device_fsm8_decode", n_symbols):
        cols = bytes_to_cols(padded, lanes, chunk_bytes)
        if mode == "onepass":
            # One-pass decode: a single fused pass emits the symbol rows
            # directly (no separate emit pass, no state round trip through
            # device memory). For m <= 3 the whole per-byte row rides ONE
            # int32 word (packed mode), MASKED in the pass — the dense
            # compaction then reads the plane bytes verbatim: no sizing
            # fetch, no cap-keyed recompiles, no sort.
            t_fused, m, mt, s = build_fused(fsm)
            packed = m <= 3 and os.environ.get("ENTREEPY_FUSED_PACKED", "1") == "1"
            vals, _exits, unconverged = run_fused_decode(
                cols, _table_T_bf16(fsm), t_fused, jnp.int32(lanes),
                m, mt, s, packed=packed, n_valid=n_valid if packed else None,
            )
        else:
            packed = False
            states, unconverged = fsm8_decode(
                cols, _table_T_bf16(fsm), jnp.int32(lanes), impl=pass_impl()
            )
    if bool(unconverged):
        return host_fallback_decode(buf, table, n_symbols)
    with phase("device_expand", n_symbols):
        if packed:
            plane, mini_tot, lane_tot, w_inv = compact_symbols_dense(vals, m)
            mini_tot = mini_tot.astype(jnp.uint8)  # counts <= m <= 3
        else:
            if mode == "onepass":
                counts, inv, syms = _expand_mask(
                    vals[:, 0, :], vals[:, 1:, :].astype(jnp.uint8), n_valid, m
                )
            else:
                t_exp, m, mt = build_expand(fsm)
                counts, inv, syms = run_expand(cols, states, t_exp, n_valid,
                                               m, mt)
            cap_sym = sym_cap(counts, m)  # tiny sizing fetch
            plane, mini_tot, lane_tot, w_inv = compact_symbols_device(
                counts, inv, syms, m, cap_sym
            )
    with phase("device_sym_fetch", n_symbols):
        out = assemble_symbol_plane(
            plane, mini_tot, lane_tot, w_inv, n_symbols, table, buf.size
        )
    return out


# Streaming tile width for decode_body_device_tiled (lanes per tile).
# 65536 lanes x 512 B chunks = 32 MB of compressed body per tile: the HBM
# working set stays ~10 B/compressed-byte x 32 MB regardless of body size.
TILE_LANES = int(os.environ.get("ENTREEPY_TILE_LANES", "65536"))


def decode_body_device_tiled(
    body: bytes | np.ndarray,
    table: CodeTable,
    n_symbols: int,
    *,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    tile_lanes: int | None = None,
    fsm: ByteFsm | None = None,
) -> np.ndarray:
    """Streaming variant of :func:`decode_body_device_full` for big bodies:
    chunk lanes process in TILES of ``tile_lanes`` (~tile_lanes*chunk_bytes
    compressed bytes of HBM working set per tile, ~10 B/byte). Tiles run in
    stream order, so each tile's first-lane entry state is EXACTLY the
    previous tile's last-lane exit — no global fixed point; self-sync runs
    only within each tile. Per tile: one-pass fused decode -> device
    compaction -> the host fetches the tile's compacted plane and frees the
    tile's HBM. Accept/reject and the exact-bit invariant run on the
    concatenated per-tile metadata, identical to the untiled path.

    Reference counterpart ``decode.zig:143-203`` (which streams the whole
    body serially at ~0.44 MB/s)."""
    if n_symbols == 0:
        return np.zeros(0, dtype=np.uint8)
    from ..utils.trace import phase

    if os.environ.get("ENTREEPY_EXPAND", "onepass") != "onepass":
        # A two-pass expand mode is forced: the untiled path honours it
        # (and, for such a mode, never routes back here).
        return decode_body_device_full(
            body, table, n_symbols, chunk_bytes=chunk_bytes, fsm=fsm
        )
    fsm = fsm or build_byte_fsm(table)
    buf = (
        np.frombuffer(body, dtype=np.uint8)
        if isinstance(body, (bytes, bytearray, memoryview))
        else np.asarray(body, dtype=np.uint8)
    )
    t_lanes = tile_lanes or TILE_LANES
    lanes = max(1, -(-buf.size // chunk_bytes))

    t_fused, m, mt, s = build_fused(fsm)
    packed = m <= 3 and os.environ.get("ENTREEPY_FUSED_PACKED", "1") == "1"
    tbl = _table_T_bf16(fsm)

    planes, minis, lane_tots, w_invs = [], [], [], []

    def drain(tile) -> bool:
        """Fetch one tile's device results (False = its self-sync failed)."""
        plane, mini_tot, lane_tot, w_inv, unconverged = tile
        if bool(unconverged):
            return False
        with phase("device_sym_fetch", n_symbols):
            planes.append(np.asarray(plane))
            minis.append(np.asarray(mini_tot, dtype=np.int64))
            lane_tots.append(np.asarray(lane_tot, dtype=np.int64))
            w_invs.append(np.asarray(w_inv, dtype=np.int64))
        return True

    # Depth-2 pipeline: tile t+1's decode+compaction launches BEFORE tile
    # t's results are fetched, so the host-side D2H of tile t overlaps tile
    # t+1's device compute (entry chaining is a device scalar — no host
    # sync anywhere in the launch train; the packed path has no sizing
    # fetch either, its dense-plane cap is statically m).
    pending = None
    failed = False
    entry0 = None  # tile 0 starts at the root
    l0 = 0
    while l0 < lanes and not failed:
        tl = min(t_lanes, lanes - l0)
        stats["decode_tiles"] += 1
        pad_t = np.zeros(tl * chunk_bytes, np.uint8)
        seg = buf[l0 * chunk_bytes : (l0 + tl) * chunk_bytes]
        pad_t[: seg.size] = seg
        # Local coordinates: the real-byte mask bound is computed host-side
        # in Python ints — device positions stay tile-local, so int32 never
        # wraps no matter how large the body is (>= 2 GiB bodies would
        # overflow global int32 positions).
        nv_t = jnp.int32(
            min(max(buf.size - l0 * chunk_bytes, 0), tl * chunk_bytes)
        )
        with phase("device_fsm8_decode", n_symbols):
            cols_t = bytes_to_cols(pad_t, tl, chunk_bytes)
            vals, exits, unconverged = run_fused_decode(
                cols_t, tbl, t_fused, jnp.int32(tl), m, mt, s,
                packed=packed, entry0=entry0,
                n_valid=nv_t if packed else None,
            )
        with phase("device_expand", n_symbols):
            if packed:
                plane, mini_tot, lane_tot, w_inv = compact_symbols_dense(
                    vals, m
                )
                mini_tot = mini_tot.astype(jnp.uint8)  # counts <= m <= 3
            else:
                counts, inv, syms = _expand_mask(
                    vals[:, 0, :], vals[:, 1:, :].astype(jnp.uint8), nv_t, m
                )
                cap_sym = sym_cap(counts, m)  # sizing fetch (legacy rows)
                plane, mini_tot, lane_tot, w_inv = compact_symbols_device(
                    counts, inv, syms, m, cap_sym
                )
        if pending is not None:
            failed = not drain(pending)
        pending = (plane, mini_tot, lane_tot, w_inv, unconverged)
        if l0 + tl < lanes:
            entry0 = exits[tl - 1]
        l0 += tl
    if not failed and pending is not None:
        failed = not drain(pending)
    if failed:
        return host_fallback_decode(buf, table, n_symbols)

    return assemble_symbol_planes(
        planes, minis, lane_tots, w_invs, n_symbols, table, buf.size
    )


def device_e2e_default() -> bool:
    """Default route of the device decode's expansion stage: fully on device
    (:func:`decode_body_device_full`) on the GPU; on the CPU backend the
    state fetch plus the threaded C++ expansion
    (:func:`decode_body_device`) is the faster route."""
    return use_kernels()


def decompress_device(et: bytes, *, chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> bytes:
    """Complete .et file -> original bytes, decoded chunk-parallel on device.

    On the GPU the whole pipeline (FSM passes, symbol expansion,
    compaction) runs on the device and only the final byte stream is
    fetched (:func:`device_e2e_default`)."""
    hdr = parse_header(et)
    body_fn = decode_body_device_full if device_e2e_default() else decode_body_device
    out = body_fn(
        et[hdr.body_start :], hdr.table, hdr.body_len, chunk_bytes=chunk_bytes
    )
    return out.tobytes()
