"""Sharded compress/decompress over a 1-D device mesh (shard_map + collectives).

Encode (block data parallelism — the new capability the reference names as
future work, its README's "block based parallel decoding"):

1. local byte histogram per shard -> ``psum`` over the mesh (replicated counts)
2. host builds the exact code table (tiny), replicates codes/lengths
3. every device scan-packs its blocks locally (``pack_blocks_scan``)
4. every device compacts its own dense emission slots (per-lane sort —
   shard-local, no collectives), so only ~compressed-size
   (payload, bit_lens) rows ever cross D2H or the network
5. compact payload rows gather; the host stitches them in block order

Decode: FSM chunks (lanes) shard across devices; the self-sync fixed-point
loop runs *inside* jit with a tiled ``all_gather`` of per-chunk exit states
per pass (a few KB). Symbols then come from (a) fully on-shard device
expansion + compaction (``device_expand=True``, the GPU default — each
device emits its own chunks' output bytes), (b) the threaded host
expansion of the fetched states (the CPU-backend default), or (c)
per-process local expansion under multi-host (1/N fetch,
``_expand_multihost``).

Multi-host: the same program runs under ``jax.distributed.initialize`` —
the mesh axis spans all processes' devices and XLA routes the collectives
over the devices' interconnect within a host and the network across hosts.
"""

from __future__ import annotations

import os
from functools import lru_cache, partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..format.etformat import parse_header, serialize_header
from ..format.fsm8 import build_byte_fsm
from ..format.huffman import build_code_table
from ..ops.bitpack import (
    code_table_cols,
    compact_payload_flat,
    flat_cap,
    grouped_counts,
    pack_blocks_scan,
    payload_cap_g,
)
from ..ops.decode8 import (
    DEFAULT_CHUNK_BYTES,
    MAX_SYNC_PASSES,
    SYNC_WINDOW,
    _table_T_bf16,
    byte_rows,
    bytes_to_cols,
    expand_states,
    fused_pass,
    fused_tables,
    host_fallback_decode,
    pass_impl,
    state_pass,
    state_tables,
    sync_exits,
)
from ..ops.kernels import pack_blocks_kernel, use_kernels
from ..utils.stitch import split_blocks, stitch_flat_payload, words_to_bytes
from .mesh import BLOCK_AXIS, make_mesh

# One source of truth with the single-device path (ops/encode.py): the
# block size is a pure perf knob (the stitched .et stream is bit-identical
# at any value).
from ..ops.encode import DEFAULT_BLOCK_BYTES

# Sharded decode masks real bytes by global int32 positions; compressed
# bodies at/past this wrap and must take the tile-local streaming path.
_INT32_SAFE_BODY = 1 << 31

# Diagnostics from the last compress_sharded call (tests assert the encode
# fetch volume tracks the compressed size, not the input size).
last_encode_stats: dict = {}


def _bucket(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _fetch(x) -> np.ndarray:
    """Device -> host for arrays that may span multiple processes: every
    process needs the full value for the host-side stitch/expansion, so
    multi-host runs all_gather the shards across hosts first (tiny relative to
    the payloads: this is the only cross-host data movement besides the
    histogram psum and per-pass exit states)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


@lru_cache(maxsize=None)
def _hist_fn(mesh: Mesh, axis: str):
    def local(blocks, valid):
        sym = jnp.arange(256, dtype=jnp.int32)

        def step(acc, x):
            row, v = x
            idx = jnp.arange(row.shape[0], dtype=jnp.int32)
            b = jnp.where(idx < v, row.astype(jnp.int32), -1)  # padding -> no bin
            return acc + jnp.sum(b[:, None] == sym[None, :], axis=0), None

        counts, _ = jax.lax.scan(step, jnp.zeros(256, jnp.int32), (blocks, valid))
        return jax.lax.psum(counts, axis)

    return jax.jit(
        shard_map(
            local, mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P(), check_vma=False
        )
    )


@lru_cache(maxsize=None)
def _pack_fn(mesh: Mesh, axis: str):
    @jax.jit
    def f(blocks, valid, codetbl):
        # Per-shard pack: the kernel on the GPU, the XLA scan elsewhere.
        local_pack = pack_blocks_kernel if use_kernels() else pack_blocks_scan
        return shard_map(
            local_pack,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P()),
            out_specs=(P(axis), P(axis), P(axis), P(axis)),
            check_vma=False,
        )(blocks, valid, codetbl)

    return f


def _shard_blocks(arr: np.ndarray, block_bytes: int, n_dev: int):
    """Split + zero-pad the block count to a power of two, and at least one
    block per device."""
    blocks, valid = split_blocks(arr, block_bytes)
    n = blocks.shape[0]
    n_pad = max(_bucket(n), n_dev)
    if n_pad != n:
        blocks = np.concatenate([blocks, np.zeros((n_pad - n, block_bytes), np.uint8)])
        valid = np.concatenate([valid, np.zeros(n_pad - n, np.int32)])
    return blocks, valid


def compress_sharded(
    data: bytes,
    mesh: Mesh | None = None,
    *,
    strict: bool = True,
    block_bytes: int = DEFAULT_BLOCK_BYTES,
    axis: str = BLOCK_AXIS,
) -> bytes:
    """bytes -> .et file, block-parallel across the mesh; byte-identical to
    the single-device and host paths."""
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    arr = np.frombuffer(data, dtype=np.uint8)
    blocks_np, valid_np = _shard_blocks(arr, block_bytes, n_dev)

    # Interleave blocks round-robin over shards: the real blocks (the lane
    # bucketing pads with empties at the end) spread evenly, so every
    # shard's compact flat payload is ~equally full and the SPMD-equal
    # per-shard cap carries no dead weight. lane l of shard d holds block
    # l*n_dev + d; the stitch below maps back to block order.
    lanes = blocks_np.shape[0]
    lanes_local = lanes // n_dev
    d_of = np.arange(lanes) // lanes_local
    j_of = np.arange(lanes) % lanes_local
    lane_to_block = j_of * n_dev + d_of  # inverse of block -> lane
    blocks_np = blocks_np[lane_to_block]
    valid_np = valid_np[lane_to_block]

    blocks = jnp.asarray(blocks_np)
    valid = jnp.asarray(valid_np)

    counts = np.asarray(_hist_fn(mesh, axis)(blocks, valid), dtype=np.int64)
    table = build_code_table(counts, strict=strict)
    codetbl = jnp.asarray(code_table_cols(table.codes, table.lengths), dtype=jnp.bfloat16)

    words, emitted, acc, nbits = _pack_fn(mesh, axis)(blocks, valid, codetbl)
    # Compact ON DEVICE, shard-local (no collectives): the dense
    # 4 B-per-input-byte slots never leave the chips. Off-device movement is
    # the per-block counts (4 B/block), then each shard's ~compressed-size
    # flat payload + per-block word counts/bit lengths.
    counts_g = _fetch(grouped_counts(emitted))
    counts = counts_g.sum(axis=1)
    per_shard = counts.reshape(n_dev, lanes_local)
    cap_g = payload_cap_g(int(counts_g.max(initial=0)), block_bytes)
    cap_total_local = flat_cap(
        int((per_shard.sum(axis=1) + lanes_local).max()), round_to=1024
    )
    flat, nwords, bit_lens = _compact_fn(mesh, axis, cap_g, cap_total_local)(
        words, emitted, acc, nbits
    )
    flat_np = _fetch(flat)
    nw = _fetch(nwords).astype(np.int64)
    bl = _fetch(bit_lens).astype(np.int64)
    last_encode_stats.clear()
    last_encode_stats.update(
        fetched_bytes=flat_np.nbytes + nw.nbytes + bl.nbytes + counts_g.nbytes,
        dense_bytes=sum(int(np.prod(a.shape)) * a.dtype.itemsize
                        for a in (words, emitted)),
        payload_bits=int(bl.sum()),
    )
    # Absolute word offsets into the fetched flat array: shard d's stream
    # starts at d*cap_total_local; lanes are consecutive within a shard.
    # Then undo the round-robin interleave so blocks stitch in input order.
    nw2 = nw.reshape(n_dev, lanes_local)
    local_offs = np.cumsum(nw2, axis=1) - nw2
    offs_lane = (np.arange(n_dev)[:, None] * cap_total_local + local_offs).reshape(-1)
    block_to_lane = np.empty(lanes, dtype=np.int64)
    block_to_lane[lane_to_block] = np.arange(lanes)
    words_out, total_bits = stitch_flat_payload(
        flat_np, nw[block_to_lane], bl[block_to_lane], offs=offs_lane[block_to_lane]
    )
    return serialize_header(table, arr.size) + words_to_bytes(words_out, total_bits)


@lru_cache(maxsize=None)
def _compact_fn(mesh: Mesh, axis: str, cap: int, cap_total_local: int):
    """Per-shard two-stage compaction: each shard packs its own lanes' words
    into one flat stream (shard-local — no collectives), so the only
    off-device bytes are ~the compressed payload."""

    def local(words, emitted, acc, nbits):
        return compact_payload_flat(words, emitted, acc, nbits, cap, cap_total_local)

    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(axis), P(axis), P(axis)),
            check_vma=False,
        )
    )


@lru_cache(maxsize=None)
def _expand_fn(mesh: Mesh, axis: str, m: int, mt: int | None):
    """Per-shard on-device symbol emission (XLA scan): every
    shard expands its own lanes' states — no collectives; ``pos0`` offsets
    the real-byte mask to the shard's global byte position. ``mt`` selects
    the split expand table (None = fused), see ops/decode8.build_expand."""

    def local(cols_l, states_l, t_exp, n_valid):
        from ..ops.decode8 import run_expand

        base = jax.lax.axis_index(axis) * cols_l.shape[0] * cols_l.shape[1]
        return run_expand(cols_l, states_l, t_exp, n_valid[0], m, mt, pos0=base)

    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(), P()),
            out_specs=(P(None, axis), P(None, axis), P(None, None, axis)),
            check_vma=False,
        )
    )


@lru_cache(maxsize=None)
def _decode_fn(mesh: Mesh, axis: str):
    """Sharded byte-FSM decode (gen 2, see ops/decode8.py): chunk lanes shard
    over the mesh; entry states first come from a local suffix sync, then
    full passes iterate to a fixed point with an ``all_gather`` of per-chunk
    exit states per pass (one int per chunk — a few KB) so the sequential
    entry chain spans the whole stream. Each shard emits its per-byte state
    sequence locally (the kernel on the GPU, the XLA scan elsewhere); the
    host expands states to symbols."""

    @partial(jax.jit, static_argnames=("max_passes",))
    def f(cols, table_T, n_real_lanes, max_passes=MAX_SYNC_PASSES):
        n_dev = mesh.devices.size
        lanes = cols.shape[0]
        k = cols.shape[1]
        lanes_local = lanes // n_dev
        impl = pass_impl()

        def local(cols, table_T_, n_real_lanes):
            xs = byte_rows(cols, impl)  # [K, lanes_local]
            tbl = state_tables(table_T_, impl)
            my = jax.lax.axis_index(axis) * lanes_local
            real = jnp.arange(lanes, dtype=jnp.int32) < n_real_lanes[0]

            sfx_local = sync_exits(xs, tbl, k - min(SYNC_WINDOW, k), impl)
            sfx = jax.lax.all_gather(sfx_local, axis, tiled=True)
            entries0 = jnp.concatenate([jnp.zeros(1, jnp.int32), sfx[:-1]])

            def cond(c):
                entries, prev, _, it = c
                return jnp.logical_and(
                    it < max_passes, jnp.any(jnp.logical_and(entries != prev, real))
                )

            def body(c):
                entries, _, _, it = c
                mine = jax.lax.dynamic_slice(entries, (my,), (lanes_local,))
                exits_local, states = state_pass(xs, tbl, mine, impl)
                exits = jax.lax.all_gather(exits_local, axis, tiled=True)
                new_entries = jnp.concatenate([jnp.zeros(1, jnp.int32), exits[:-1]])
                return new_entries, entries, states, it + 1

            states0 = jnp.zeros((k, lanes_local), jnp.uint8)
            entries, prev, states, _ = jax.lax.while_loop(
                cond, body, (entries0, entries0 - 1, states0, jnp.int32(0))
            )
            unconverged = jnp.any(jnp.logical_and(entries != prev, real))
            return states.T, unconverged[None]

        return shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis), P(), P(axis)),
            out_specs=(P(axis), P(axis)),
            check_vma=False,
        )(cols, table_T, n_real_lanes)

    return f


@lru_cache(maxsize=None)
def _decode_fused_fn(mesh: Mesh, axis: str, m: int, mt: int, s: int,
                     packed: bool):
    """Sharded ONE-PASS decode (the onepass twin of :func:`_decode_fn`):
    each full pass emits the per-byte symbol rows directly from the fused
    pass — no state sequence ever hits device memory or the host. Same fixed-point
    entry chain (1 int per chunk all_gathered per pass). Returns (vals
    int32[K, lanes] packed one-word rows — or [K, m+1, lanes] when not
    ``packed`` — sharded on lanes, and per-shard unconverged bools)."""

    @partial(jax.jit, static_argnames=("max_passes",))
    def f(cols, table_T, t_fused, n_real_lanes, n_valid,
          max_passes=MAX_SYNC_PASSES):
        n_dev = mesh.devices.size
        lanes, k = cols.shape
        lanes_local = lanes // n_dev
        impl = pass_impl()

        def local(cols_l, table_T_, t_fused_, n_real_lanes_, n_valid_):
            xs = byte_rows(cols_l, impl)  # [K, lanes_local]
            ftbl = fused_tables(t_fused_, m, mt, s, packed, impl)
            my = jax.lax.axis_index(axis) * lanes_local
            real = jnp.arange(lanes, dtype=jnp.int32) < n_real_lanes_[0]
            # Packed rows mask in shard-LOCAL lane-linear coordinates: the
            # shard's bound is the global one shifted by its lane base.
            nv_local = n_valid_[0] - my * k

            sfx_local = sync_exits(
                xs, state_tables(table_T_, impl), k - min(SYNC_WINDOW, k), impl
            )
            sfx = jax.lax.all_gather(sfx_local, axis, tiled=True)
            entries0 = jnp.concatenate([jnp.zeros(1, jnp.int32), sfx[:-1]])

            def cond(c):
                entries, prev, _, it = c
                return jnp.logical_and(
                    it < max_passes, jnp.any(jnp.logical_and(entries != prev, real))
                )

            def body(c):
                entries, _, _, it = c
                mine = jax.lax.dynamic_slice(entries, (my,), (lanes_local,))
                exits_local, vals = fused_pass(xs, ftbl, mine, m, mt, s, packed,
                                               nv_local, impl)
                exits = jax.lax.all_gather(exits_local, axis, tiled=True)
                new_entries = jnp.concatenate([jnp.zeros(1, jnp.int32), exits[:-1]])
                return new_entries, entries, vals, it + 1

            shape0 = (k, lanes_local) if packed else (k, m + 1, lanes_local)
            vals0 = jnp.zeros(shape0, jnp.int32)
            entries, prev, vals, _ = jax.lax.while_loop(
                cond, body, (entries0, entries0 - 1, vals0, jnp.int32(0))
            )
            unconverged = jnp.any(jnp.logical_and(entries != prev, real))
            return vals, unconverged[None]

        return shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis), P(), P(), P(axis), P(axis)),
            out_specs=(
                P(None, axis) if packed else P(None, None, axis),
                P(axis),
            ),
            check_vma=False,
        )(cols, table_T, t_fused, n_real_lanes, n_valid)

    return f


def _decode_expand_onepass(mesh, axis, cols, buf, fsm, table, n_symbols,
                           n_real_lanes) -> bytes | None:
    """Fully on-shard one-pass decode: fused sharded decode (no state
    materialization) -> GSPMD-sharded compaction (per-lane ops keep the
    lane sharding; no collectives) -> host assembles the compacted plane.
    The GPU-default route of :func:`decompress_sharded`."""
    from ..ops.decode8 import (
        SUB_BYTES_FETCH, _expand_mask, assemble_symbol_plane, build_fused,
        compact_symbols_device, compact_symbols_packed, packed_mini_totals,
        packed_sym_cap, sym_cap,
    )

    n_dev = mesh.devices.size
    t_fused, m, mt, s = build_fused(fsm)
    packed = m <= 3 and os.environ.get("ENTREEPY_FUSED_PACKED", "1") == "1"
    vals, unconverged = _decode_fused_fn(mesh, axis, m, mt, s, packed)(
        cols, _table_T_bf16(fsm), t_fused,
        jnp.full((n_dev,), n_real_lanes, dtype=jnp.int32),
        jnp.full((n_dev,), buf.size, dtype=jnp.int32),
    )
    if bool(_fetch(unconverged).any()):
        return host_fallback_decode(buf, table, n_symbols).tobytes()
    nv = jnp.int32(buf.size)
    k = cols.shape[1]
    # Wider subgroups than the on-device default: this plane crosses
    # D2H (and the network under multi-host), so cap slack is fetched
    # bandwidth here.
    if packed:
        mini = packed_mini_totals(vals, m, sub=SUB_BYTES_FETCH)
        cap_sym = packed_sym_cap(mini, m, k, sub=SUB_BYTES_FETCH)
        plane, mini_tot, lane_tot, w_inv = compact_symbols_packed(
            vals, m, cap_sym, sub=SUB_BYTES_FETCH
        )
    else:
        counts, inv, syms = _expand_mask(
            vals[:, 0, :], vals[:, 1:, :].astype(jnp.uint8), nv, m
        )
        cap_sym = sym_cap(counts, m, sub=SUB_BYTES_FETCH)
        plane, mini_tot, lane_tot, w_inv = compact_symbols_device(
            counts, inv, syms, m, cap_sym, sub=SUB_BYTES_FETCH
        )
    return assemble_symbol_plane(
        plane, mini_tot, lane_tot, w_inv, n_symbols, table, buf.size
    ).tobytes()


def sharded_device_expand_default() -> bool:
    """Default of the sharded decode's expansion stage: fully on-shard on
    the GPU (the host does no per-byte work); states fetch + threaded host
    expansion on the CPU backend, where that is the faster route."""
    return use_kernels()


def decompress_sharded(
    et: bytes,
    mesh: Mesh | None = None,
    *,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    axis: str = BLOCK_AXIS,
    chunk_bits: int | None = None,  # back-compat: bits = 8 * chunk_bytes
    device_expand: bool | None = None,
) -> bytes:
    """.et file -> original bytes, chunk-parallel across the mesh.

    device_expand=True runs symbol expansion + compaction ON the shards too
    (single-process meshes) — each device emits its own chunks' output
    bytes, so the host does no per-byte work at all. Default
    (:func:`sharded_device_expand_default`): on-shard on the GPU, states
    fetch + threaded host expansion on the CPU backend."""
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    hdr = parse_header(et)
    if hdr.body_len == 0:
        return b""
    if chunk_bits is not None:
        chunk_bytes = max(1, chunk_bits // 8)
    fsm = build_byte_fsm(hdr.table)
    buf = np.frombuffer(et, dtype=np.uint8)[hdr.body_start :]
    if buf.size >= _INT32_SAFE_BODY:
        # The sharded expansion masks real bytes by GLOBAL int32 position
        # (pos0 = shard base), which would wrap for >= 2 GiB compressed
        # bodies. The .et contract (u32 original length) admits such files;
        # route them through the single-device streaming tiled decode,
        # whose positions are tile-local and wrap-free.
        from ..ops.decode8 import decode_body_device_full

        return decode_body_device_full(
            buf, hdr.table, hdr.body_len, chunk_bytes=chunk_bytes, fsm=fsm
        ).tobytes()

    n_real_lanes = max(1, -(-buf.size // chunk_bytes))
    # Lanes must split evenly over devices; padding lanes hold zeros and are
    # excluded from self-sync.
    lanes = -(-n_real_lanes // n_dev) * n_dev
    padded = np.zeros(lanes * chunk_bytes, dtype=np.uint8)
    padded[: buf.size] = buf
    cols = bytes_to_cols(padded, lanes, chunk_bytes)

    if device_expand is None:
        device_expand = sharded_device_expand_default()
    if (
        device_expand
        and jax.process_count() == 1
        and os.environ.get("ENTREEPY_EXPAND", "onepass") == "onepass"
    ):
        # One-pass route: fused decode emits symbol rows directly — the
        # per-byte state sequence never exists.
        return _decode_expand_onepass(
            mesh, axis, cols, buf, fsm, hdr.table, hdr.body_len, n_real_lanes
        )

    states, unconverged = _decode_fn(mesh, axis)(
        cols, _table_T_bf16(fsm), jnp.full((n_dev,), n_real_lanes, dtype=jnp.int32)
    )
    if bool(_fetch(unconverged).any()):
        return host_fallback_decode(buf, hdr.table, hdr.body_len).tobytes()
    if jax.process_count() > 1:
        return _expand_multihost(states, buf, fsm, hdr.table, hdr.body_len, chunk_bytes)
    if device_expand:
        return _expand_on_shards(
            mesh, axis, cols, states, buf, fsm, hdr.table, hdr.body_len
        )
    return expand_states(_fetch(states), buf, fsm, hdr.body_len).tobytes()


def _expand_on_shards(mesh, axis, cols, states, buf, fsm, table, n_symbols) -> bytes:
    """Shard-local device expansion + compaction: each shard emits its own
    chunks' output bytes; the host only fetches tiny per-lane metadata and the compacted symbol
    columns, applies the serial-exact accept/reject, and concatenates."""
    from ..ops.decode8 import (
        SUB_BYTES_FETCH, assemble_symbol_plane, build_expand,
        compact_symbols_device, sym_cap,
    )

    t_exp, m, mt = build_expand(fsm)
    counts, inv, syms = _expand_fn(mesh, axis, m, mt)(
        cols, states, t_exp, jnp.full((1,), buf.size, dtype=jnp.int32)
    )
    cap_sym = sym_cap(counts, m, sub=SUB_BYTES_FETCH)  # tiny sizing fetch
    # per-lane ops only — GSPMD keeps the lane sharding, no collectives;
    # wider subgroups: this plane is fetched across D2H
    plane, mini_tot, lane_tot, w_inv = compact_symbols_device(
        counts, inv, syms, m, cap_sym, sub=SUB_BYTES_FETCH
    )
    return assemble_symbol_plane(
        plane, mini_tot, lane_tot, w_inv, n_symbols, table, buf.size
    ).tobytes()


# Diagnostics from the last multi-host expansion (the 2-process test asserts
# the per-process D2H fetch scales as 1/N while outputs stay byte-equal).
last_decode_stats: dict = {}


def _expand_multihost(states, buf, fsm, table, n_symbols, chunk_bytes) -> bytes:
    """Per-process symbol expansion: each process fetches ONLY its own
    shards' state sequences (1/N of the compressed stream over D2H), expands
    its chunks' symbols locally, and the full output is assembled from one
    all-gather of (tiny per-chunk metadata, per-process symbol shards) — so
    cross-host movement is ~the decompressed output, never N redundant
    expansions (multihost.py's contract).

    Accept/reject semantics are identical to :func:`expand_states`: an
    invalid transition raises iff it lies at-or-before the byte where the
    n_symbols-th symbol completes (checked via per-chunk first-invalid
    offsets), truncation raises, and the exact-bit invariant is enforced on
    the assembled output (``_check_stream_bits``)."""
    from jax.experimental import multihost_utils

    from ..format.hostcodec import _check_stream_bits

    shards = sorted(
        states.addressable_shards, key=lambda s: s.index[0].start or 0
    )
    st_local = np.concatenate([np.asarray(s.data) for s in shards], axis=0)
    lane0 = shards[0].index[0].start or 0
    my_lanes, k = st_local.shape
    lanes = states.shape[0]
    if lanes % my_lanes:
        raise ValueError(
            f"uneven lane partition across processes ({my_lanes}/{lanes})"
        )
    # The assembly below assumes process-allgather order == lane-block order
    # (process p owns lanes [p*my_lanes, (p+1)*my_lanes), contiguously). A
    # caller-supplied mesh with interleaved process device order would
    # silently permute the output at chunk granularity — the histogram-based
    # stream check cannot catch reordering — so fail loudly instead.
    if lane0 != jax.process_index() * my_lanes:
        raise ValueError(
            f"process {jax.process_index()} owns lanes starting at {lane0}, "
            f"expected {jax.process_index() * my_lanes}: mesh device order "
            "interleaves processes (use the default contiguous mesh)"
        )
    stop = lane0
    for s in shards:
        idx = s.index[0]
        if (idx.start or 0) != stop:
            raise ValueError(
                "non-contiguous lane shards within a process: mesh device "
                "order interleaves processes (use the default contiguous mesh)"
            )
        stop = idx.stop if idx.stop is not None else lanes

    # my chunks' body bytes (the body is replicated on every host's disk
    # read; only the *states* ever cross D2H)
    abs0 = lane0 * chunk_bytes
    my_end = min(buf.size, abs0 + my_lanes * chunk_bytes)
    n_real = max(0, my_end - abs0)
    body_my = np.zeros(my_lanes * chunk_bytes, dtype=np.uint8)
    if n_real:
        body_my[:n_real] = buf[abs0:my_end]
    st_flat = st_local.reshape(-1)

    from .. import runtime

    m = max(1, int(fsm.counts.max(initial=1)))
    native = (
        runtime.fsm8_expand_chunks(
            st_flat[:n_real], body_my[:n_real], fsm.counts, fsm.syms,
            chunk_bytes, m,
        )
        if n_real
        else None
    )
    if native is not None:
        rows, pc, wi = native
        per_chunk = np.zeros(my_lanes, dtype=np.int64)
        per_chunk[: pc.size] = pc
        w_inv = np.full(my_lanes, -1, dtype=np.int64)
        w_inv[: wi.size] = wi
        local_syms = np.concatenate(
            [rows[c, : pc[c]] for c in range(pc.size)]
        ) if pc.size else np.zeros(0, np.uint8)
    else:
        cnt = fsm.counts[st_flat, body_my].astype(np.int64)
        cnt[n_real:] = 0  # padding bytes beyond the real stream emit nothing
        valid_cnt = np.maximum(cnt, 0)
        per_chunk = valid_cnt.reshape(my_lanes, chunk_bytes).sum(axis=1)

        # symbols emitted before the FIRST invalid byte of a chunk (-1: none)
        w_inv = np.full(my_lanes, -1, dtype=np.int64)
        inv = np.flatnonzero(cnt < 0)
        if inv.size:
            chunks_with_inv, first_idx = np.unique(
                inv // chunk_bytes, return_index=True
            )
            for c, i in zip(chunks_with_inv, first_idx):
                j = inv[i]
                w_inv[c] = int(valid_cnt[c * chunk_bytes : j].sum())

        sy = fsm.syms[st_flat, body_my]  # [n, 8]
        mask = np.arange(8, dtype=np.int64)[None, :] < cnt[:, None]
        local_syms = sy[mask]

    # int32 meta: jax's x64-disabled gather path handles int64 poorly
    meta = np.stack([per_chunk, w_inv], axis=1).astype(np.int32)
    from ..ops.decode8 import validate_chunk_meta

    gmeta = np.asarray(multihost_utils.process_allgather(meta, tiled=True))
    counts_all = gmeta[:, 0].astype(np.int64)
    w_inv_all = gmeta[:, 1].astype(np.int64)
    validate_chunk_meta(counts_all, w_inv_all, n_symbols)

    n_procs = jax.process_count()
    assert n_procs * my_lanes == lanes, (n_procs, my_lanes, lanes)
    proc_totals = counts_all.reshape(n_procs, my_lanes).sum(axis=1)
    cap = int(proc_totals.max(initial=1))
    padded_syms = np.zeros(cap, dtype=np.uint8)
    padded_syms[: local_syms.size] = local_syms
    gsyms = np.asarray(multihost_utils.process_allgather(padded_syms, tiled=True))
    out = np.concatenate(
        [gsyms[p * cap : p * cap + int(proc_totals[p])] for p in range(n_procs)]
    )[:n_symbols]
    _check_stream_bits(out, table.lengths, buf.size)

    last_decode_stats.clear()
    last_decode_stats.update(
        fetched_states_bytes=st_local.nbytes,
        total_states_bytes=int(states.shape[0]) * int(states.shape[1]),
        local_symbols=int(local_syms.size),
        n_symbols=n_symbols,
    )
    return out.tobytes()
