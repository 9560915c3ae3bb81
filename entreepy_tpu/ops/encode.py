"""Single-device compress pipeline: device histogram + block scan-pack, host
code construction + stitch.

Pipeline (block-parallel redesign of ``encode.zig:25-337``):

1. device: 256-bin histogram of the input bytes (compare-reduce, no scatter)
2. host:   exact deterministic code construction (tiny — 256 symbols)
3. device: block-parallel bit-pack (64-bit accumulator per lane, dense word
           emission — the GPU kernel or its XLA scan twin, ops/bitpack.py)
4. device: sort-based stream compaction (compact_payload_plane) so only
           ~compressed bytes cross D2H
5. host:   bit-granular stitch, header serialization

Block size here is a device-efficiency knob only — the stitched .et output
is byte-identical for every block size (and to the host codec / reference).
"""

from __future__ import annotations

import os

import numpy as np

from ..format.etformat import serialize_header
from ..format.huffman import CodeTable, build_code_table
from ..utils.stitch import split_blocks, stitch_flat_payload, words_to_bytes
from .bitpack import (
    HIST_COLS,
    code_table_cols,
    compact_payload_flat,
    flat_cap,
    grouped_counts,
    histogram_device,
    pack_blocks,
    payload_cap_g,
)

# Scan length; lanes = input_size / block_bytes. The stitched .et stream is
# byte-identical at ANY block size (bit-granular splices), so this is a pure
# perf knob: the pack's serial chain is one step per byte of a block, so
# smaller blocks shorten it while adding lanes. Chosen on the first target
# hardware; not yet measured on the H100 (ROADMAP, Speed).
DEFAULT_BLOCK_BYTES = 1024
# Streaming tile width for the device encode (blocks per tile): default
# keeps 32 MB of input per tile at the default block size — blocks are
# independent, so tiling is exact and the HBM working set is bounded at any
# input size.
TILE_BLOCKS = int(
    os.environ.get("ENTREEPY_TILE_BLOCKS", str((32 << 20) // DEFAULT_BLOCK_BYTES))
)
# Tiles the streaming encode has packed (callers check the tiled route ran).
stats = {"encode_tiles": 0}


def _bucket(n: int) -> int:
    """Round up to a power of two to bound jit recompiles."""
    return 1 << max(0, (n - 1).bit_length())


def histogram_on_device(arr: np.ndarray) -> np.ndarray:
    """Histogram of a host byte array via the device compare-reduce kernel.
    Arrays past one encode tile stream through tile-sized histograms summed
    host-side (exact — bounded HBM at any input size)."""
    import jax.numpy as jnp

    tile = TILE_BLOCKS * DEFAULT_BLOCK_BYTES if TILE_BLOCKS > 0 else arr.size
    if arr.size > tile > 0:
        total = np.zeros(256, dtype=np.int64)
        for off in range(0, arr.size, tile):
            total += histogram_on_device(arr[off : off + tile])
        return total
    n = _bucket(max(arr.size, HIST_COLS))
    padded = np.zeros(n, dtype=np.uint8)
    padded[: arr.size] = arr
    return np.asarray(
        histogram_device(jnp.asarray(padded), jnp.int32(arr.size)), dtype=np.int64
    )


def encode_blocks_device(
    arr: np.ndarray, table: CodeTable, block_bytes: int = DEFAULT_BLOCK_BYTES
):
    """Pack ``arr`` (uint8[n]) block-parallel on device.

    Returns (flat uint32 numpy — every block's compacted words back to back,
    nwords int64[n_blocks] — words per block incl. the final partial one,
    bit_lens int64[n_blocks]). Stitching is left to the caller so
    multi-device paths can reuse this per shard.

    Inputs past TILE_BLOCKS blocks stream in tiles (blocks are independent,
    so tiling is exact and byte-identical): the HBM working set stays
    ~TILE_BLOCKS*block_bytes regardless of input size; the per-tile
    compacted payloads concatenate host-side.
    """
    import jax.numpy as jnp

    if TILE_BLOCKS > 0 and arr.size > TILE_BLOCKS * block_bytes:
        tile = TILE_BLOCKS * block_bytes
        flats, nws, bls = [], [], []
        for off in range(0, arr.size, tile):
            stats["encode_tiles"] += 1
            f, nw, bl = encode_blocks_device(
                arr[off : off + tile], table, block_bytes
            )
            # Trim the tile's tail slack (flat compaction rounds cap_total up
            # to FLAT_ROUND words): the stitch indexes blocks at
            # cumsum(nwords), so mid-stream slack would misalign every tile
            # after the first.
            flats.append(f[: int(nw.sum())])
            nws.append(nw)
            bls.append(bl)
        return np.concatenate(flats), np.concatenate(nws), np.concatenate(bls)

    blocks_np, valid_np = split_blocks(arr, block_bytes)
    # Pad the block count to a power of two (extra blocks are empty:
    # valid=0) so jit compiles once per bucket, not once per file size.
    n_bucket = _bucket(blocks_np.shape[0])
    if n_bucket != blocks_np.shape[0]:
        pad = n_bucket - blocks_np.shape[0]
        blocks_np = np.concatenate([blocks_np, np.zeros((pad, block_bytes), np.uint8)])
        valid_np = np.concatenate([valid_np, np.zeros(pad, np.int32)])

    codetbl = jnp.asarray(code_table_cols(table.codes, table.lengths), dtype=jnp.bfloat16)
    words, emitted, acc, nbits = pack_blocks(
        jnp.asarray(blocks_np), jnp.asarray(valid_np), codetbl
    )
    # Compact ON DEVICE: only the per-block counts (4 B/block) and the
    # ~compressed-size payload cross D2H, not the 4 B-per-input-byte dense
    # slots. Default = single-stage plane compaction (per-subgroup sort,
    # host slices live prefixes): no global stage-2 sort, for a ~1.1-1.7x
    # fetch. ENTREEPY_ENC_COMPACT=flat keeps the exactly-compressed-size
    # fetch (the multihost default).
    if os.environ.get("ENTREEPY_ENC_COMPACT", "plane") == "plane":
        from .bitpack import (
            assemble_plane_payload, compact_payload_plane, grouped_counts_plane,
            plane_cap_g,
        )

        counts_g = np.asarray(grouped_counts_plane(emitted))
        cap_g = plane_cap_g(int(counts_g.max(initial=0)), block_bytes)
        plane, counts_gd, bit_lens = compact_payload_plane(
            words, emitted, acc, nbits, cap_g
        )
        flat, nwords = assemble_plane_payload(
            np.asarray(plane), np.asarray(counts_gd)
        )
        return flat, nwords, np.asarray(bit_lens, dtype=np.int64)
    counts_g = np.asarray(grouped_counts(emitted))
    cap_g = payload_cap_g(int(counts_g.max(initial=0)), block_bytes)
    cap_total = flat_cap(int(counts_g.sum()) + counts_g.shape[0])
    flat, nwords, bit_lens = compact_payload_flat(
        words, emitted, acc, nbits, cap_g, cap_total
    )
    return (
        np.asarray(flat),
        np.asarray(nwords, dtype=np.int64),
        np.asarray(bit_lens, dtype=np.int64),
    )


def compress_device(
    data: bytes, *, strict: bool = True, block_bytes: int = DEFAULT_BLOCK_BYTES
) -> bytes:
    """bytes -> complete .et file; byte-identical to the host/reference output."""
    from ..utils.trace import phase

    arr = np.frombuffer(data, dtype=np.uint8)
    with phase("device_histogram", arr.size):
        counts = histogram_on_device(arr)
    with phase("code_table"):
        table = build_code_table(counts, strict=strict)
    with phase("device_pack", arr.size):
        flat, nwords, bit_lens = encode_blocks_device(arr, table, block_bytes)
    with phase("stitch"):
        words, total_bits = stitch_flat_payload(flat, nwords, bit_lens)
    return serialize_header(table, arr.size) + words_to_bytes(words, total_bits)
