"""The GPU kernels (ops/kernels.py) against their XLA twins, bit for bit.

Every kernel runs here through the Pallas interpreter (``impl="interpret"``
/ ``interpret=True``) on the CPU; the test marked ``gpu`` compiles them for
the card and skips elsewhere. ``chip_smoke.py`` compares them at full size
on the card.
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from entreepy_tpu.format import build_code_table, compress_host, histogram, parse_header
from entreepy_tpu.format.fsm8 import build_byte_fsm
from entreepy_tpu.ops import decode8, kernels
from entreepy_tpu.ops.bitpack import code_table_cols, pack_blocks_jit
from entreepy_tpu.ops.decode8 import (
    _table_T_bf16, build_fused, byte_rows, bytes_to_cols, fsm8_decode,
    fsm8_decode_fused, state_tables, sync_exits,
)
from entreepy_tpu.ops.kernels import LANE_BLOCK, pack_blocks_kernel
from entreepy_tpu.utils.stitch import split_blocks

SKEWED = (b"a" * 500 + b"bcd") * 9  # 1-bit codes: up to 8 symbols per byte


def _prep(data: bytes, chunk: int):
    """.et body of ``data`` as int32[lanes, chunk] columns, plus its FSM and
    the body length."""
    et = compress_host(data, strict=False)
    hdr = parse_header(et)
    buf = np.frombuffer(et, np.uint8)[hdr.body_start :]
    lanes = max(1, -(-buf.size // chunk))
    padded = np.zeros(lanes * chunk, np.uint8)
    padded[: buf.size] = buf
    return bytes_to_cols(padded, lanes, chunk), build_byte_fsm(hdr.table), buf.size


def _same(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def _fused_both(cols, fsm, n_body, **kw):
    t_fused, m, mt, s = build_fused(fsm)
    args = (cols, _table_T_bf16(fsm), t_fused, jnp.int32(cols.shape[0]), m, mt, s)
    if kw.get("packed"):
        kw["n_valid"] = jnp.int32(n_body)
    want = fsm8_decode_fused(*args, **kw)
    got = fsm8_decode_fused(*args, impl="interpret", **kw)
    assert not bool(want[2])
    return m, want, got


@pytest.mark.parametrize("name", ["tiny_text", "macbeth", "midsummer"])
def test_fused_packed_kernel_matches_scan(name, request):
    """One-word rows where they fit (m <= 3, the production rule), the
    (m+1)-row layout otherwise (tiny_text's rarest codes are 1 bit short)."""
    cols, fsm, n_body = _prep(request.getfixturevalue(name), 64)
    packed = build_fused(fsm)[1] <= 3
    m, want, got = _fused_both(cols, fsm, n_body, packed=packed)
    assert want[0].ndim == (2 if packed else 3)
    _same(want, got)


def test_fused_unpacked_skewed_kernel_matches_scan():
    """m > 3 (skewed corpus, 1-bit codes): the unpacked (m+1)-row layout."""
    cols, fsm, n_body = _prep(SKEWED, 32)
    m, want, got = _fused_both(cols, fsm, n_body, packed=False)
    assert m > 3 and want[0].shape[1] == m + 1
    _same(want, got)


@pytest.mark.parametrize("k0", [0, 48])
def test_sync_pass_kernel_matches_scan(macbeth, k0):
    cols, fsm, _ = _prep(macbeth * 4, 64)
    tbl = _table_T_bf16(fsm)
    want = sync_exits(byte_rows(cols, "scan"), state_tables(tbl, "scan"), k0, "scan")
    got = sync_exits(byte_rows(cols, "interpret"), state_tables(tbl, "interpret"),
                     k0, "interpret")
    _same(want, got)


def test_state_mode_kernel_matches_scan(midsummer):
    """The state-emitting mode (sharded and host-expansion routes)."""
    cols, fsm, _ = _prep(midsummer[:30000], 64)
    tbl = _table_T_bf16(fsm)
    n = jnp.int32(cols.shape[0])
    want = fsm8_decode(cols, tbl, n)
    got = fsm8_decode(cols, tbl, n, impl="interpret")
    assert not bool(want[1])
    _same(want, got)


def test_entry0_chaining_across_tiles(midsummer):
    """Tile 1 starts from tile 0's last exit (the streaming decode's chain);
    the kernel must carry it exactly like the scan."""
    cols, fsm, n_body = _prep(midsummer[:30000], 64)
    t_fused, m, mt, s = build_fused(fsm)
    half = cols.shape[0] // 2
    tbl = _table_T_bf16(fsm)
    entry0 = None
    for tile in (cols[:half], cols[half:]):
        out = []
        for impl in ("scan", "interpret"):
            out.append(fsm8_decode_fused(
                tile, tbl, t_fused, jnp.int32(tile.shape[0]), m, mt, s,
                packed=True, n_valid=jnp.int32(tile.size), entry0=entry0,
                impl=impl,
            ))
        _same(out[0], out[1])
        entry0 = out[0][1][-1]


def test_ragged_lane_count(midsummer):
    """A lane count that is not a multiple of LANE_BLOCK: the tail program is
    masked, in every mode."""
    cols, fsm, n_body = _prep(midsummer[:21000], 24)
    assert cols.shape[0] % LANE_BLOCK
    _same(*_fused_both(cols, fsm, n_body, packed=True)[1:])
    tbl = _table_T_bf16(fsm)
    n = jnp.int32(cols.shape[0])
    _same(fsm8_decode(cols, tbl, n), fsm8_decode(cols, tbl, n, impl="interpret"))


def _pack_inputs(kind: str):
    rng = np.random.default_rng(3)
    if kind == "random":
        arr = rng.integers(0, 256, 40000, dtype=np.uint8)
    else:
        text = (b"the quick brown fox jumps over the lazy dog. " * 900)[:39001]
        arr = np.frombuffer(text, np.uint8)
    blocks, valid = split_blocks(arr, 512)
    if kind == "partial":
        # a partial last block plus empty padding lanes, 97 lanes in all
        pad = 97 - blocks.shape[0]
        blocks = np.concatenate([blocks, np.zeros((pad, 512), np.uint8)])
        valid = np.concatenate([valid, np.zeros(pad, np.int32)])
        assert valid[-pad - 1] < 512
    table = build_code_table(histogram(arr))
    codetbl = jnp.asarray(code_table_cols(table.codes, table.lengths), jnp.bfloat16)
    return jnp.asarray(blocks), jnp.asarray(valid), codetbl


@pytest.mark.parametrize("kind", ["text", "random", "partial"])
def test_pack_kernel_matches_scan(kind):
    blocks, valid, codetbl = _pack_inputs(kind)
    _same(pack_blocks_jit(blocks, valid, codetbl),
          pack_blocks_kernel(blocks, valid, codetbl, interpret=True))


def test_kernel_dispatch_by_platform(monkeypatch, macbeth):
    """The GPU platform selects the kernels, the CPU the scans — for the
    one-pass decode, the state decode and the pack."""
    seen = []
    real_fused, real_states = decode8.fsm8_decode_fused, decode8.fsm8_decode

    def spy(real):
        def f(*a, impl="scan", **k):
            seen.append(impl)
            return real(*a, **k)  # run the scan: no card here
        return f

    monkeypatch.setattr(decode8, "fsm8_decode_fused", spy(real_fused))
    monkeypatch.setattr(decode8, "fsm8_decode", spy(real_states))
    et = compress_host(macbeth)
    hdr = parse_header(et)
    body = et[hdr.body_start :]
    for backend in ("gpu", "cpu"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        decode8.decode_body_device_full(body, hdr.table, hdr.body_len)
        decode8.decode_body_device(body, hdr.table, hdr.body_len)
    assert seen == ["kernel", "kernel", "scan", "scan"]


def test_device_decode_through_kernels(monkeypatch, midsummer):
    """The whole on-device decode with the kernel passes (interpreted):
    untiled and streamed in tiles, both row layouts."""
    monkeypatch.setattr(decode8, "pass_impl", lambda: "interpret")
    for data in (midsummer[:40000], SKEWED):
        et = compress_host(data, strict=False)
        hdr = parse_header(et)
        body = et[hdr.body_start :]
        full = decode8.decode_body_device_full(body, hdr.table, hdr.body_len,
                                               chunk_bytes=64)
        tiled = decode8.decode_body_device_tiled(
            body, hdr.table, hdr.body_len, chunk_bytes=64, tile_lanes=96
        )
        assert bytes(full) == bytes(tiled) == data


def test_device_encode_through_kernel(monkeypatch, midsummer):
    """compress_device with the pack kernel (interpreted) is byte-identical
    to the host codec."""
    from entreepy_tpu.ops.encode import compress_device

    monkeypatch.setattr(kernels, "use_kernels", lambda: True)
    monkeypatch.setattr(kernels, "pack_blocks_kernel",
                        partial(pack_blocks_kernel, interpret=True))
    data = midsummer[:50000]
    assert compress_device(data) == compress_host(data)


@pytest.mark.parametrize("device_expand", [True, False])
def test_sharded_through_kernels(monkeypatch, macbeth, device_expand):
    """The sharded codec with the kernels (interpreted) inside shard_map on
    the 8-device virtual mesh: fused rows or per-byte states on decode, the
    pack on encode."""
    from entreepy_tpu.parallel import dist, make_mesh

    monkeypatch.setattr(dist, "pass_impl", lambda: "interpret")
    monkeypatch.setattr(dist, "use_kernels", lambda: True)
    monkeypatch.setattr(dist, "pack_blocks_kernel",
                        partial(pack_blocks_kernel, interpret=True))
    dist._pack_fn.cache_clear()
    dist._decode_fn.cache_clear()
    dist._decode_fused_fn.cache_clear()
    try:
        mesh = make_mesh()
        data = macbeth * 8
        et = dist.compress_sharded(data, mesh, block_bytes=64)
        assert et == compress_host(data)
        assert dist.decompress_sharded(
            et, mesh, chunk_bytes=32, device_expand=device_expand
        ) == data
    finally:
        dist._pack_fn.cache_clear()
        dist._decode_fn.cache_clear()
        dist._decode_fused_fn.cache_clear()


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; without it
    the cache goes to .jax_cache/ in the checkout."""
    from entreepy_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    try:
        path = compile_cache.use_compile_cache()
        assert path.endswith(".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.gpu
def test_kernels_on_gpu(gpu, midsummer):
    """Compiled for the card (no interpreter): the one-pass decode, the state
    decode and the pack equal their XLA twins."""
    cols, fsm, n_body = _prep(midsummer, 512)
    t_fused, m, mt, s = build_fused(fsm)
    tbl = _table_T_bf16(fsm)
    n = jnp.int32(cols.shape[0])
    args = (cols, tbl, t_fused, n, m, mt, s)
    nv = jnp.int32(n_body)
    _same(fsm8_decode_fused(*args, packed=True, n_valid=nv),
          fsm8_decode_fused(*args, packed=True, n_valid=nv, impl="kernel"))
    _same(fsm8_decode(cols, tbl, n), fsm8_decode(cols, tbl, n, impl="kernel"))
    blocks, valid, codetbl = _pack_inputs("partial")
    _same(pack_blocks_jit(blocks, valid, codetbl),
          pack_blocks_kernel(blocks, valid, codetbl))
