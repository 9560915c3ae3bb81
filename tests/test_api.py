"""Top-level API: auto-routing, file helpers, inspection."""

import numpy as np
import pytest

import entreepy_tpu as et
from entreepy_tpu.format import DegenerateInputError


def test_roundtrip_auto(midsummer):
    assert et.decompress(et.compress(midsummer)) == midsummer


def test_backends_byte_identical(macbeth):
    host = et.compress(macbeth, backend="host")
    assert et.compress(macbeth, backend="device") == host
    assert et.decompress(host, backend="device") == macbeth
    assert et.compress(macbeth, backend="sharded") == host
    assert et.decompress(host, backend="sharded") == macbeth


def test_auto_routes_sharded_on_multidevice(monkeypatch, midsummer):
    # Auto must reach the multi-chip path when >1 device is visible (the
    # conftest mesh has 8) and the size threshold is crossed.
    monkeypatch.setenv("ENTREEPY_DEVICE_MIN", "1024")
    from entreepy_tpu.api import _pick_backend

    assert _pick_backend(None, 1 << 20) == "sharded"
    assert _pick_backend(None, 10) == "host"
    assert et.decompress(et.compress(midsummer)) == midsummer


def test_unknown_backend_raises(macbeth):
    with pytest.raises(ValueError, match="unknown backend"):
        et.compress(macbeth, backend="gpu")


def test_strict_degenerate(macbeth):
    with pytest.raises(DegenerateInputError):
        et.compress(b"aaaa")
    packed = et.compress(b"aaaa", strict=False)
    assert et.decompress(packed) == b"aaaa"


def test_device_min_env(monkeypatch, macbeth):
    monkeypatch.setenv("ENTREEPY_DEVICE_MIN", "not-a-number")
    with pytest.warns(UserWarning, match="ENTREEPY_DEVICE_MIN"):
        assert et.decompress(et.compress(macbeth)) == macbeth


def test_auto_calibrated_routing(monkeypatch):
    """With the native runtime present, auto routing consults the one-shot
    H2D calibration only for inputs >= POD_DEVICE_MIN; a fast link routes
    those on-device, a slow one keeps them on host."""
    from entreepy_tpu import api, runtime

    monkeypatch.delenv("ENTREEPY_DEVICE_MIN", raising=False)
    monkeypatch.setattr(runtime, "available", lambda: True)

    # Small inputs must never pay the calibration probe.
    def boom():
        raise AssertionError("calibration probe ran for a small input")

    monkeypatch.setattr(api, "_h2d_fast", boom)
    assert api._pick_backend(None, api.POD_DEVICE_MIN - 1) == "host"

    # Fast link: >= POD_DEVICE_MIN goes on-device (sharded on this mesh).
    monkeypatch.setattr(api, "_h2d_fast", lambda: True)
    assert api._pick_backend(None, api.POD_DEVICE_MIN) == "sharded"
    # Slow link: host keeps everything.
    monkeypatch.setattr(api, "_h2d_fast", lambda: False)
    assert api._pick_backend(None, api.POD_DEVICE_MIN) == "host"

    # Without the native runtime the small fixed threshold applies.
    monkeypatch.setattr(runtime, "available", lambda: False)
    assert api._pick_backend(None, api.DEVICE_MIN_BYTES) == "sharded"
    assert api._pick_backend(None, 10) == "host"


def test_pod_expand_defaults(monkeypatch):
    """On the GPU the decode defaults go fully on-device and the per-byte
    passes are the kernels; on the CPU backend host expansion and the XLA
    scans stay the default. One predicate (``kernels.use_kernels``)
    decides all of them."""
    import jax

    from entreepy_tpu.ops import bitpack, decode8, kernels
    from entreepy_tpu.parallel import dist

    for backend, want in (("gpu", True), ("cpu", False)):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        assert kernels.use_kernels() is want
        assert decode8.device_e2e_default() is want
        assert dist.sharded_device_expand_default() is want
        assert decode8.pass_impl() == ("kernel" if want else "scan")

    # the pack dispatcher follows the same predicate
    seen = []
    monkeypatch.setattr(kernels, "pack_blocks_kernel",
                        lambda *a: seen.append("kernel"))
    monkeypatch.setattr(bitpack, "pack_blocks_jit",
                        lambda *a: seen.append("scan"))
    for backend in ("gpu", "cpu"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        bitpack.pack_blocks(None, None, None)
    assert seen == ["kernel", "scan"]


def test_decompress_device_routes_full_pipeline(monkeypatch, midsummer):
    """decompress_device must call decode_body_device_full when the default
    says on-device e2e (and still round-trip)."""
    from entreepy_tpu.ops import decode8

    calls = []
    real = decode8.decode_body_device_full

    def spy(*a, **kw):
        calls.append("full")
        return real(*a, **kw)

    monkeypatch.setattr(decode8, "decode_body_device_full", spy)
    monkeypatch.setattr(decode8, "device_e2e_default", lambda: True)
    packed = et.compress(midsummer, backend="host")
    assert decode8.decompress_device(packed) == midsummer
    assert calls == ["full"]


def test_file_helpers(tmp_path, macbeth):
    src = tmp_path / "m.txt"
    src.write_bytes(macbeth)
    out = et.compress_file(src)
    assert out == str(tmp_path / "m.txt.et")
    dec = et.decompress_file(out)
    assert dec == str(tmp_path / "decoded_m.txt")
    assert (tmp_path / "decoded_m.txt").read_bytes() == macbeth


def test_inspect(macbeth):
    packed = et.compress(macbeth)
    info = et.inspect(packed)
    assert info["original_bytes"] == len(macbeth)
    assert info["compressed_bytes"] == len(packed) == 374
    assert info["num_symbols"] == len(info["dictionary"])
    # every dictionary entry is (length, bit-string of that length)
    for sym, (length, bits) in info["dictionary"].items():
        assert 0 <= sym < 256 and len(bits) == length
    # prefix-free check over the reported dictionary
    codes = sorted(bits for _, bits in info["dictionary"].values())
    for a, b in zip(codes, codes[1:]):
        assert not b.startswith(a)


def test_version_consistent():
    """__version__ must track pyproject (it had drifted to 0.1.0 once)."""
    import re
    from pathlib import Path

    import entreepy_tpu

    text = (Path(__file__).parent.parent / "pyproject.toml").read_text()
    v = re.search(r'^version = "(.*)"$', text, re.M).group(1)
    assert entreepy_tpu.__version__ == v


def test_h2d_calibration_deadline(monkeypatch):
    """The H2D calibration runs inline, once per process, and only a GPU
    backend can pass it (the CPU backend never routes auto calls to the
    device on its own)."""
    import jax

    import entreepy_tpu.api as api

    calls = []
    monkeypatch.setattr(api, "_h2d_fast_cache", [])
    monkeypatch.setattr(api, "_h2d_probe", lambda: calls.append(1) or True)
    assert api._h2d_fast() is True
    assert api._h2d_fast() is True  # cached: no second probe
    assert calls == [1]

    monkeypatch.undo()
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert api._h2d_probe() is False
