"""Top-level bytes-in/bytes-out API.

Four interchangeable backends produce byte-identical .et output:

* ``host``    — C++ native runtime (threaded block-parallel pack,
                self-sync chunk-parallel decode), numpy fallback.
* ``device``  — one accelerator (ops/): chunk-parallel byte-FSM decode and
                block-parallel bit-pack, hand-written kernels on the GPU.
* ``sharded`` — multi-device shard_map codec (entreepy_tpu.parallel):
                blocks/chunks data-parallel over a 1-D device mesh.
* ``None``    — auto. Host<->device transfer cost decides: a single
                compress/decompress call must move its input and output
                over PCIe, so with the native host runtime present auto
                keeps calls below ``POD_DEVICE_MIN`` on the host and routes
                larger ones to the device only when a one-shot H2D
                calibration (first call >= POD_DEVICE_MIN) shows a GPU
                behind a fast link; ``ENTREEPY_DEVICE_MIN`` overrides the
                threshold. Multi-device processes choose ``sharded`` over
                ``device``.
"""

from __future__ import annotations

import os

from .format import compress_host, decompress_host

DEVICE_MIN_BYTES = 1 << 16
# Auto-routing floor when the native host runtime exists: calls below this
# size are dominated by transfer+dispatch overhead the host codec doesn't
# pay.
POD_DEVICE_MIN = 8 << 20
# A device link must beat this to ever win an auto-routed call (PCIe gen3
# x16 does ~10 GB/s).
H2D_MIN_BYTES_PER_S = 100e6

_h2d_fast_cache: list = []  # [bool], measured once per process


def _h2d_probe() -> bool:
    """Time a 1 MiB host->device transfer. True only on the GPU backend
    (:func:`ops.kernels.use_kernels`) and a link that beats
    H2D_MIN_BYTES_PER_S."""
    import time

    import jax
    import numpy as np

    from .ops.kernels import use_kernels

    if not use_kernels():
        return False
    arr = np.ones(1 << 18, np.float32)  # 1 MiB
    jax.device_put(arr).block_until_ready()  # warm the transfer path
    t0 = time.perf_counter()
    jax.device_put(arr + 1).block_until_ready()
    dt = time.perf_counter() - t0
    return arr.nbytes / max(dt, 1e-9) >= H2D_MIN_BYTES_PER_S


def _h2d_fast() -> bool:
    """One-shot host->device bandwidth calibration, cached per process."""
    if not _h2d_fast_cache:
        _h2d_fast_cache.append(_h2d_probe())
    return _h2d_fast_cache[0]


def _device_min(n_bytes: int = 0) -> int:
    env = os.environ.get("ENTREEPY_DEVICE_MIN")
    if env is not None:
        try:
            return int(env)
        except ValueError:
            import warnings

            warnings.warn(
                f"ignoring non-integer ENTREEPY_DEVICE_MIN={env!r} (want bytes)",
                stacklevel=2,
            )
    from . import runtime

    if not runtime.available():
        return DEVICE_MIN_BYTES
    if n_bytes < POD_DEVICE_MIN:
        # Host wins below the best-case device threshold — don't pay the
        # calibration (or a jax import) for small calls.
        return 1 << 62
    return POD_DEVICE_MIN if _h2d_fast() else 1 << 62


def compress(data: bytes, *, strict: bool = True, backend: str | None = None,
             progress=None) -> bytes:
    """Compress ``data`` into a complete .et file (magic, dict, packed body).

    backend: None (auto), "host", "device", or "sharded".
    progress: optional ``(pct, msg)`` callback ticked at measured phase
    completions (host backend; other backends tick coarse boundaries).
    """
    choice = _pick_backend(backend, len(data))
    tick = progress or (lambda pct, msg: None)
    if choice == "sharded":
        from .parallel import compress_sharded

        tick(20, "Counting characters...")
        out = compress_sharded(data, strict=strict)
        tick(90, "Writing compressed text...")
        return out
    if choice == "device":
        from .ops.encode import compress_device

        tick(20, "Counting characters...")
        out = compress_device(data, strict=strict)
        tick(90, "Writing compressed text...")
        return out
    return compress_host(data, strict=strict, progress=progress)


def decompress(et: bytes, *, backend: str | None = None, progress=None) -> bytes:
    """Decompress a complete .et file back to the original bytes."""
    choice = _pick_backend(backend, len(et))
    tick = progress or (lambda pct, msg: None)
    if choice == "sharded":
        from .parallel import decompress_sharded

        tick(20, "Decoding text...")
        out = decompress_sharded(et)
        tick(90, "Writing decoded text...")
        return out
    if choice == "device":
        from .ops.decode8 import decompress_device

        tick(20, "Decoding text...")
        out = decompress_device(et)
        tick(90, "Writing decoded text...")
        return out
    return decompress_host(et, progress=progress)


def compress_file(src, dst=None, **kwargs) -> str:
    """Compress file ``src`` to ``dst`` (default: ``src + '.et'``, the
    reference CLI's naming). Returns the output path."""
    from pathlib import Path

    from .cli import default_output_name  # lazy: cli imports api

    src = Path(src)
    dst = Path(dst) if dst is not None else Path(default_output_name("compress", str(src)))
    dst.write_bytes(compress(src.read_bytes(), **kwargs))
    return str(dst)


def decompress_file(src, dst=None, **kwargs) -> str:
    """Decompress .et file ``src`` to ``dst`` (default: ``decoded_<name>``
    minus the .et suffix, the reference CLI's naming). Returns the path."""
    from pathlib import Path

    from .cli import default_output_name  # lazy: cli imports api

    src = Path(src)
    dst = Path(dst) if dst is not None else Path(default_output_name("decompress", str(src)))
    dst.write_bytes(decompress(src.read_bytes(), **kwargs))
    return str(dst)


def inspect(et: bytes) -> dict:
    """Parsed .et header as a dict: validates magic/version and returns
    sizes plus the symbol dictionary (symbol -> (length, code bits))."""
    from .format import parse_header

    hdr = parse_header(et)
    table = hdr.table
    dictionary = {
        int(s): (int(table.lengths[s]), format(int(table.codes[s]), f"0{int(table.lengths[s])}b"))
        for s in range(256)
        if table.lengths[s] > 0
    }
    return {
        "version": hdr.version,
        "num_symbols": table.num_symbols,
        "original_bytes": hdr.body_len,
        "compressed_bytes": len(et),
        "body_offset": hdr.body_start,
        "max_code_len": table.max_len,
        "min_code_len": table.min_len,
        "dictionary": dictionary,
    }


def _pick_backend(backend: str | None, n_bytes: int) -> str:
    if backend in ("host", "device", "sharded"):
        return backend
    if backend is not None:
        raise ValueError(
            f"unknown backend {backend!r} (want None, 'host', 'device', 'sharded')"
        )
    if n_bytes < _device_min(n_bytes):
        return "host"
    import jax

    return "sharded" if jax.device_count() > 1 else "device"
