"""entreepy_tpu — a Huffman compression framework on JAX accelerators.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the Zig CLI
tool ``typio/entreepy`` (see SURVEY.md): reads and writes the ``.et`` format
bit-for-bit compatibly, but replaces the reference's serial tree/hash-map
design with array-oriented, block-parallel compute that runs on a GPU and
shards across devices and hosts.

Public API (mirrors the de-facto library contract fixed by the reference's
tests, ``test.zig:7-33``: pure bytes-in/bytes-out functions):

    >>> import entreepy_tpu as et
    >>> packed = et.compress(b"an example body of text")
    >>> et.decompress(packed)
    b'an example body of text'
"""

__version__ = "0.5.0"

from .api import (  # noqa: E402
    compress,
    compress_file,
    decompress,
    decompress_file,
    inspect,
)

__all__ = [
    "compress",
    "compress_file",
    "decompress",
    "decompress_file",
    "inspect",
    "__version__",
]
