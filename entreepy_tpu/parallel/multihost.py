"""Multi-host execution.

The reference has no distributed backend at all (SURVEY.md §2: no NCCL/MPI/
sockets; single process). Here multi-host runs the *same* shard_map programs
as single-host (dist.py) over a mesh whose 1-D block axis spans every
process's devices: XLA routes the collectives over the devices'
interconnect within a host and the network across hosts.

Communication per file (measured contract, tested in test_multihost.py):

* encode — one ``psum`` of the 256-bin histogram (1 KB); compaction runs
  shard-local ON DEVICE, so the only gathered encode data is each shard's
  ~compressed-size flat payload + per-block word counts/bit lengths
  (dist.compress_sharded; never the dense 4 B-per-input-byte slots)
* decode — one ``all_gather`` of per-chunk exit states (1 B/chunk) per sync
  pass; each process then fetches ONLY its own shards' state sequences
  (1/N of the compressed bytes over D2H) and emits only its own chunks'
  symbols; the full output assembles from one gather of tiny per-chunk
  metadata + the per-process symbol shards (dist._expand_multihost)

Usage (one process per host, standard JAX bring-up)::

    import entreepy_tpu.parallel.multihost as mh
    mh.init()                       # jax.distributed.initialize()
    et = mh.compress(data)          # every process passes the same bytes
    out = mh.decompress(et)         # result valid on every process

Tests exercise it with two gloo-coordinated CPU processes on one machine
(tests/test_multihost.py) and with the virtual-device CPU mesh.
"""

from __future__ import annotations

import jax

from .dist import compress_sharded, decompress_sharded
from .mesh import BLOCK_AXIS, make_mesh

_initialized = False


def init(**kwargs) -> None:
    """Initialize JAX distributed (idempotent). kwargs pass through to
    ``jax.distributed.initialize`` (coordinator_address, num_processes,
    process_id) — auto-detected only where a cluster environment says so
    (e.g. SLURM); a plain multi-GPU host needs them given.

    Failure semantics: an explicit bring-up (any kwargs) propagates every
    error. With no kwargs, only the specific "no cluster environment found"
    auto-detect ValueError is treated as a normal single-process run;
    anything else (bad coordinator, handshake timeout, double init) raises.
    """
    global _initialized
    if _initialized:
        return
    # NB: no jax.process_count()/jax.devices() before initialize — those
    # calls initialize the XLA backend and make distributed bring-up
    # impossible.
    if jax.distributed.is_initialized():
        _initialized = True  # someone already brought distributed up
        return
    # The string matches below pin failure semantics to jax's error wording;
    # a rewording would make the corresponding error propagate (fail loud)
    # rather than be swallowed.
    try:
        jax.distributed.initialize(**kwargs)
    except ValueError as e:
        if kwargs or "coordinator_address" not in str(e):
            raise
        # auto-detect found no cluster environment: single-process run
    except RuntimeError as e:
        # tolerate ONLY "the XLA backend is already up in this process" (a
        # single-process session that touched jax before init); a cluster-side
        # failure like a coordinator handshake timeout must propagate
        msg = str(e)
        if kwargs or not (
            "must be called before" in msg or "called once" in msg
        ):
            raise
    _initialized = True


def global_mesh(axis: str = BLOCK_AXIS):
    """1-D mesh over every device of every process."""
    return make_mesh(axis=axis)


def compress(data: bytes, **kwargs) -> bytes:
    """Compress over the global mesh. Every process must pass identical
    ``data`` and receives the identical .et result (the stitch is
    deterministic and runs on each host from the gathered shards)."""
    return compress_sharded(data, global_mesh(), **kwargs)


def decompress(et: bytes, **kwargs) -> bytes:
    """Decompress over the global mesh; same SPMD contract as compress."""
    return decompress_sharded(et, global_mesh(), **kwargs)
