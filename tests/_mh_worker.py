"""Worker for the real 2-process jax.distributed test (test_multihost.py).

Runs as: python tests/_mh_worker.py <coordinator> <num_procs> <pid> <datafile>
Each process brings up jax.distributed on the CPU backend (2 local virtual
devices -> a 4-device global mesh), runs the multihost codec, and checks the
result against the single-host reference bytes.
"""

import os
import sys


def main() -> int:
    coordinator, n_procs, pid, path = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
    )
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import jax

    # Pin the CPU platform and pick gloo: without it each process builds a
    # local-only CPU client and process_count stays 1.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    import entreepy_tpu.parallel.multihost as mh

    mh.init(coordinator_address=coordinator, num_processes=n_procs, process_id=pid)
    assert jax.process_count() == n_procs, jax.process_count()
    assert jax.device_count() == 2 * n_procs, jax.device_count()

    data = open(path, "rb").read()
    from entreepy_tpu.format import compress_host
    from entreepy_tpu.parallel import dist

    et = mh.compress(data)
    assert et == compress_host(data), "multihost .et differs from host codec"
    est = dict(dist.last_encode_stats)
    out = mh.decompress(et)
    assert out == data, "multihost round-trip mismatch"
    # Contract (VERDICT r2 item 4): each process fetches only its own
    # shards' states — D2H volume scales as 1/N of the compressed stream.
    dst = dict(dist.last_decode_stats)
    assert dst, "multihost decode did not take the per-process expansion path"
    frac = dst["fetched_states_bytes"] / dst["total_states_bytes"]
    assert frac <= 1.0 / n_procs + 1e-9, f"decode fetch not 1/N: {dst}"
    assert dst["local_symbols"] <= dst["n_symbols"], dst
    print(
        f"proc {pid}: ok ({len(data)} -> {len(et)} bytes, "
        f"decode fetch {frac:.2f} of states, encode fetch "
        f"{est.get('fetched_bytes', 0)} B)",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
