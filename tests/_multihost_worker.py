"""Subprocess worker for the 2-process jax.distributed tests.

Usage: python _multihost_worker.py <process_id> <port> <bed> <out_prefix> \
           [resident|stream]

Each worker gets 4 virtual CPU devices (8 global across 2 processes),
initializes jax.distributed against a localhost coordinator, ingests ONLY
its own byte columns of the .bed via multihost.load_bed_shard, runs the
sharded fit on a (ind=2, snp=4) mesh, and writes its gathered gamma +
validation ll to <out_prefix>.<pid>.npz for the parent test to compare.

mode="stream" keeps the packed slice HOST-side and drives
parallel.stream.ShardedBatchStream's multi-process branch (per-process
addressable-block assembly) — the exact data path a literal config #5
(1M x 1M) run would execute across hosts.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.pop("JAX_PLATFORMS", None)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    pid, port, bed, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                           sys.argv[4])
    mode = sys.argv[5] if len(sys.argv) > 5 else "resident"
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}", num_processes=2,
        process_id=pid)
    assert jax.process_count() == 2
    assert jax.device_count() == 8
    assert len(jax.local_devices()) == 4

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.data.bed import read_fam, read_bim
    from terastructure_tpu.parallel import mesh as meshlib
    from terastructure_tpu.parallel import multihost
    from terastructure_tpu.parallel.fit import fit_sharded

    stem = os.path.splitext(bed)[0]
    n, l = len(read_fam(stem + ".fam")), len(read_bim(stem + ".bim"))
    cfg = SVIConfig(n=n, l=l, k=3, batch_size=16, rfreq=20, max_steps=60,
                    seed=0, kernel="dense", lambda_mode="local",
                    ind_shards=2, snp_shards=4)
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=2, snp=4))
    data = multihost.load_bed_shard(bed, cfg, mesh, eval_snp_pool=16)
    # each host must hold only its byte-column slice
    full_w = (n + 3) // 4
    assert data.packed.shape[1] < full_w, (
        f"worker {pid} loaded {data.packed.shape[1]} of {full_w} byte cols")
    res = fit_sharded(cfg, data, mesh=mesh, stream=(mode == "stream"))

    rep = jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))
    gamma = np.asarray(rep(res.state.gamma).addressable_data(0))
    np.savez(f"{out}.{pid}.npz", gamma=gamma,
             validation_ll=res.validation_ll,
             heldout_ll=res.heldout_ll,
             local_width=data.packed.shape[1],
             byte_col_offset=data.byte_col_offset)
    print(f"worker {pid} done", flush=True)


if __name__ == "__main__":
    main()
