"""End-to-end multi-host data path: 2-process jax.distributed CPU fit.

Each process loads ONLY its byte columns of the .bed
(multihost.load_bed_shard), sharded.prepare assembles the global array
from process-local buffers, and the fitted gamma matches a single-process
run of the SAME SPMD program (same mesh shape, same seeds) to float
tolerance.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_sim_bed(tmp_path, n, l, k, seed=0):
    from terastructure_tpu.data.bed import write_bed, write_bim, write_fam
    from terastructure_tpu.data.pack import pack2bit
    from terastructure_tpu.data.simulate import simulate_psd

    _, _, x = simulate_psd(n, l, k, seed=seed, missing_frac=0.02)
    stem = str(tmp_path / "sim")
    write_bed(stem + ".bed", pack2bit(np.ascontiguousarray(x.T)), n)
    write_fam(stem + ".fam", [f"i{i}" for i in range(n)])
    write_bim(stem + ".bim", [f"s{j}" for j in range(l)])
    return stem + ".bed"


def test_local_byte_cols_partition():
    """The per-process column ranges tile the padded width exactly."""
    from terastructure_tpu.parallel import mesh as meshlib
    from terastructure_tpu.parallel.multihost import host_byte_slice

    n_padded, ind = 64, 2
    w = n_padded // 4
    slices = [host_byte_slice(n_padded, ind, s) for s in range(ind)]
    assert slices[0][0] == 0 and slices[-1][1] == w
    for (a, b), (c, d) in zip(slices, slices[1:]):
        assert b == c


def _run_two_workers(tmp_path, bed, mode):
    port = _free_port()
    out = str(tmp_path / f"mh_{mode}")
    env = {k_: v for k_, v in os.environ.items()
           if k_ not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(port), bed, out, mode],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(o)
    for pid, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{o[-4000:]}"
    return np.load(out + ".0.npz"), np.load(out + ".1.npz")


def test_two_process_fit_matches_single(tmp_path):
    n, l, k = 64, 96, 3
    # ensure the native .so is built before workers race to import it
    try:
        import terastructure_tpu.native  # noqa: F401
    except ImportError:
        pass
    bed = _write_sim_bed(tmp_path, n, l, k)

    # --- single-process reference: same mesh shape, same loader ---
    from jax.sharding import NamedSharding, PartitionSpec as P

    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.parallel import mesh as meshlib
    from terastructure_tpu.parallel import multihost
    from terastructure_tpu.parallel.fit import fit_sharded

    cfg = SVIConfig(n=n, l=l, k=k, batch_size=16, rfreq=20, max_steps=60,
                    seed=0, kernel="dense", lambda_mode="local",
                    ind_shards=2, snp_shards=4)
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=2, snp=4))
    data_ref = multihost.load_bed_shard(bed, cfg, mesh, eval_snp_pool=16)
    assert data_ref.packed.shape[1] == (n + 3) // 4   # single proc: full
    res_ref = fit_sharded(cfg, data_ref, mesh=mesh)
    rep = jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))
    gamma_ref = np.asarray(rep(res_ref.state.gamma).addressable_data(0))

    # --- 2-process run, each with 4 virtual CPU devices ---
    r0, r1 = _run_two_workers(tmp_path, bed, "resident")
    # each worker really had a partial slice, and they tile the width
    assert int(r0["local_width"]) < (n + 3) // 4
    assert int(r0["byte_col_offset"]) == 0
    assert int(r1["byte_col_offset"]) == int(r0["local_width"])

    # same SPMD program + same seeds -> same fit
    np.testing.assert_allclose(r0["gamma"], gamma_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(r0["gamma"], r1["gamma"], rtol=1e-6, atol=1e-6)
    assert abs(float(r0["validation_ll"]) - res_ref.validation_ll) < 1e-4


def test_two_process_streaming_matches_single_stream(tmp_path):
    """The multi-process branch of ShardedBatchStream.batch (per-process
    addressable-block assembly, parallel/stream.py) — the exact data path
    a cross-host config-#5 run executes — must reproduce the
    single-process sharded STREAMING fit. Streaming
    == resident is covered bitwise by tests/test_sharded.py, so equality
    here closes the whole chain: 2-proc stream == 1-proc stream ==
    resident sharded."""
    n, l, k = 64, 96, 3
    try:
        import terastructure_tpu.native  # noqa: F401
    except ImportError:
        pass
    bed = _write_sim_bed(tmp_path, n, l, k)

    from jax.sharding import NamedSharding, PartitionSpec as P

    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.parallel import mesh as meshlib
    from terastructure_tpu.parallel import multihost
    from terastructure_tpu.parallel.fit import fit_sharded

    cfg = SVIConfig(n=n, l=l, k=k, batch_size=16, rfreq=20, max_steps=60,
                    seed=0, kernel="dense", lambda_mode="local",
                    ind_shards=2, snp_shards=4)
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=2, snp=4))
    data_ref = multihost.load_bed_shard(bed, cfg, mesh, eval_snp_pool=16)
    res_ref = fit_sharded(cfg, data_ref, mesh=mesh, stream=True)
    rep = jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))
    gamma_ref = np.asarray(rep(res_ref.state.gamma).addressable_data(0))

    r0, r1 = _run_two_workers(tmp_path, bed, "stream")
    assert int(r0["local_width"]) < (n + 3) // 4
    np.testing.assert_allclose(r0["gamma"], gamma_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(r0["gamma"], r1["gamma"], rtol=1e-6,
                               atol=1e-6)
    assert abs(float(r0["validation_ll"]) - res_ref.validation_ll) < 1e-4
