"""Out-of-core streaming SVI (svi/stream.py): correctness on CPU.

The streamed fit must be (a) the same math as the resident engine given
the same rows, (b) bitwise deterministic in (seed, step) regardless of
prefetch timing, (c) backed by an ingest path that never materializes
the matrix in RAM (bed_to_packed_cache -> np.memmap).
"""

import numpy as np
import jax
import jax.numpy as jnp

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data import GenotypeData, simulate_psd
from terastructure_tpu.data.bed import bed_to_packed_cache, read_bed, write_bed, write_fam, write_bim
from terastructure_tpu.svi import engine, fit, stream
from terastructure_tpu.svi.postprocess import compute_lambda
from terastructure_tpu.svi.stream import compute_lambda_stream


def _data(n=300, l=256, k=3, seed=7):
    theta, beta, x = simulate_psd(n, l, k, seed=seed, missing_frac=0.03)
    return theta, GenotypeData.from_dense(
        x, validation_frac=0.01, heldout_frac=0.01, seed=seed)


def _cfg(data, **kw):
    base = dict(n=data.n, l=data.l, k=3, batch_size=64, seed=11,
                kernel="dense", lambda_mode="local", rfreq=50,
                max_steps=200)
    base.update(kw)
    return SVIConfig(**base)


def test_stream_step_matches_engine_math():
    """A stream step on given rows == the dense core + global update."""
    _, data = _data()
    cfg = _cfg(data)
    bs = stream.BatchStream(cfg, data.packed)
    rows = np.asarray(jax.device_get(bs.batch(0)))

    st = engine.init_state(cfg)
    out = stream.make_stream_step(cfg, data.l)(st, jnp.asarray(rows))

    from terastructure_tpu.data.pack import unpack2bit_jnp

    xb = unpack2bit_jnp(jnp.asarray(rows), cfg.n)
    lamb_b = jnp.stack(
        [jnp.full((cfg.batch_size, cfg.k), cfg.beta_a, jnp.float32),
         jnp.full((cfg.batch_size, cfg.k), cfg.beta_b, jnp.float32)],
        axis=-1)
    st2 = engine.init_state(cfg)
    _, gstat = engine.step_core_dense(cfg, st2.gamma, xb, lamb_b)
    want = engine._global_update(cfg, st2.gamma, gstat, st2.t, data.l)
    np.testing.assert_allclose(np.asarray(out.gamma), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    assert int(out.t) == 1


def test_stream_fit_deterministic_and_recovers():
    theta, data = _data()
    cfg = _cfg(data)
    r1 = fit(cfg, data, stream=True)
    r2 = fit(cfg, data, stream=True)
    np.testing.assert_array_equal(np.asarray(r1.state.gamma),
                                  np.asarray(r2.state.gamma))
    assert np.isfinite(r1.validation_ll)
    assert r1.heldout_ll is not None and np.isfinite(r1.heldout_ll)
    # loose recovery check: fitted theta correlates with truth
    from terastructure_tpu.models import psd
    from terastructure_tpu.utils import mean_abs_theta_error

    mae = mean_abs_theta_error(
        np.asarray(psd.theta_mean(r1.state.gamma)), theta)
    assert mae < 0.25, mae


def test_stream_grouped_sampling_runs():
    _, data = _data()
    cfg = _cfg(data, snp_group=8)
    res = fit(cfg, data, stream=True)
    assert np.isfinite(res.validation_ll)


def test_compute_lambda_stream_matches_resident():
    _, data = _data(n=123, l=96)
    cfg = _cfg(data, max_steps=50)
    gamma = engine.init_state(cfg).gamma + 0.3
    lam_res = compute_lambda(
        cfg, gamma, jnp.asarray(data.packed))          # resident, W=31
    lam_str = compute_lambda_stream(cfg, gamma, data.packed, block=32)
    np.testing.assert_allclose(np.asarray(lam_str), np.asarray(lam_res),
                               rtol=2e-4, atol=2e-4)


def test_bed_to_packed_cache_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    n, l = 57, 80                                      # ragged padding
    x = rng.integers(0, 4, size=(l, (n + 3) // 4 * 4)).astype(np.int8)
    from terastructure_tpu.data.pack import pack2bit

    packed = pack2bit(x[:, :n])
    bed = str(tmp_path / "t.bed")
    write_bed(bed, packed, n)
    write_fam(str(tmp_path / "t.fam"), [f"i{i}" for i in range(n)])
    write_bim(str(tmp_path / "t.bim"), [f"s{j}" for j in range(l)])

    want, _, _ = read_bed(bed)
    got, ind_ids, snp_ids = bed_to_packed_cache(
        bed, str(tmp_path / "t.cache.npy"), chunk_bytes=256)  # many chunks
    assert isinstance(got, np.memmap)
    np.testing.assert_array_equal(np.asarray(got), want)
    assert len(ind_ids) == n and len(snp_ids) == l

    # the carve mutates the memmap cache in place, not the .bed
    before = open(bed, "rb").read()
    data = GenotypeData.from_packed(np.asarray(got), n, seed=1,
                                    validation_frac=0.02, heldout_frac=0.02)
    assert open(bed, "rb").read() == before
    assert data.validation is not None and len(data.validation) > 0

def test_solve_lambda_blocks_memmap_input(tmp_path):
    """solve_lambda_blocks consumes a host memmap block-at-a-time and
    matches the device-array result (incl. a ragged final block)."""
    from terastructure_tpu.ops import stats_dense as ops
    from terastructure_tpu.svi.postprocess import solve_lambda_blocks

    _, data = _data(n=120, l=100)
    cfg = _cfg(data)
    u = ops.exp_elog_theta(engine.init_state(cfg).gamma[: data.n] + 0.3)
    mm = np.memmap(str(tmp_path / "pk.u8"), dtype=np.uint8, mode="w+",
                   shape=data.packed.shape)
    mm[:] = np.asarray(data.packed)
    mm.flush()
    lam_dev = solve_lambda_blocks(cfg, u, jnp.asarray(data.packed), block=32)
    lam_mm = solve_lambda_blocks(cfg, u, np.memmap(
        str(tmp_path / "pk.u8"), dtype=np.uint8, mode="r",
        shape=data.packed.shape), block=32)
    np.testing.assert_allclose(np.asarray(lam_mm), np.asarray(lam_dev),
                               rtol=1e-6, atol=1e-6)


# ---- sharded streaming (parallel/stream.py) ------------------------------

import pytest  # noqa: E402

needs8 = pytest.mark.skipif(jax.device_count() < 8,
                            reason="needs 8 (virtual) devices")


def _sharded_setup(n=64, l=96, k=3, seed=3, ind=2, snp=4, **cfg_kw):
    from terastructure_tpu.parallel import mesh as meshlib
    from terastructure_tpu.parallel import sharded

    theta, _, x = simulate_psd(n, l, k, seed=seed, missing_frac=0.02)
    data = GenotypeData.from_dense(x, validation_frac=0.02,
                                   heldout_frac=0.02, seed=seed)
    base = dict(n=n, l=l, k=k, batch_size=8 * snp, seed=seed,
                lambda_mode="local", rfreq=50, max_steps=200)
    base.update(cfg_kw)
    cfg = SVIConfig(**base)
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=ind, snp=snp))
    plan = sharded.make_plan(cfg, mesh)
    return theta, data, cfg, mesh, plan


@needs8
def test_sharded_stream_equals_resident_sharded_bitwise():
    """The streaming chunk (host-sampled, mesh-sharded batches) must be
    BIT-IDENTICAL to the resident sharded chunk: the host replays the
    device threefry schedule, so same rows -> same math -> same gamma."""
    from terastructure_tpu.parallel import sharded
    from terastructure_tpu.parallel.stream import make_sharded_stream_chunk

    _, data, cfg, mesh, plan = _sharded_setup()
    nsteps = 25

    _, packed_dev = sharded.prepare(cfg, data, mesh)
    st_res = sharded.init_sharded_state(cfg, plan, mesh)
    chunk_res = sharded.make_sharded_run_chunk(cfg, plan, mesh, nsteps)
    st_res = chunk_res(st_res, packed_dev)

    st_str = sharded.init_sharded_state(cfg, plan, mesh)
    chunk_str = make_sharded_stream_chunk(cfg, plan, mesh, nsteps)
    st_str = chunk_str(st_str, np.asarray(data.packed))

    assert int(st_str.t) == int(st_res.t) == nsteps
    np.testing.assert_array_equal(np.asarray(st_str.gamma),
                                  np.asarray(st_res.gamma))


@needs8
def test_sharded_stream_indices_match_device_draw():
    """ShardedBatchStream.indices reproduces the in-step threefry draw."""
    from terastructure_tpu.parallel import sharded
    from terastructure_tpu.parallel.stream import ShardedBatchStream

    _, data, cfg, mesh, plan = _sharded_setup()
    st = sharded.init_sharded_state(cfg, plan, mesh)
    bs = ShardedBatchStream(cfg, plan, mesh, np.asarray(data.packed))
    key_np = np.asarray(jax.device_get(st.key))
    got = bs.indices(key_np, 7)
    l_local = plan.l_padded // plan.snp
    for s in range(plan.snp):
        kb = jax.random.fold_in(jax.random.fold_in(st.key, 7), s)
        want = jax.random.randint(kb, (plan.batch_per_shard,), 0, l_local,
                                  jnp.int32)
        np.testing.assert_array_equal(got[s], np.asarray(want))


@needs8
def test_fit_sharded_stream_end_to_end():
    """Turnkey fit_sharded(stream=True): converging fit off a host
    matrix, heldout finite, lambda materialized at the end."""
    from terastructure_tpu.parallel import fit_sharded

    theta, data, cfg, mesh, plan = _sharded_setup(
        n=64, l=256, k=2, seed=6, max_steps=600, rfreq=100)
    res = fit_sharded(cfg, data, mesh=mesh, stream=True)
    assert np.isfinite(res.validation_ll)
    assert res.heldout_ll is not None and np.isfinite(res.heldout_ll)
    assert np.abs(np.asarray(res.state.lamb[: data.l]) - 1.0).max() > 1.0

    # matches the resident fit_sharded's quality on the same problem
    res2 = fit_sharded(cfg, data, mesh=mesh)
    assert abs(res.heldout_ll - res2.heldout_ll) < 0.05
