"""The fused lambda-pass kernel (ops/lambda_pass.py) and the shared local
step (ops/local_step.py).

On the CPU the kernel runs through the Pallas interpreter and is held to
the plain reference, ops/stats_dense.lambda_stats, at float32. The
compiled kernel is checked against the same reference on a GPU by the
`gpu`-marked test at the end (and by chip_smoke.py at real widths).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data import GenotypeData, simulate_psd
from terastructure_tpu.ops import lambda_pass as lp
from terastructure_tpu.ops import local_step
from terastructure_tpu.ops import stats_dense as ops
from terastructure_tpu.svi import engine


def _problem(b, n, k, seed=0, missing=0.02):
    """Packed rows (B, W) with `missing` MISSING entries, u (4W, K) and
    t-factors (B, K) at realistic magnitudes."""
    rng = np.random.default_rng(seed)
    w = -(-n // 4)
    p = rng.uniform(0.05, 0.95, size=(b, 1))
    g = rng.binomial(2, p, size=(b, 4 * w)).astype(np.uint8)
    g[rng.random((b, 4 * w)) < missing] = 3
    g[:, n:] = 3                                # ragged N: padding MISSING
    g = g.reshape(b, w, 4)
    rows = (g[..., 0] | g[..., 1] << 2 | g[..., 2] << 4 | g[..., 3] << 6)
    gamma = 1.0 / k + rng.uniform(0, 40, size=(4 * w, k))
    lam = 1.0 + rng.uniform(0, 300, size=(b, k, 2))
    u = ops.exp_elog_theta(jnp.asarray(gamma, jnp.float32))
    t1, t0 = ops.exp_elog_beta(jnp.asarray(lam, jnp.float32))
    return jnp.asarray(rows.astype(np.uint8)), u, t1, t0


def _reference(rows, u, t1, t0, scale=1.0):
    a1, a0 = local_step.counts(rows)
    with jax.default_matmul_precision("highest"):
        l0, l1 = ops.lambda_stats(a1, a0, u, t1, t0)
    return np.asarray(scale * l0), np.asarray(scale * l1)


@pytest.mark.parametrize("scale", [1.0, 12.5])
@pytest.mark.parametrize("b,n", [(37, 1000), (16, 513)])
@pytest.mark.parametrize("k", [3, 8, 10])
def test_lambda_pass_matches_reference(k, b, n, scale):
    """B and N off the tiles, 2% missing, a stat_scale: the interpreted
    kernel equals the dense float32 statistic to rounding."""
    rows, u, t1, t0 = _problem(b, n, k, seed=k + b)
    l0, l1 = lp.lambda_pass(rows, lp.u_to_planes(u), t1, t0, scale,
                            interpret=True)
    assert l0.shape == l1.shape == (b, k)
    r0, r1 = _reference(rows, u, t1, t0, scale)
    np.testing.assert_allclose(np.asarray(l0), r0, rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(l1), r1, rtol=2e-5, atol=1e-4)


def test_lambda_pass_all_missing_rows_are_zero():
    rows, u, t1, t0 = _problem(8, 300, 3)
    rows = jnp.full_like(rows, 0xFF)
    l0, l1 = lp.lambda_pass(rows, lp.u_to_planes(u), t1, t0, interpret=True)
    assert float(jnp.abs(l0).max()) == 0.0 == float(jnp.abs(l1).max())


def test_lambda_pass_rejects_wide_k():
    rows, u, t1, t0 = _problem(8, 64, 17)
    with pytest.raises(ValueError, match="K <= 16"):
        lp.lambda_pass(rows, lp.u_to_planes(u), t1, t0, interpret=True)


@pytest.mark.parametrize("b,w,want", [
    (4096, 626, (32, 10, 2)),       # TGP batch: 320 programs
    (4096, 2048, (32, 16, 4)),      # big-N subsample: 512 programs
    (4096, 25000, (32, 17, 46)),    # config-5 share, full width
    (1024, 25000, (8, 66, 12)),     # per-card batch on a 1x4 mesh
    (37, 250, (1, 8, 1)),           # tiny: splits capped by chunks
])
def test_grid_fills_the_card(b, w, want):
    """Row tiles x column splits reach four programs per SM of an H100
    (132 SMs) where the width allows, the splits cover every column
    chunk, and no split is padding only."""
    tiles = lp.Tiles()
    nb, splits, chunks = lp.grid_shape(b, w, tiles, 132)
    assert (nb, splits, chunks) == want
    assert splits * chunks * tiles.cols >= w
    assert (splits - 1) * chunks * tiles.cols < w


@pytest.mark.parametrize("sms,want", [
    (78, (8, 38, 21)),
    (114, (8, 56, 14)),             # H100 PCIe
    (132, (8, 66, 12)),             # H100 SXM
])
def test_grid_follows_sm_count(sms, want):
    """The column splits follow the card's SM count: about per_sm
    programs per SM, short of it by less than one chunk's rounding."""
    tiles = lp.Tiles()
    nb, splits, chunks = lp.grid_shape(1024, 25000, tiles, sms)
    assert (nb, splits, chunks) == want
    assert nb * splits <= tiles.per_sm * sms < nb * (splits + 2)


def test_sm_count_off_gpu_is_h100():
    assert lp.sm_count() == 132


@pytest.mark.parametrize("tiles", [lp.Tiles(rows=64, cols=64),
                                   lp.Tiles(rows=16, cols=8, per_sm=1)])
def test_lambda_pass_other_tiles(tiles):
    """The sweep's other launch shapes compute the same statistic."""
    rows, u, t1, t0 = _problem(37, 1000, 8, seed=5)
    l0, l1 = lp.lambda_pass(rows, lp.u_to_planes(u), t1, t0, tiles=tiles,
                            interpret=True)
    r0, r1 = _reference(rows, u, t1, t0)
    np.testing.assert_allclose(np.asarray(l0), r0, rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(l1), r1, rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("kernel,dtype,k,interpret,want", [
    ("auto", "float32", 8, False, "dense"),
    ("auto", "bfloat16", 8, False, "dense"),
    ("dense", "float32", 8, False, "dense"),
    ("dense", "float32", 20, False, "dense"),
    ("triton", "float32", 8, True, "triton"),
    ("triton", "float32", 16, True, "triton"),
    ("triton", "float32", 8, False, ValueError),
    ("triton", "bfloat16", 8, True, ValueError),
    ("triton", "float32", 17, True, ValueError),
    ("mosaic", "float32", 8, False, ValueError),
])
def test_resolve_kernel(kernel, dtype, k, interpret, want):
    """One place decides the kernel: on the CPU 'auto' is dense, the GPU
    kernel only runs interpreted, float32 and K <= 16 only."""
    if want is ValueError:
        with pytest.raises(ValueError):
            lp.resolve_kernel(kernel, dtype, k, interpret=interpret)
    else:
        assert lp.resolve_kernel(kernel, dtype, k,
                                 interpret=interpret) == want


@pytest.mark.parametrize("kernel,dtype,k,want", [
    ("auto", "float32", 8, "triton"),
    ("auto", "float32", 16, "triton"),
    ("auto", "float32", 20, "dense"),       # wider than the kernel
    ("auto", "bfloat16", 8, "dense"),
    ("triton", "float32", 8, "triton"),
    ("triton", "float32", 20, ValueError),
])
def test_resolve_kernel_on_gpu(monkeypatch, kernel, dtype, k, want):
    """With a GPU backend, 'auto' takes the kernel only where it can run
    and falls back to dense for any K the kernel cannot take; an explicit
    'triton' at such K is an error."""
    monkeypatch.setattr(lp.jax, "default_backend", lambda: "gpu")
    if want is ValueError:
        with pytest.raises(ValueError, match="K <= 16"):
            lp.resolve_kernel(kernel, dtype, k)
    else:
        assert lp.resolve_kernel(kernel, dtype, k) == want


@pytest.mark.parametrize("accel", [False, True])
def test_local_solve_kernel_matches_dense(accel):
    """The whole local step — schedule, final statistics, gamma
    statistic — agrees between the two lambda passes."""
    b, n, k = 24, 700, 4
    rows, u, _, _ = _problem(b, n, k, seed=3)
    cfg = SVIConfig(n=n, l=64, k=k, local_iters=7, local_accel=accel)
    lamb0 = local_step.prior_lambda(cfg, b)
    got = {kern: local_step.step_stats(cfg, kern, rows, u, lamb0,
                                       interpret=True)
           for kern in ("dense", "triton")}
    for i in range(2):
        np.testing.assert_allclose(np.asarray(got["triton"][i]),
                                   np.asarray(got["dense"][i]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("w,ind,want", [
    (626, 1, 0),            # TGP: N < 32768, subsample off
    (8191, 1, 0),           # just below 4 x 2048 bytes
    (8192, 1, 2048),        # N = 32768: engages
    (25000, 1, 2048),       # config-5 width
    (12500, 2, 1024),       # per 'ind' shard: its share of the columns
])
def test_sub_columns(w, ind, want):
    assert local_step.sub_columns(SVIConfig(k=3), w, ind) == want


@pytest.mark.parametrize("kernel", ["dense", "triton"])
def test_subsample_matches_exact_solve(kernel):
    """The big-N iteration subsample (now backend-neutral) against the
    exact solve on the same minibatch: the exact final pass keeps the
    gamma statistic within the subsample's Monte-Carlo noise (a wrong
    W/sub scale or column/u mismatch would be O(1)), and it really
    differs from the exact solve."""
    b, n, k = 16, 4096, 3
    _, _, x = simulate_psd(n, 64, k, seed=4)
    data = GenotypeData.from_dense(x, validation_frac=0, heldout_frac=0,
                                   seed=4)
    rows = jnp.asarray(data.packed[:b])
    gamma = jnp.asarray(np.random.default_rng(4).uniform(0.5, 30, (n, k)),
                        jnp.float32)
    u = ops.exp_elog_theta(gamma)
    cfg = SVIConfig(n=n, l=64, k=k, local_sub_n=1024, local_tol=1e-7,
                    local_iters=12)
    sub = local_step.sub_columns(cfg, rows.shape[1])
    assert sub == 256
    lamb0 = local_step.prior_lambda(cfg, b)
    key = jax.random.PRNGKey(0)
    got = local_step.step_stats(cfg, kernel, rows, u, lamb0, sub_key=key,
                                sub_cols=sub, interpret=True)
    want = local_step.step_stats(cfg, "dense", rows, u, lamb0)
    g_sub, g_full = np.asarray(got[1]), np.asarray(want[1])
    np.testing.assert_allclose(g_sub, g_full, rtol=0.15, atol=1e-3)
    assert np.abs(g_sub - g_full).max() > 1e-6


@pytest.mark.parametrize("mode", ["local", "stored"])
def test_engine_step_kernel_matches_dense(mode):
    """engine.make_run_chunk on each kernel from one state: same
    trajectory to float32 rounding (stored mode also scatters lambda)."""
    n, l, k = 48, 128, 3
    _, _, x = simulate_psd(n, l, k, seed=8)
    data = GenotypeData.from_dense(x, validation_frac=0, heldout_frac=0,
                                   seed=8)
    packed = jnp.asarray(data.packed)
    out = {}
    for kern in ("dense", "triton"):
        cfg = SVIConfig(n=n, l=l, k=k, batch_size=16, seed=8, kernel=kern,
                        lambda_mode=mode)
        run = engine.make_run_chunk(cfg, 4, interpret=True)
        st = run(engine.init_state(cfg), packed)
        out[kern] = (np.asarray(st.gamma), np.asarray(st.lamb))
    for i in range(2):
        np.testing.assert_allclose(out["triton"][i], out["dense"][i],
                                   rtol=1e-3, atol=1e-3)


def test_stream_step_kernel_matches_resident():
    """The streaming step takes the same kernel path as the resident
    engine: fed the rows the engine samples, it lands on the same
    gamma (to float32 rounding: the two are separate programs)."""
    from terastructure_tpu.svi import stream

    n, l, k = 48, 96, 3
    _, _, x = simulate_psd(n, l, k, seed=9)
    data = GenotypeData.from_dense(x, validation_frac=0, heldout_frac=0,
                                   seed=9)
    packed = jnp.asarray(data.packed)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=16, seed=9, kernel="triton")
    st0 = engine.init_state(cfg)
    res = engine.make_step(cfg, interpret=True)(st0, packed)
    kb = jax.random.fold_in(st0.key, st0.t)
    rows = packed[engine._sample_batch(kb, l, cfg.batch_size)]
    st1 = stream.make_stream_step(cfg, l, interpret=True)(
        engine.init_state(cfg), rows)
    np.testing.assert_allclose(np.asarray(st1.gamma),
                               np.asarray(res.gamma), rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,k", [(4096, 2504, 8), (1024, 20000, 10)])
def test_compiled_kernel_matches_reference_on_gpu(gpu_device, b, n, k):
    """The kernel as compiled for the card, against the float32
    'highest' reference. Its dots run in TF32 (about 2^-11 relative per
    product), so the bound is 2e-3 relative."""
    rows, u, t1, t0 = _problem(b, n, k, seed=1)
    rows, u, t1, t0 = jax.device_put((rows, u, t1, t0), gpu_device)
    l0, l1 = lp.lambda_pass(rows, lp.u_to_planes(u), t1, t0)
    r0, r1 = _reference(rows, u, t1, t0)
    for got, want in ((l0, r0), (l1, r1)):
        rel = np.abs(np.asarray(got) - want) / (np.abs(want) + 1e-6)
        assert rel.max() < 2e-3, rel.max()
