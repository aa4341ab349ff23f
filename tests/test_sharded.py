"""Sharded-vs-dense equivalence on an emulated 8-device CPU mesh.

SURVEY.md §4: assert sharded == single-device within tolerance. Exact
equality is not expected because the sharded sampler draws per-shard
minibatches (different RNG stream); instead we check:
  (a) machinery: a sharded step runs, shapes/shardings correct, finite;
  (b) statistics: with *identical* minibatches forced (batch = all SNPs,
      1 snp-shard), sharded over 'ind' matches dense bitwise-ish;
  (c) learning: the sharded engine improves validation ll.
"""

import os
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data import GenotypeData, simulate_psd
from terastructure_tpu.parallel import mesh as meshlib
from terastructure_tpu.parallel import sharded
from terastructure_tpu.svi import engine

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)


def _mk(n, l, k, seed, vfrac=0.0):
    _, _, x = simulate_psd(n, l, k, seed=seed)
    return GenotypeData.from_dense(x, validation_frac=vfrac, heldout_frac=0, seed=seed)


def test_sharded_step_runs_2d_mesh():
    n, l, k = 64, 96, 3
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=16, seed=1, lambda_mode="stored")
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=2, snp=4))
    data = _mk(n, l, k, 1)
    plan, packed = sharded.prepare(cfg, data, mesh)
    state = sharded.init_sharded_state(cfg, plan, mesh)
    step = jax.jit(sharded.make_sharded_step(cfg, plan, mesh))
    s1 = step(state, packed)
    assert int(s1.t) == 1
    g = np.asarray(s1.gamma)
    assert g.shape == (plan.n_padded, k)
    assert np.isfinite(g).all() and (g > 0).all()
    assert np.isfinite(np.asarray(s1.lamb)).all()


def test_ind_sharded_stats_match_dense():
    """Same minibatch (all SNPs, snp=1 shard) on ind=8: stats must agree
    with the dense engine's to float tolerance."""
    n, l, k = 64, 32, 3
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=l, seed=2, local_iters=4,
                    lambda_mode="stored")
    data = _mk(n, l, k, 2)

    # Dense reference step on the full batch, fixed idx = arange(L).
    packed_d = jnp.asarray(data.packed)
    from terastructure_tpu.data.pack import unpack2bit_jnp
    xb = unpack2bit_jnp(packed_d, n)                     # (L, N)
    state0 = engine.init_state(cfg)
    idx = jnp.arange(l, dtype=jnp.int32)
    g_dense, lam_dense = engine.step_on_batch(
        cfg, state0.gamma, state0.lamb, xb, idx, jnp.int32(0))

    # Sharded: ind=8, snp=1 — force the same full batch by replacing the
    # sampler-free path: batch covers every SNP since B = L = l_padded.
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=8, snp=1))
    plan, packed_s = sharded.prepare(cfg, data, mesh)
    assert plan.l_padded == l
    state_s = sharded.init_sharded_state(cfg, plan, mesh)
    # Same init despite padding (n divisible by 32 here => no padding).
    assert plan.n_padded == n
    np.testing.assert_allclose(
        np.asarray(state_s.gamma), np.asarray(state0.gamma), rtol=1e-6)

    step = jax.jit(sharded.make_sharded_step(cfg, plan, mesh))
    s1 = step(state_s, packed_s)

    # The sharded sampler draws randomly; with B == L == l_local every
    # draw set is a multiset of all SNPs only if we forced idx — instead
    # compare against a dense run using the *sharded* minibatch. Recover
    # that minibatch from the sharded RNG recipe.
    kb = jax.random.fold_in(jax.random.fold_in(state_s.key, state_s.t), 0)
    idx_s = jax.random.randint(kb, (plan.batch_per_shard,), 0, l, dtype=jnp.int32)
    g_ref, lam_ref = engine.step_on_batch(
        cfg, state0.gamma, state0.lamb, xb[idx_s], idx_s, jnp.int32(0))

    np.testing.assert_allclose(np.asarray(s1.gamma), np.asarray(g_ref),
                               rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s1.lamb), np.asarray(lam_ref),
                               rtol=5e-4, atol=1e-5)


def test_sharded_learning_improves_ll():
    n, l, k = 64, 128, 3
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=32, seed=3, lambda_mode="stored")
    data = _mk(n, l, k, 3, vfrac=0.02)
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=2, snp=4))
    plan, packed = sharded.prepare(cfg, data, mesh)
    state = sharded.init_sharded_state(cfg, plan, mesh)

    val = data.validation
    args = (jnp.asarray(val.ind_idx), jnp.asarray(val.snp_idx), jnp.asarray(val.x))
    ll0 = float(engine.entry_loglik(state.gamma, state.lamb, *args))

    chunk = sharded.make_sharded_run_chunk(cfg, plan, mesh, 150)
    state = chunk(state, packed)
    ll1 = float(engine.entry_loglik(state.gamma, state.lamb, *args))
    assert ll1 > ll0, (ll0, ll1)


def test_padding_individuals_and_snps():
    """Ragged N and L: padded entries must not corrupt statistics."""
    n, l, k = 61, 93, 2          # awkward sizes
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=16, seed=4, lambda_mode="stored")
    data = _mk(n, l, k, 4)
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=2, snp=4))
    plan, packed = sharded.prepare(cfg, data, mesh)
    assert plan.n_padded % 8 == 0 and plan.l_padded % 4 == 0
    state = sharded.init_sharded_state(cfg, plan, mesh)
    chunk = sharded.make_sharded_run_chunk(cfg, plan, mesh, 20)
    s = chunk(state, packed)
    g = np.asarray(s.gamma)
    assert np.isfinite(g).all() and (g > 0).all()
    # Padding individuals receive no data: their gamma shrinks toward the
    # prior alpha under the natural-gradient decay.
    pad_g = g[n:]
    assert pad_g.shape[0] == plan.n_padded - n
    assert np.abs(pad_g - cfg.alpha_value).max() < 1.0


def test_sharded_local_mode_runs():
    """lambda_mode='local' sharded step: gamma learns, lamb untouched."""
    n, l, k = 64, 128, 3
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=32, seed=5, lambda_mode="local")
    data = _mk(n, l, k, 5, vfrac=0.02)
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=2, snp=4))
    plan, packed = sharded.prepare(cfg, data, mesh)
    state = sharded.init_sharded_state(cfg, plan, mesh)
    lamb0 = np.asarray(state.lamb).copy()
    chunk = sharded.make_sharded_run_chunk(cfg, plan, mesh, 100)
    s = chunk(state, packed)
    np.testing.assert_array_equal(np.asarray(s.lamb), lamb0)  # derived state
    # gamma-based eval via lambda recomputation improves
    val = data.validation
    uniq, inv = np.unique(val.snp_idx, return_inverse=True)
    w = data.packed.shape[1]
    f = engine.make_entry_loglik_recompute(
        cfg, data.packed[uniq], inv.astype(np.int32), val.ind_idx, val.x)
    s0 = sharded.init_sharded_state(cfg, plan, mesh)
    ll0 = float(f(s0.gamma[:n]))
    ll1 = float(f(s.gamma[:n]))
    assert ll1 > ll0, (ll0, ll1)


def test_fit_sharded_end_to_end():
    """Turnkey fit_sharded on the emulated mesh, local lambda mode."""
    from terastructure_tpu.parallel import fit_sharded

    n, l, k = 64, 256, 2
    _, _, x = simulate_psd(n, l, k, seed=6)
    data = GenotypeData.from_dense(x, validation_frac=0.02,
                                   heldout_frac=0.02, seed=6)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=32, rfreq=100, max_steps=600,
                    seed=6, ind_shards=2, snp_shards=4)
    res = fit_sharded(cfg, data)
    assert np.isfinite(res.validation_ll)
    assert res.heldout_ll is not None and np.isfinite(res.heldout_ll)
    # local mode materialized lambda at the end
    assert np.abs(np.asarray(res.state.lamb[:l]) - 1.0).max() > 1.0


def test_sharded_fit_compiles_chunk_once():
    """The chunk runner's second call reuses the first call's program:
    the initial step counter and key are replicated over the mesh, as
    the runner returns them (a second compile per fit otherwise)."""
    from terastructure_tpu.parallel import fit_sharded

    compiled = []

    def listen(event, duration, **kw):
        if (event == "/jax/core/compile/backend_compile_duration"
                and "run_chunk" in str(kw.get("fun_name"))):
            compiled.append(kw.get("fun_name"))

    jax.monitoring.register_event_duration_secs_listener(listen)
    n, l, k = 64, 256, 3
    data = _mk(n, l, k, 8, vfrac=0.02)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=32, rfreq=10, max_steps=30,
                    seed=8)
    try:
        res = fit_sharded(cfg, data, mesh=meshlib.make_mesh(
            meshlib.MeshSpec(ind=2, snp=2)))
    finally:
        jax.monitoring.unregister_event_duration_listener(listen)
    assert res.steps == 30
    assert compiled == ["jit(run_chunk)"], compiled


def test_fused_sharded_matches_dense_sharded():
    """The fused GPU kernel (interpreted) runs under shard_map on a 1x4
    mesh and agrees with the dense sharded path on the same minibatch
    stream (same fold_in keys)."""
    n, l, k = 64, 96, 3
    data = _mk(n, l, k, 7)
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=1, snp=4))
    outs = {}
    for kern in ("dense", "triton"):
        cfg = SVIConfig(n=n, l=l, k=k, batch_size=32, seed=7, kernel=kern,
                        lambda_mode="local")
        plan, packed = sharded.prepare(cfg, data, mesh)
        state = sharded.init_sharded_state(cfg, plan, mesh)
        step = jax.jit(sharded.make_sharded_step(cfg, plan, mesh,
                                                 interpret=True))
        for _ in range(3):
            state = step(state, packed)
        outs[kern] = np.asarray(state.gamma)[:n]
    np.testing.assert_allclose(outs["triton"], outs["dense"],
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("build", ["step", "chunk", "compute_lambda"])
def test_sharded_triton_refused_off_gpu(build):
    """kernel='triton' on the CPU mesh without the interpreter is an
    error in every sharded builder — never a silent fallback."""
    n, l, k = 64, 96, 3
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=16, seed=1, kernel="triton")
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=2, snp=4))
    plan = sharded.make_plan(cfg, mesh)
    builder = {
        "step": lambda: sharded.make_sharded_step(cfg, plan, mesh),
        "chunk": lambda: sharded.make_sharded_run_chunk(cfg, plan, mesh, 2),
        "compute_lambda": lambda: sharded.make_sharded_compute_lambda(
            cfg, plan, mesh),
    }[build]
    with pytest.raises(ValueError, match="GPU"):
        builder()


@pytest.mark.parametrize("accel,tol", [(False, 2e-3), (True, 2e-3)])
def test_pallas_sharded_matches_dense_sharded(accel, tol):
    """The fused kernel's per-pass statistics under shard_map with
    ind=2 (psum('ind') outside the kernel, between passes) == the dense
    sharded path on the same plan/stream, stored lambda mode."""
    n, l, k = 64, 64, 3
    data = _mk(n, l, k, 11)
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=2, snp=2))
    cfg0 = SVIConfig(n=n, l=l, k=k, batch_size=32, seed=11,
                     lambda_mode="stored", local_iters=6, local_accel=accel)
    plan, packed = sharded.prepare(cfg0, data, mesh)
    state0 = sharded.init_sharded_state(cfg0, plan, mesh)

    outs = {}
    for kern in ("triton", "dense"):
        cfg = cfg0.replace(kernel=kern)
        step = jax.jit(sharded.make_sharded_step(cfg, plan, mesh,
                                                 interpret=True))
        s = state0
        for _ in range(2):
            s = step(s, packed)
        outs[kern] = (np.asarray(s.gamma)[:n], np.asarray(s.lamb)[:l])
    np.testing.assert_allclose(outs["triton"][0], outs["dense"][0],
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(outs["triton"][1], outs["dense"][1],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kernel", ["dense", "triton"])
@pytest.mark.parametrize("accel,tol", [(False, 1e-4), (True, 5e-3)])
def test_sharded_compute_lambda_matches_unsharded(accel, tol, kernel):
    """compute-beta core under shard_map (ind=2 x snp=2, psum'ed
    lambda stats) == the single-device post-pass.

    Plain solve: tight tolerance (same math, different summation
    order). Accel: the Aitken step d1^2/(d0-d1) amplifies the psum-vs-
    single-dot f32 ordering noise near the rmax clamp; with the
    unified solve_schedule (no tol-exit mismatch possible) the
    measured divergence is 6/288 coords at max rel 3e-3 — bound set to
    measured + margin. The sharded side runs each kernel (the GPU
    kernel interpreted); the reference is the dense post-pass."""
    from terastructure_tpu.svi.postprocess import compute_lambda

    n, l, k = 64, 48, 3
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=16, seed=13, local_iters=8,
                    local_accel=accel)
    data = _mk(n, l, k, 13)
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=2, snp=2))
    plan, packed = sharded.prepare(cfg, data, mesh)
    state = sharded.init_sharded_state(cfg, plan, mesh)

    fn = sharded.make_sharded_compute_lambda(
        cfg.replace(kernel=kernel), plan, mesh, block=8, interpret=True)
    lamb_sh = np.asarray(fn(state.gamma, packed))[:l]

    gamma_host = np.asarray(state.gamma)[:n]
    lamb_ref = np.asarray(compute_lambda(
        cfg, jnp.asarray(gamma_host), np.asarray(data.packed), block=8))
    np.testing.assert_allclose(lamb_sh, lamb_ref, rtol=tol, atol=tol)


def test_compiled_step_collectives_match_dataflow_model():
    """The sharded step's compiled HLO must contain exactly the
    collectives the design promises (benchmarks/comm_model.py): one
    (N/I, K) all-reduce over 'snp' for the gamma statistic and
    2x(B/S, K) tuple all-reduces over 'ind' for the local-solve lambda
    stats — one inside the while body plus, under the accel default,
    one per UNROLLED tail pass (the Aitken schedule unrolls the last
    two passes; statically visible, dataflow identical). Nothing else:
    guards against accidental resharding/communication creep."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmarks.comm_model import measured_collective_bytes

    n, k, batch, ind, snp = 256, 4, 128, 2, 4
    meas = measured_collective_bytes(n=n, l=1024, k=k, batch=batch,
                                     ind=ind, snp=snp)
    ar = meas.get("all-reduce", {})
    gamma = (n // ind) * k * 4
    lam_pair = 2 * (batch // snp) * k * 4
    # default cfg: accel on -> 1 while-body + 2 unrolled-tail lambda ARs
    assert ar.get("count") == 4, meas
    assert ar["bytes"] == gamma + 3 * lam_pair, meas
    for kind in ("all-gather", "collective-permute", "reduce-scatter"):
        assert kind not in meas, meas


def test_gamma_psum_bf16_rounding_reaches_compiled_hlo():
    """cfg.gamma_psum_dtype='bf16' must survive into the optimized
    program: the compiled step contains a bf16 rounding of the
    (N/I, K)-shaped gamma statistic feeding its psum('snp'), and the
    collective inventory is otherwise unchanged (counts and the f32
    lambda pairs). NOTE the emulated CPU backend PROMOTES bf16
    collectives back to f32 on the wire (BFloat16Normalization —
    observed: `f32 all-reduce(convert_convert_fusion)`), so the
    payload-halving itself is a property of the accelerator's lowering
    that this environment cannot compile-check; what
    IS checkable everywhere — and what changes numerics — is the
    rounding boundary, asserted here, plus the quality test below."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmarks.comm_model import measured_collective_bytes

    n, k, batch, ind, snp = 256, 4, 128, 2, 4
    meas = measured_collective_bytes(n=n, l=1024, k=k, batch=batch,
                                     ind=ind, snp=snp,
                                     gamma_psum_dtype="bf16")
    ar = meas.get("all-reduce", {})
    assert ar.get("count") == 4, meas
    # the bf16 rounding of the (N/I, K) statistic is in the program
    assert meas.get("gamma_bf16_round") is True, meas
    for kind in ("all-gather", "collective-permute", "reduce-scatter"):
        assert kind not in meas, meas
    # and with the default f32 the rounding must NOT appear
    meas32 = measured_collective_bytes(n=n, l=1024, k=k, batch=batch,
                                       ind=ind, snp=snp)
    assert meas32.get("gamma_bf16_round") is False, meas32


def test_gamma_psum_bf16_trajectory_quality():
    """bf16 gamma reduction vs exact f32 on the 8-dev mesh: the
    rounding (~2^-8 relative, accumulated over snp shards) must stay
    far below the minibatch noise the Robbins-Monro update averages
    over — gamma trajectories agree to ~1e-2 relative after a chunk of
    steps and the validation ll matches to MC error. Hardware quality
    A/B at fit scale: benchmarks/gamma_bf16_ab.py."""
    n, l, k = 512, 256, 3
    _, _, x = simulate_psd(n, l, k, seed=11)
    data = GenotypeData.from_dense(x, validation_frac=0.02,
                                   heldout_frac=0, seed=11)
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=2, snp=4))
    base = dict(n=n, l=l, k=k, batch_size=64, seed=11,
                lambda_mode="local")

    val = data.validation
    uniq, inv = np.unique(val.snp_idx, return_inverse=True)
    gams, lls = {}, {}
    for dt in ("f32", "bf16"):
        cfg = SVIConfig(**base, gamma_psum_dtype=dt)
        plan = sharded.make_plan(cfg, mesh)
        _, packed = sharded.prepare(cfg, data, mesh)
        st = sharded.make_sharded_run_chunk(cfg, plan, mesh, 120)(
            sharded.init_sharded_state(cfg, plan, mesh), packed)
        gams[dt] = np.asarray(st.gamma)[:n]
        score = engine.make_entry_loglik_recompute(
            cfg, data.packed[uniq], inv.astype(np.int32),
            val.ind_idx, val.x)
        lls[dt] = float(score(st.gamma[:n]))
    assert np.isfinite(gams["bf16"]).all()
    np.testing.assert_allclose(gams["bf16"], gams["f32"], rtol=2e-2,
                               atol=2e-2)
    assert abs(lls["bf16"] - lls["f32"]) < 5e-3, lls


# ---- big-N branches on the CPU mesh --------------------------------------


@pytest.mark.parametrize("kernel", ["dense", "triton"])
def test_sharded_bign_subsample_matches_full_solve(kernel):
    """The local_sub_n iteration-subsample branch (the config-#5
    multi-device hot path) engages on the 8-device CPU mesh with
    lowered thresholds and is equivalent to the full-N solve: one step's
    gamma agrees to ~the subsample's MC noise (a wrong N/Ns scale or a
    broken shard split would show up as O(1) relative error), and a
    short fit reaches the same validation log-likelihood."""
    n, l, k = 4096, 64, 3
    _, _, x = simulate_psd(n, l, k, seed=9)
    data = GenotypeData.from_dense(x, validation_frac=0.02,
                                   heldout_frac=0, seed=9)
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=2, snp=4))
    from terastructure_tpu.ops import local_step

    base = dict(n=n, l=l, k=k, batch_size=32, seed=9, kernel=kernel,
                lambda_mode="local", local_iters=12, local_tol=1e-7,
                local_refine_full=True)
    cfg_sub = SVIConfig(**base, local_sub_n=1024)
    cfg_full = SVIConfig(**base, local_sub_n=0)

    plan = sharded.make_plan(cfg_sub, mesh)
    # preconditions for the subsample branch at these thresholds
    wl = plan.n_padded // 4 // plan.ind
    assert local_step.sub_columns(cfg_sub, wl, plan.ind) == 128, wl

    val = data.validation
    uniq, inv = np.unique(val.snp_idx, return_inverse=True)
    score = engine.make_entry_loglik_recompute(
        cfg_full, data.packed[uniq], inv.astype(np.int32),
        val.ind_idx, val.x, interpret=True)

    one, lls = {}, {}
    for tag, cfg in (("sub", cfg_sub), ("full", cfg_full)):
        _, packed = sharded.prepare(cfg, data, mesh)
        st = sharded.init_sharded_state(cfg, plan, mesh)
        one[tag] = np.asarray(jax.jit(sharded.make_sharded_step(
            cfg, plan, mesh, interpret=True))(st, packed).gamma)
        st = sharded.make_sharded_run_chunk(cfg, plan, mesh, 150,
                                            interpret=True)(
            sharded.init_sharded_state(cfg, plan, mesh), packed)
        lls[tag] = float(score(st.gamma[:n]))
    assert np.isfinite(one["sub"]).all() and (one["sub"] > 0).all()
    # per-step: same update up to subsample MC noise (scale errors are O(1))
    np.testing.assert_allclose(one["sub"], one["full"], rtol=0.15)
    # trajectory: equal quality within a small ll margin
    assert abs(lls["sub"] - lls["full"]) < 0.01, lls


def test_sharded_stream_bitwise_vs_resident_kernel():
    """The streaming chunk replays the resident step's sample on the
    HOST with numpy fancy indexing; with the fused kernel (interpreted)
    on both sides, equal gamma proves the device gather fetched exactly
    the sampled rows and the kernel saw the same bytes."""
    from terastructure_tpu.parallel.stream import make_sharded_stream_chunk

    n, l, k = 512, 1024, 3
    _, _, x = simulate_psd(n, l, k, seed=10)
    data = GenotypeData.from_dense(x, validation_frac=0, heldout_frac=0,
                                   seed=10)
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=2, snp=4))
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=64, seed=10,
                    kernel="triton", lambda_mode="local", local_iters=4)
    plan = sharded.make_plan(cfg, mesh)

    nsteps = 3
    _, packed = sharded.prepare(cfg, data, mesh)
    st_res = sharded.init_sharded_state(cfg, plan, mesh)
    st_res = sharded.make_sharded_run_chunk(cfg, plan, mesh, nsteps,
                                            interpret=True)(st_res, packed)

    st_str = sharded.init_sharded_state(cfg, plan, mesh)
    st_str = make_sharded_stream_chunk(cfg, plan, mesh, nsteps,
                                       interpret=True)(
        st_str, np.asarray(data.packed))

    np.testing.assert_array_equal(np.asarray(st_str.gamma),
                                  np.asarray(st_res.gamma))


# ---- pipelined chunk runner (comm overlap) --------------------------------


def test_pipelined_chunk_matches_per_step():
    """make_sharded_run_chunk software-pipelines the gamma all-reduce
    against the next step's gather; the reordering must be EXACT —
    bitwise-equal trajectories vs per-step stepping (and vs the
    overlap=False fallback), stored-lambda mode so the lambda scatter
    path is exercised too."""
    n, l, k = 64, 96, 3
    data = _mk(n, l, k, 7)
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=2, snp=4))
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=32, seed=7,
                    lambda_mode="stored")
    plan, packed = sharded.prepare(cfg, data, mesh)

    step = jax.jit(sharded.make_sharded_step(cfg, plan, mesh))
    s = sharded.init_sharded_state(cfg, plan, mesh)
    for _ in range(5):
        s = step(s, packed)

    chunk = sharded.make_sharded_run_chunk(cfg, plan, mesh, 5)
    s2 = chunk(sharded.init_sharded_state(cfg, plan, mesh), packed)
    assert int(s2.t) == int(s.t) == 5
    np.testing.assert_array_equal(np.asarray(s.gamma), np.asarray(s2.gamma))
    np.testing.assert_array_equal(np.asarray(s.lamb), np.asarray(s2.lamb))

    plain = sharded.make_sharded_run_chunk(cfg, plan, mesh, 5,
                                           overlap=False)
    s3 = plain(sharded.init_sharded_state(cfg, plan, mesh), packed)
    np.testing.assert_array_equal(np.asarray(s.gamma), np.asarray(s3.gamma))


def test_chunk_gather_independent_of_gamma_allreduce():
    """HLO-level pin of the overlap property: in the compiled pipelined
    chunk's while body, the next-step rows producer must NOT be
    reachable from the gamma all-reduce — the structural requirement
    for the latency-hiding scheduler to span the collective across the
    gather."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmarks.comm_model import overlap_report

    rep = overlap_report(n=256, l=1024, k=4, batch=128, ind=2, snp=4)
    assert rep["gamma_ar"] is not None, rep
    assert rep["rows_producers"], rep
    assert rep["rows_depend_on_allreduce"] is False, rep


# ---- default-config big-N path golden -------------------------------------


@pytest.mark.parametrize("kernel", ["dense", "triton"])
def test_sharded_default_bign_path_matches_golden(kernel):
    """The EXACT big-N path — shipping defaults: accel7, local_sub_n=8192
    engaged, refine off, each lambda-pass kernel (the GPU kernel
    interpreted on CPU) — against a dense golden that replicates
    ops/local_step's math under sharding (per-ind-shard column
    subsample, N/Ns scaling, psum'ed lambda stats, unified accel
    schedule, exact full-N final stats) from the same threefry draws.
    A wrong subsample key fold, stat scale, or schedule shows up as
    O(1) error; kernel-vs-dense f32 noise is ~1e-5."""
    from terastructure_tpu.data.pack import packed_width, unpack2bit
    from terastructure_tpu.ops import stats_dense as ops

    n, l, k, b = 32768, 64, 3, 32
    ind, snp = 2, 4
    data = _mk(n, l, k, 21)
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=ind, snp=snp))
    from terastructure_tpu.ops import local_step

    cfg = SVIConfig(n=n, l=l, k=k, batch_size=b, seed=21,
                    kernel=kernel, lambda_mode="local")
    # shipping defaults actually engaged at this shape
    assert cfg.local_accel and cfg.local_iters == 7
    assert cfg.local_sub_n == 8192 and not cfg.local_refine_full
    plan, packed = sharded.prepare(cfg, data, mesh)
    assert plan.n_padded == n and plan.l_padded == l
    wl = n // 4 // ind                          # 4096 bytes per ind shard
    sub_w = local_step.sub_columns(cfg, wl, ind)
    assert sub_w == 1024                        # sub branch engages

    state0 = sharded.init_sharded_state(cfg, plan, mesh)
    step = jax.jit(sharded.make_sharded_step(cfg, plan, mesh,
                                             interpret=True))
    got = np.asarray(step(state0, packed).gamma)

    # ---- dense golden ----------------------------------------------------
    key = state0.key
    gamma0 = np.asarray(state0.gamma)           # (N, K)
    packed_np = np.asarray(data.packed)
    wpad = packed_width(n)
    assert packed_np.shape == (l, wpad)
    b_local = b // snp
    l_local = l // snp
    u_full = np.asarray(ops.exp_elog_theta(jnp.asarray(gamma0)))

    def dense_stats(xb, u, t1, t0):
        """One t-scaled lambda-stat pair + raw ratios for gamma."""
        a1, a0 = ops.allele_counts(jnp.asarray(xb), jnp.float32)
        return a1, a0

    t = jnp.int32(0)
    gamma_stat_by_s = []
    for s in range(snp):
        kb = jax.random.fold_in(jax.random.fold_in(key, t), s)
        idx = np.asarray(jax.random.randint(
            kb, (b_local,), 0, l_local, dtype=jnp.int32))
        rows_full = packed_np[s * l_local + idx]            # (b_l, wpad)

        # per-ind-shard subsample columns + unpacked genotypes
        xb_sub, u_sub, xb_full, u_shard = [], [], [], []
        for i in range(ind):
            ks = jax.random.fold_in(
                jax.random.fold_in(kb, i), 0x5B)
            idx_w = np.asarray(jax.random.choice(
                ks, wl, (sub_w,), replace=False))
            cols = rows_full[:, i * wl: (i + 1) * wl]
            xb_sub.append(unpack2bit(
                np.ascontiguousarray(cols[:, idx_w]), 4 * sub_w))
            ui = u_full[i * 4 * wl: (i + 1) * 4 * wl]
            u_sub.append(ui.reshape(wl, 4, k)[idx_w].reshape(-1, k))
            xb_full.append(unpack2bit(np.ascontiguousarray(cols),
                                      4 * wl))
            u_shard.append(ui)
        scale = wl / sub_w

        def iterate(lam):
            t1, t0 = ops.exp_elog_beta(lam)
            l0 = l1 = 0.0
            for i in range(ind):
                a1, a0 = ops.allele_counts(jnp.asarray(xb_sub[i]),
                                           jnp.float32)
                l0i, l1i = ops.lambda_stats(
                    a1, a0, jnp.asarray(u_sub[i]), t1, t0, jnp.float32)
                l0 = l0 + l0i / t1        # undo t-scaling to psum raw
                l1 = l1 + l1i / t0
            return jnp.stack([cfg.beta_a + scale * t1 * l0,
                              cfg.beta_b + scale * t0 * l1], axis=-1)

        lamb0 = jnp.stack(
            [jnp.full((b_local, k), cfg.beta_a, jnp.float32),
             jnp.full((b_local, k), cfg.beta_b, jnp.float32)], axis=-1)
        lam = ops.solve_schedule(
            iterate, lamb0, local_iters=cfg.local_iters,
            local_tol=cfg.local_tol, accel=True)

        # exact full-N final stats
        t1, t0 = ops.exp_elog_beta(lam)
        gs = []
        for i in range(ind):
            a1, a0 = ops.allele_counts(jnp.asarray(xb_full[i]),
                                       jnp.float32)
            st = ops.batch_stats(a1, a0, jnp.asarray(u_shard[i]),
                                 t1, t0, jnp.float32)
            gs.append(np.asarray(st.gamma_stat))
        gamma_stat_by_s.append(np.concatenate(gs, axis=0))    # (N, K)

    gamma_stat = np.sum(gamma_stat_by_s, axis=0)              # psum 'snp'
    rho = float(cfg.rho(0.0))
    want = (1.0 - rho) * gamma0 + rho * (
        cfg.alpha_value + (l / b) * gamma_stat)

    # outer bound covers the Aitken near-clamp amplification of kernel-
    # vs-dense f32 noise (measured: 35/98304 coords at max rel 2.5e-3)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
    # and the bulk of coordinates must match much tighter — a wrong
    # key fold / scale / schedule would blow this, clamp noise doesn't
    rel = np.abs(got - want) / (np.abs(want) + 1e-6)
    assert np.quantile(rel, 0.99) < 2e-4, np.quantile(rel, 0.99)
