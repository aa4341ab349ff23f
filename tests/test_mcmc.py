"""MCMC validator tests: exact conjugate checks + sampler sanity.

With K=1 the PSD model collapses to independent Beta-Binomial conjugacy:
beta_j | x ~ Beta(a + sum_i x_ij, b + sum_i (2 - x_ij)) exactly, giving a
ground-truth posterior to validate HMC/NUTS/SMC against (SURVEY.md §4:
"SVI-vs-NUTS/SMC moment-matching on small K").
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from terastructure_tpu.mcmc import PSDPotential, run_hmc, run_nuts, run_smc
from terastructure_tpu.mcmc.potential import init_params


def _conjugate_problem(seed=0, n=40, l=6):
    rng = np.random.default_rng(seed)
    beta_true = rng.uniform(0.2, 0.8, size=l)
    x = rng.binomial(2, np.broadcast_to(beta_true, (n, l))).astype(np.int8)
    a = 1.0 + x.sum(0)
    b = 1.0 + (2 - x).sum(0)
    post_mean = a / (a + b)
    post_var = a * b / ((a + b) ** 2 * (a + b + 1))
    pot = PSDPotential(x=jnp.asarray(x), alpha=1.0)
    return pot, post_mean, post_var


def _beta_samples(pot, samples):
    return np.asarray(jax.nn.sigmoid(samples["z_beta"]))  # (S, L, 1)


def test_hmc_matches_conjugate_posterior():
    pot, post_mean, post_var = _conjugate_problem()
    params0 = init_params(pot, jax.random.PRNGKey(1), k=1)
    samples, info = run_hmc(
        jax.random.PRNGKey(2), pot, params0,
        n_samples=2000, n_warmup=600, n_leapfrog=24,
    )
    beta = _beta_samples(pot, samples)[:, :, 0]
    assert 0.5 < float(info["accept_rate"]) <= 1.0
    np.testing.assert_allclose(beta.mean(0), post_mean, atol=0.03)
    np.testing.assert_allclose(beta.var(0), post_var, rtol=0.6, atol=5e-4)


def test_nuts_matches_conjugate_posterior():
    pot, post_mean, post_var = _conjugate_problem()
    params0 = init_params(pot, jax.random.PRNGKey(3), k=1)
    samples, info = run_nuts(
        jax.random.PRNGKey(4), pot, params0,
        n_samples=500, n_warmup=300, max_depth=6,
    )
    beta = _beta_samples(pot, samples)[:, :, 0]
    assert float(info["divergence_rate"]) < 0.05
    np.testing.assert_allclose(beta.mean(0), post_mean, atol=0.03)
    np.testing.assert_allclose(beta.var(0), post_var, rtol=0.6, atol=5e-4)


def test_nuts_multichain():
    pot, post_mean, _ = _conjugate_problem()
    params0 = init_params(pot, jax.random.PRNGKey(5), k=1, n_chains=2)
    samples, info = run_nuts(
        jax.random.PRNGKey(6), pot, params0,
        n_samples=200, n_warmup=200, max_depth=6, n_chains=2,
    )
    beta = np.asarray(jax.nn.sigmoid(samples["z_beta"]))  # (2, S, L, 1)
    assert beta.shape[0] == 2
    # chains agree with each other and the truth
    np.testing.assert_allclose(beta[0].mean(0), beta[1].mean(0), atol=0.05)
    np.testing.assert_allclose(beta.mean((0, 1))[:, 0], post_mean, atol=0.04)


def test_smc_matches_conjugate_posterior():
    pot, post_mean, post_var = _conjugate_problem(n=30, l=4)
    n_particles = 256
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    # init from the prior: z_beta ~ logit(Beta(1,1)) = logistic(0,1);
    # z_theta ~ log-gamma(alpha)
    zb = jax.scipy.special.logit(
        jax.random.uniform(keys[0], (n_particles, pot.l, 1),
                           minval=1e-4, maxval=1 - 1e-4))
    zt = jnp.log(jax.random.gamma(keys[1], pot.alpha,
                                  (n_particles, pot.n, 1)))
    particles0 = {"z_theta": zt, "z_beta": zb}
    particles, diag = run_smc(
        jax.random.PRNGKey(8), pot.log_prior, pot.log_lik, particles0,
        n_particles=n_particles, n_mutations=3, n_leapfrog=8,
        mutation_eps=0.2,
    )
    assert diag["temps"][-1] >= 1.0 - 1e-6
    beta = np.asarray(jax.nn.sigmoid(particles["z_beta"]))[:, :, 0]
    np.testing.assert_allclose(beta.mean(0), post_mean, atol=0.05)


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_gaussian_target(sampler):
    """Direct sanity on a correlated 2-D Gaussian."""
    cov = jnp.asarray([[1.0, 0.6], [0.6, 0.5]])
    prec = jnp.linalg.inv(cov)

    def log_prob(params):
        z = params["z"]
        return -0.5 * z @ prec @ z

    params0 = {"z": jnp.zeros(2)}
    if sampler == "hmc":
        samples, _ = run_hmc(jax.random.PRNGKey(0), log_prob, params0,
                             n_samples=2000, n_warmup=500, n_leapfrog=8)
    else:
        samples, _ = run_nuts(jax.random.PRNGKey(0), log_prob, params0,
                              n_samples=2000, n_warmup=500, max_depth=6)
    z = np.asarray(samples["z"])
    emp_cov = np.cov(z.T)
    np.testing.assert_allclose(z.mean(0), [0, 0], atol=0.12)
    np.testing.assert_allclose(emp_cov, np.asarray(cov), atol=0.15)


def test_energy_sums_widen_under_x64_dynamics_stay_f32():
    """Regression for the frozen-chain bug: at validator shapes the f32
    Hamiltonian tree-sum noise (~tens of ulps of |logp| ~ 1e6) swamps
    the acceptance signal and dual averaging collapses eps to ~1e-5.
    Under x64 the potential must accumulate energies in f64 — matching
    a numpy f64 reference far tighter than f32 ulp noise — while
    init_params and the NUTS trajectory stay f32."""
    import scipy.special as sps

    from terastructure_tpu.data.simulate import simulate_psd
    from terastructure_tpu.mcmc.potential import PSDPotential, init_params

    _, _, x = simulate_psd(400, 1200, 3, seed=3)
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        pot = PSDPotential(x=jnp.asarray(x), alpha=1 / 3)
        params = init_params(pot, jax.random.PRNGKey(0), k=3)
        assert params["z_theta"].dtype == jnp.float32
        ll = pot.log_lik(params)
        assert ll.dtype == jnp.float64

        # numpy float64 oracle of the same quantity (f32 forward ops,
        # f64 accumulation) — must agree to ~1e-2 nats out of ~1e6,
        # far below the ~0.1-1 nat f32 tree-sum noise the bug rode on.
        zt = np.asarray(params["z_theta"], np.float32)
        zb = np.asarray(params["z_beta"], np.float32)
        g = np.exp(zt)
        theta = g / g.sum(-1, keepdims=True)
        beta = sps.expit(zb)
        p = (theta @ beta.T).astype(np.float64)
        xi = x.astype(np.float64)
        ref = float(np.sum(
            xi * np.log(p + 1e-12) + (2 - xi) * np.log(1 - p + 1e-12)
            + np.log([1.0, 2.0, 1.0])[x]
        ))
        assert abs(float(ll) - ref) < 0.1, (float(ll), ref)

        # One NUTS transition keeps the trajectory f32.
        from terastructure_tpu.mcmc.nuts import nuts_kernel

        kern = nuts_kernel(pot, max_depth=3)
        inv_mass = jax.tree.map(jnp.ones_like, params)
        new, info = kern(jax.random.PRNGKey(1), params, 0.01, inv_mass)
        assert new["z_theta"].dtype == jnp.float32
        assert np.isfinite(float(info["accept_prob"]))
    finally:
        jax.config.update("jax_enable_x64", prev)


def test_scale_pinned_prior_is_posterior_invariant():
    """PSDPotential.scale_sigma must change ONLY the unidentified
    per-row scale direction: (a) the likelihood ignores scale shifts,
    (b) for moves that preserve every row scale w_i, the pinned and
    legacy prior DIFFERENCES are identical (so the theta posterior is
    untouched), and (c) a pure scale shift changes the pinned prior by
    exactly the N(0, sigma^2) log-density difference in w."""
    from terastructure_tpu.data.simulate import simulate_psd
    from terastructure_tpu.mcmc.potential import PSDPotential, init_params

    _, _, x = simulate_psd(20, 40, 3, seed=5)
    sig = 0.05
    legacy = PSDPotential(x=jnp.asarray(x), alpha=0.5)
    pinned = PSDPotential(x=jnp.asarray(x), alpha=0.5, scale_sigma=sig)
    p1 = init_params(legacy, jax.random.PRNGKey(0), k=3)
    p2 = init_params(legacy, jax.random.PRNGKey(1), k=3)

    def with_scales(p, ref):
        """Rescale p's z_theta rows to ref's row scales."""
        import jax.scipy.special as jss
        w_p = jss.logsumexp(p["z_theta"], axis=-1, keepdims=True)
        w_r = jss.logsumexp(ref["z_theta"], axis=-1, keepdims=True)
        return {"z_theta": p["z_theta"] - w_p + w_r, "z_beta": p["z_beta"]}

    # (a) likelihood is scale-invariant
    shift = {"z_theta": p1["z_theta"] + 0.7, "z_beta": p1["z_beta"]}
    np.testing.assert_allclose(float(pinned.log_lik(shift)),
                               float(pinned.log_lik(p1)), rtol=1e-5)
    # (b) same-scale prior differences agree between parameterizations
    p2s = with_scales(p2, p1)
    d_legacy = float(legacy.log_prior(p2s)) - float(legacy.log_prior(p1))
    d_pinned = float(pinned.log_prior(p2s)) - float(pinned.log_prior(p1))
    np.testing.assert_allclose(d_pinned, d_legacy, rtol=1e-4, atol=1e-3)
    # (c) scale shifts see exactly the Gaussian pin
    import jax.scipy.special as jss
    w = np.asarray(jss.logsumexp(p1["z_theta"], axis=-1), np.float64)
    c = 0.3
    d = float(pinned.log_prior(shift_c := {
        "z_theta": p1["z_theta"] + c, "z_beta": p1["z_beta"]})) - float(
            pinned.log_prior(p1))
    expect = float((-((w + c) ** 2 - w**2) / (2 * sig**2)).sum())
    np.testing.assert_allclose(d, expect, rtol=1e-3)


def test_q_z_moments_match_monte_carlo():
    """Closed-form z-space q moments (Dirichlet log-ratio + logit-Beta
    trigamma identities) against brute-force sampling."""
    from terastructure_tpu.mcmc.potential import q_z_moments

    rng = np.random.default_rng(0)
    gamma = rng.uniform(0.5, 50.0, size=(4, 3))
    lamb = rng.uniform(0.8, 60.0, size=(5, 3, 2))
    mean, var = q_z_moments(gamma, lamb, scale_sigma=0.05)

    S = 200_000
    g = rng.gamma(gamma, size=(S,) + gamma.shape)
    log_theta = np.log(g) - np.log(g.sum(-1, keepdims=True))
    # scale pinned at sigma=0.05: mean 0, var 2.5e-3 added to every coord
    np.testing.assert_allclose(np.asarray(mean["z_theta"]),
                               log_theta.mean(0), atol=0.02)
    np.testing.assert_allclose(np.asarray(var["z_theta"]),
                               log_theta.var(0) + 0.05**2, rtol=0.05,
                               atol=1e-4)
    a = rng.gamma(lamb[..., 0], size=(S,) + lamb.shape[:-1])
    b = rng.gamma(lamb[..., 1], size=(S,) + lamb.shape[:-1])
    zb = np.log(a) - np.log(b)
    np.testing.assert_allclose(np.asarray(mean["z_beta"]), zb.mean(0),
                               atol=0.02)
    np.testing.assert_allclose(np.asarray(var["z_beta"]), zb.var(0),
                               rtol=0.05)


def test_svi_informed_inits_shapes_and_overdispersion():
    from terastructure_tpu.mcmc.potential import (q_z_moments,
                                                  svi_informed_inits)

    rng = np.random.default_rng(1)
    gamma = rng.uniform(5.0, 80.0, size=(6, 2))
    lamb = rng.uniform(5.0, 80.0, size=(8, 2, 2))
    key = jax.random.PRNGKey(0)
    params0, inv_mass = svi_informed_inits(
        gamma, lamb, key, n_chains=64, overdisperse=2.0, scale_sigma=0.05)
    assert params0["z_theta"].shape == (64, 6, 2)
    assert params0["z_beta"].shape == (64, 8, 2)
    assert inv_mass["z_theta"].shape == (6, 2)
    assert all(float(jnp.min(v)) > 0 for v in inv_mass.values())
    # across-chain spread matches overdisperse^2 * q-variance
    _, var = q_z_moments(gamma, lamb, scale_sigma=0.05)
    emp = np.asarray(params0["z_beta"]).var(axis=0)
    np.testing.assert_allclose(emp, 4.0 * np.asarray(var["z_beta"]),
                               rtol=0.8)
    # chains differ (no accidental broadcasting of one draw)
    assert np.std(np.asarray(params0["z_theta"])[:, 0, 0]) > 0


def test_potential_matmul_uses_highest_precision():
    """An accelerator's default-precision matmul rounds its operands
    (bf16 passes or TF32); that noise enters every NUTS
    gradient/Hamiltonian and froze the chains (eps ~6e-5, all-coordinate
    R-hat > 1.2 at 500x1000 K=3) while the identical program mixed on
    CPU. Pin precision=HIGHEST in the potential's likelihood matmul via
    the jaxpr."""
    from terastructure_tpu.mcmc.potential import PSDPotential, init_params

    x = np.zeros((4, 6), np.int8)
    pot = PSDPotential(x=jnp.asarray(x), alpha=0.5, scale_sigma=0.05)
    params = init_params(pot, jax.random.PRNGKey(0), k=2)
    jaxpr = jax.make_jaxpr(pot.log_lik)(params)
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots, "log_lik must contain the theta @ beta.T contraction"
    assert all(
        e.params["precision"] == (jax.lax.Precision.HIGHEST,) * 2
        for e in dots
    ), [e.params["precision"] for e in dots]


def test_nuts_nonfinite_energy_is_divergence():
    """A NaN/inf leaf energy must be flagged divergent, not compared
    away (NaN > threshold is False): pre-fix the NaN reached sum_acc ->
    dual averaging and froze that chain's eps at NaN for the whole run
    (observed live on a 3-chain conjugate run). Target with a NaN cliff
    outside |q| < 2 forces the case deterministically."""
    from terastructure_tpu.mcmc.nuts import run_nuts

    def log_prob(params):
        q = params["q"]
        lp = -0.5 * jnp.sum(q**2)
        return jnp.where(jnp.all(jnp.abs(q) < 2.0), lp, jnp.nan)

    p0 = {"q": jnp.zeros((3, 2))}
    samples, info = run_nuts(
        jax.random.PRNGKey(0), log_prob, p0, n_samples=50, n_warmup=50,
        max_depth=5, init_eps=0.5)
    assert np.isfinite(np.asarray(info["eps"])).all()
    assert np.isfinite(samples["q"]).all()
    assert float(info["accept_rate"]) > 0.1


def test_chees_matches_conjugate_posterior():
    """ChEES-HMC against the exact Beta-Binomial conjugate posterior
    (same oracle as the HMC/NUTS tests). 16 vectorized chains — the
    cross-chain ChEES adaptation needs several."""
    from terastructure_tpu.mcmc.chees import run_chees

    pot, post_mean, post_var = _conjugate_problem()
    params0 = init_params(pot, jax.random.PRNGKey(9), k=1, n_chains=16)
    samples, info = run_chees(
        jax.random.PRNGKey(10), pot, params0,
        n_samples=150, n_warmup=300, n_chains=16)
    beta = np.asarray(jax.nn.sigmoid(samples["z_beta"]))  # (16, S, L, 1)
    assert beta.shape[0] == 16
    assert 0.2 < info["accept_rate"] <= 1.0
    pooled = beta.reshape(-1, beta.shape[2])
    np.testing.assert_allclose(pooled.mean(0), post_mean, atol=0.03)
    np.testing.assert_allclose(pooled.var(0), post_var, rtol=0.6,
                               atol=5e-4)


def test_chees_gaussian_covariance():
    """Covariance recovery on a correlated 2-D Gaussian, and the
    adapted trajectory length must exceed the step size (the adaptation
    actually moved T off its floor)."""
    from terastructure_tpu.mcmc.chees import run_chees

    cov = jnp.asarray([[1.0, 0.6], [0.6, 0.5]])
    prec = jnp.linalg.inv(cov)

    def log_prob(params):
        z = params["z"]
        return -0.5 * z @ prec @ z

    C = 16
    init = {"z": 0.1 * jax.random.normal(jax.random.PRNGKey(1), (C, 2))}
    s, info = run_chees(jax.random.PRNGKey(0), log_prob, init,
                        n_samples=300, n_warmup=300, n_chains=C)
    z = np.asarray(s["z"]).reshape(-1, 2)
    np.testing.assert_allclose(z.mean(0), [0, 0], atol=0.12)
    np.testing.assert_allclose(np.cov(z.T), np.asarray(cov), atol=0.15)
    assert info["trajectory_length"] > 2 * info["eps"]


def test_chees_traj_mult_truncation_clamps_and_reports():
    """A huge sample_traj_mult must clamp the sampling trajectory to
    eps * max_leapfrog (the per-chunk leapfrog bucket cap) and surface
    traj_truncated=True in the diagnostics; a modest multiplier at an
    ample max_leapfrog reports False."""
    from terastructure_tpu.mcmc.chees import run_chees

    def log_prob(params):
        z = params["z"]
        return -0.5 * jnp.sum(z * z)

    C = 8
    init = {"z": 0.1 * jax.random.normal(jax.random.PRNGKey(2), (C, 2))}
    kw = dict(n_samples=20, n_warmup=60, n_chains=C, dispatch_chunk=20)

    _, info_big = run_chees(jax.random.PRNGKey(3), log_prob, init,
                            sample_traj_mult=1e6, max_leapfrog=64, **kw)
    assert info_big["traj_truncated"] is True
    # trajectory actually capped at eps * max_leapfrog
    assert info_big["trajectory_length"] <= info_big["eps"] * 64 * 1.001

    _, info_ok = run_chees(jax.random.PRNGKey(3), log_prob, init,
                           sample_traj_mult=1.0, max_leapfrog=1024, **kw)
    assert info_ok["traj_truncated"] is False
