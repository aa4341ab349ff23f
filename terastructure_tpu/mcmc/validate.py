"""Small-K validator: compare SVI variational moments against MCMC.

BASELINE.json:4/:9 — "NUTS/HMC + SMC posterior on a subsample vs SVI
moments". Runs SVI and a sampler on the same genotype matrix and reports
label-aligned discrepancies of E[theta] and E[beta].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data.dataset import GenotypeData
from terastructure_tpu.mcmc import run_chees, run_hmc, run_nuts, run_smc
from terastructure_tpu.mcmc.potential import PSDPotential, init_params
from terastructure_tpu.models import psd
from terastructure_tpu.svi import fit
from terastructure_tpu.utils.labels import align_columns


@dataclasses.dataclass
class ValidationReport:
    theta_mae: float          # mean |E_svi[theta] - E_mcmc[theta]| aligned
    beta_mae: float
    theta_svi: np.ndarray
    theta_mcmc: np.ndarray
    beta_svi: np.ndarray
    beta_mcmc: np.ndarray
    sampler_diag: dict
    svi_steps: int


def mcmc_moments(x, k, *, alpha, sampler="nuts", seed=0, n_samples=600,
                 n_warmup=400, svi_state=None, scale_sigma=0.05,
                 overdisperse=2.0, **kw):
    """Posterior means of theta/beta under the chosen sampler.

    Runs with jax x64 enabled so the potential's energy sums accumulate
    in float64 (see potential._acc_dtype): at validator shapes the f32
    Hamiltonian rounding noise otherwise swamps the acceptance signal
    and dual averaging collapses eps to ~1e-5, silently freezing the
    chains at their inits. Dynamics/gradients stay f32 (init_params and
    the samplers pin their dtypes), so the cost is one widened
    reduction per energy evaluation.

    scale_sigma pins the per-individual unidentified scale direction
    (PSDPotential.scale_sigma — posterior-invariant, fixes the >1000x
    row-block condition number a diagonal mass cannot); None reverts to
    the legacy iid-Gamma prior. svi_state: a fitted SVIState whose
    (gamma, lamb) warm-start the chains and precondition the mass
    (potential.svi_informed_inits) — efficiency only, inits stay
    overdispersed by `overdisperse` so R-hat keeps its power."""
    prev_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        return _mcmc_moments(x, k, alpha=alpha, sampler=sampler, seed=seed,
                             n_samples=n_samples, n_warmup=n_warmup,
                             svi_state=svi_state, scale_sigma=scale_sigma,
                             overdisperse=overdisperse, **kw)
    finally:
        jax.config.update("jax_enable_x64", prev_x64)


def align_ensemble(theta_s, beta_s):
    """Align every member's K component labels to member 0 (Hungarian on
    theta's columns); the permutation is shared with beta. Input leading
    axis is the ensemble (particles, or chains' pooled draws). Returns
    (theta_s, beta_s, n_realigned) with arrays modified in place."""
    k = theta_s.shape[-1]
    flipped = 0
    for i in range(1, theta_s.shape[0]):
        _, perm = align_columns(theta_s[i], theta_s[0])
        if not np.array_equal(perm, np.arange(k)):
            flipped += 1
            theta_s[i] = theta_s[i][..., perm]
            beta_s[i] = beta_s[i][..., perm]
    return theta_s, beta_s, flipped


def _smc_postprocess(particles, diag):
    """Constrain + per-particle label alignment + ensemble moments.

    The PSD posterior is K!-symmetric and tempered SMC mixes BETWEEN
    the label modes (better mutation -> more hopping), so the raw
    ensemble mean collapses toward the symmetric average (theta -> 1/K,
    MAE ~0.3 at K=2). Align every particle's component labels to
    particle 0 before taking moments — the particle analogue of the
    per-chain alignment in the NUTS/HMC branch."""
    g = np.exp(np.asarray(particles["z_theta"], np.float64))
    theta_s = g / g.sum(-1, keepdims=True)           # (P, N, K)
    beta_s = np.asarray(jax.nn.sigmoid(particles["z_beta"]), np.float64)
    theta_s, beta_s, flipped = align_ensemble(theta_s, beta_s)
    diag = dict(diag)
    diag["particles_label_aligned"] = flipped
    return (theta_s.mean(axis=0), beta_s.mean(axis=0), diag)


def _smc_bridge_moments(pot, k, *, n_particles, key, svi_state,
                        scale_sigma, k_alpha, **kw):
    """Variational-bridge SMC: temper from a diagonal-Gaussian zhat
    built on the fitted q's z-moments to the exact posterior,

        log pi_t = log qhat + t * (log p - log qhat),

    instead of prior -> posterior. From the PRIOR the incremental
    log-weights at validator shapes have std ~1e4 nats, so the
    ESS-adaptive ladder needs thousands of stages and caps out far from
    temp = 1 (measured at 500x1000 K=3: theta MAE 0.25 after 100
    stages — particles stranded mid-path). Along the bridge
    std(log p - log qhat) is modest, the ladder completes in a handful
    of stages, the target at t = 1 is still EXACT, and the mutation
    scales are constant along the path (inv_mass = the bridge base's
    variance). The bridge base is overdispersed (1.5x q variance) for
    tail cover; its draws and density use the same zhat, so the SMC
    identities hold regardless of how good q is. diag["log_evidence"]
    estimates log E_qhat[p/qhat] = log Z exactly.
    """
    from terastructure_tpu.mcmc.potential import _acc_dtype, q_z_moments

    kw.pop("inv_mass0", None)
    kw.pop("inv_mass_prior", None)
    mean, var = q_z_moments(
        np.asarray(svi_state.gamma)[:pot.n],
        np.asarray(svi_state.lamb)[:pot.l],
        scale_sigma=scale_sigma, k_alpha=k_alpha)
    var_b = jax.tree.map(lambda v: 1.5 * v, var)

    def log_qb(params):
        acc = _acc_dtype()
        tot = jnp.zeros((), acc)
        for name in ("z_theta", "z_beta"):
            z, m, v = params[name], mean[name], var_b[name]
            tot = tot - 0.5 * jnp.sum((z - m) ** 2 / v, dtype=acc) \
                - 0.5 * jnp.sum(jnp.log(v), dtype=acc)
        return tot

    def delta(params):
        return pot(params) - log_qb(params)

    k_draw, k_smc = jax.random.split(key)
    keys = dict(zip(("z_theta", "z_beta"), jax.random.split(k_draw, 2)))
    particles0 = {
        name: mean[name] + jnp.sqrt(var_b[name]) * jax.random.normal(
            keys[name], (n_particles,) + mean[name].shape, jnp.float32)
        for name in ("z_theta", "z_beta")}
    particles, diag = run_smc(
        k_smc, log_qb, delta, particles0, n_particles=n_particles,
        inv_mass0=var_b, **kw)
    theta_m, beta_m, diag = _smc_postprocess(particles, diag)
    diag["path"] = "variational_bridge"
    return theta_m, beta_m, diag


def _mcmc_moments(x, k, *, alpha, sampler, seed, n_samples, n_warmup,
                  svi_state=None, scale_sigma=0.05, overdisperse=2.0, **kw):
    pot = PSDPotential(x=jnp.asarray(x), alpha=alpha,
                       scale_sigma=scale_sigma)
    key = jax.random.PRNGKey(seed)
    if sampler == "smc":
        n_particles = kw.pop("n_particles", 512)
        k1, k2, k3 = jax.random.split(key, 3)
        if svi_state is not None:
            return _smc_bridge_moments(
                pot, k, n_particles=n_particles, key=key,
                svi_state=svi_state, scale_sigma=scale_sigma,
                k_alpha=k * alpha, **kw)
        # Particles start as exact draws from the potential's PRIOR
        # (tempering requirement). Explicit f32: under x64 only energy
        # sums widen.
        if scale_sigma is not None:
            gt = jax.random.gamma(k1, alpha, (n_particles, pot.n, k),
                                  jnp.float32)
            zt = jnp.log(gt) - jax.scipy.special.logsumexp(
                jnp.log(gt), axis=-1, keepdims=True)
            zt = zt + scale_sigma * jax.random.normal(
                jax.random.fold_in(k1, 1), (n_particles, pot.n, 1),
                jnp.float32)
        else:
            zt = jnp.log(jax.random.gamma(
                k1, alpha, (n_particles, pot.n, k), jnp.float32))
        particles0 = {
            "z_theta": zt,
            "z_beta": jax.scipy.special.logit(jax.random.uniform(
                k2, (n_particles, pot.l, k), jnp.float32,
                minval=1e-4, maxval=1 - 1e-4)),
        }
        particles, diag = run_smc(
            k3, pot.log_prior, pot.log_lik, particles0,
            n_particles=n_particles, **kw)
        return _smc_postprocess(particles, diag)
    else:
        # ChEES adapts from cross-chain statistics — it WANTS many
        # vectorized chains (cheap on TPU: fixed-shape batched scans).
        n_chains = kw.pop("n_chains", 16 if sampler == "chees" else 1)
        k1, k2 = jax.random.split(key)
        inv_mass0 = None
        if svi_state is not None:
            from terastructure_tpu.mcmc.potential import svi_informed_inits

            params0, inv_mass0 = svi_informed_inits(
                np.asarray(svi_state.gamma)[:pot.n],
                np.asarray(svi_state.lamb)[:pot.l], k1,
                n_chains=n_chains if n_chains > 1 else 0,
                overdisperse=overdisperse, scale_sigma=scale_sigma,
                k_alpha=k * alpha)
        else:
            params0 = init_params(pot, k1, k=k,
                                  n_chains=n_chains if n_chains > 1 else 0)
        runner = {"nuts": run_nuts, "hmc": run_hmc,
                  "chees": run_chees}[sampler]
        samples, diag = runner(
            k2, pot, params0, n_samples=n_samples, n_warmup=n_warmup,
            n_chains=n_chains, inv_mass0=inv_mass0, **kw)
        if n_chains > 1:
            from terastructure_tpu.mcmc.diagnostics import summarize

            # Diagnose on the CONSTRAINED parameters: unconstrained
            # z_theta coordinates of near-zero theta components wander
            # freely in log space (the likelihood is flat there), which
            # inflates z-space R-hat by orders of magnitude without
            # affecting theta/beta.
            g = jnp.exp(samples["z_theta"])
            theta_s = np.array(g / jnp.sum(g, axis=-1, keepdims=True))
            beta_s = np.array(jax.nn.sigmoid(samples["z_beta"]))
            # Align every chain's component labels to chain 0 BEFORE
            # diagnostics: the PSD posterior is invariant to permuting
            # the K populations, and chains that settled on different
            # labelings are not "unmixed" — un-aligned R-hat conflates
            # the two. The permutation comes from the
            # chain-mean theta (Hungarian on column L1 distance) and is
            # applied to theta AND beta (same component axis).
            perms = []
            for c in range(1, theta_s.shape[0]):
                _, perm = align_columns(theta_s[c].mean(axis=0),
                                        theta_s[0].mean(axis=0))
                theta_s[c] = theta_s[c][..., perm]
                beta_s[c] = beta_s[c][..., perm]
                perms.append(perm.tolist())
            constrained = {
                "theta": theta_s,
                "beta": beta_s,
            }
            diag = dict(diag)
            diag["convergence"] = summarize(constrained, max_params=64)
            diag["chain_label_perms"] = perms
            # Moment estimates from the ALIGNED constrained samples
            # (merging chains with mismatched labels would corrupt them).
            theta = theta_s.reshape((-1,) + theta_s.shape[2:])
            beta = beta_s.reshape((-1,) + beta_s.shape[2:])
            return (
                np.asarray(theta.mean(axis=0)),
                np.asarray(beta.mean(axis=0)),
                diag,
            )
    g = jnp.exp(samples["z_theta"])
    theta = g / jnp.sum(g, axis=-1, keepdims=True)
    beta = jax.nn.sigmoid(samples["z_beta"])
    return (
        np.asarray(jnp.mean(theta, axis=0)),
        np.asarray(jnp.mean(beta, axis=0)),
        diag,
    )


def compare_svi_mcmc(
    x: np.ndarray,
    k: int,
    *,
    sampler: str = "nuts",
    svi_config: Optional[SVIConfig] = None,
    seed: int = 0,
    warm_start: bool = True,
    **sampler_kw,
) -> ValidationReport:
    """Fit SVI and run MCMC on the same dense genotype matrix x (N, L).

    warm_start: initialize NUTS/HMC chains from the overdispersed
    fitted variational posterior with its z-variance as the mass
    preconditioner (mcmc_moments svi_state). False forces the cold
    init — kept for honesty A/Bs of the validator itself."""
    n, l = x.shape
    cfg = svi_config or SVIConfig(
        n=n, l=l, k=k, batch_size=min(64, l), max_steps=4000,
        rfreq=200, seed=seed,
    )
    data = GenotypeData.from_dense(
        x, validation_frac=0.01, heldout_frac=0.0, seed=seed)
    res = fit(cfg, data)
    theta_svi = np.asarray(psd.theta_mean(res.state.gamma))
    beta_svi = np.asarray(psd.beta_mean(res.state.lamb))[:l]

    theta_mcmc, beta_mcmc, diag = mcmc_moments(
        x, k, alpha=cfg.alpha_value, sampler=sampler, seed=seed,
        svi_state=res.state if warm_start else None,
        **sampler_kw)

    aligned_theta, perm = align_columns(theta_svi, theta_mcmc)
    theta_mae = float(np.abs(aligned_theta - theta_mcmc).mean())
    beta_mae = float(np.abs(beta_svi[:, perm] - beta_mcmc).mean())
    return ValidationReport(
        theta_mae=theta_mae,
        beta_mae=beta_mae,
        theta_svi=aligned_theta,
        theta_mcmc=theta_mcmc,
        beta_svi=beta_svi[:, perm],
        beta_mcmc=beta_mcmc,
        sampler_diag=diag,
        svi_steps=res.steps,
    )
