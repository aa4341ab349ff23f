"""The SVI engine — single-device jittable step and step-chunk runner.

Accelerator re-architecture of the reference inference loop
(`SNPSamplingE::infer`, src/snpsamplinge.cc, SURVEY.md §3.1):

  repeat:
    sample SNP minibatch B                      (here: on-device PRNG)
    local step: phi <-> lambda_B to convergence (bounded lax.while_loop,
                                                 ops/local_step)
    global step: natural-gradient gamma update scaled by L/|B|,
                 Robbins-Monro rho_t = (tau0+t)^-kappa
    scatter converged lambda_B back into lambda

The *inverted* global/local split (SURVEY.md §7.4) is preserved: gamma
(per-individual) is the stochastically updated global state; lambda_j is
local to the sampled SNP and set by full coordinate ascent.

Design notes:
  - The packed genotype matrix stays uint8 (L, ceil(N/4)) in device
    memory; a step gathers B rows and decodes them on device.
  - `make_run_chunk` wraps `nsteps` steps in one lax.fori_loop under a
    single jit, so the host only syncs at validation boundaries (rfreq).
  - RNG: one base PRNGKey, `fold_in(step)` per iteration — reproducible
    and resumable (SURVEY.md §7.4 RNG discipline).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.models import psd
from terastructure_tpu.ops import local_step
from terastructure_tpu.ops import stats_dense as ops
from terastructure_tpu.ops.lambda_pass import resolve_kernel


class SVIState(NamedTuple):
    gamma: jnp.ndarray   # (N, K) f32 Dirichlet params
    lamb: jnp.ndarray    # (L, K, 2) f32 Beta params
    t: jnp.ndarray       # () int32 iteration counter
    key: jnp.ndarray     # base PRNGKey (never split in place; fold_in(t))


def init_state(cfg: SVIConfig, *, l_padded=None) -> SVIState:
    """Random gamma init, prior lambda init (reference: gsl rng init [MED])."""
    l = cfg.l if l_padded is None else l_padded
    key = jax.random.PRNGKey(cfg.seed)
    k_init, k_run = jax.random.split(key)
    gamma = (
        cfg.alpha_value
        + cfg.gamma_init_scale
        * jax.random.uniform(k_init, (cfg.n, cfg.k), dtype=jnp.float32)
    )
    lamb = jnp.stack(
        [
            jnp.full((l, cfg.k), cfg.beta_a, dtype=jnp.float32),
            jnp.full((l, cfg.k), cfg.beta_b, dtype=jnp.float32),
        ],
        axis=-1,
    )
    return SVIState(gamma=gamma, lamb=lamb, t=jnp.int32(0), key=k_run)


def _sample_batch(key, l_real, batch_size):
    """Uniform SNP minibatch. Without replacement when L is small enough
    for the O(L) permutation to be cheap; with replacement (still unbiased,
    SURVEY.md §1.2 step 1) at biobank L."""
    if l_real <= 65536:
        return jax.random.choice(
            key, l_real, shape=(batch_size,), replace=False
        ).astype(jnp.int32)
    return jax.random.randint(key, (batch_size,), 0, l_real, dtype=jnp.int32)


def _group_size(cfg: SVIConfig, l_sample: int) -> int:
    """Effective SNP-group granularity (1 = independent per-SNP draws)."""
    g = cfg.snp_group
    if (g <= 1 or l_sample <= 65536 or l_sample % g
            or cfg.batch_size % g):
        return 1
    return g


def _gather_batch(cfg: SVIConfig, packed, lamb, key, l_sample):
    """Sample the minibatch and gather its genotype rows + lambda rows.

    Group-sampled at biobank L (see SVIConfig.snp_group): draws B/G
    groups of G consecutive SNPs so the HBM gather is B/G large rows of
    a (L/G, G*W) view instead of B latency-bound small rows.

    Returns (idx (B,), rows (B, W), lamb_b (B, K, 2), scatter_fn) where
    scatter_fn(lamb, new_lamb_b) writes the converged lambda back.
    """
    b = cfg.batch_size
    g = _group_size(cfg, l_sample)
    if g == 1:
        idx = _sample_batch(key, l_sample, b)
        rows = packed[idx]
        return idx, rows, lamb[idx], lambda lm, new: lm.at[idx].set(new)

    lg = l_sample // g
    ng = b // g
    w = packed.shape[1]
    k = lamb.shape[1]
    gidx = jax.random.randint(key, (ng,), 0, lg, dtype=jnp.int32)
    idx = (gidx[:, None] * g + jnp.arange(g, dtype=jnp.int32)).reshape(b)
    rows = packed.reshape(lg, g * w)[gidx].reshape(b, w)
    lamb_b = lamb.reshape(lg, g, k, 2)[gidx].reshape(b, k, 2)

    def scatter(lm, new):
        return lm.reshape(lg, g, k, 2).at[gidx].set(
            new.reshape(ng, g, k, 2)).reshape(l_sample, k, 2)

    return idx, rows, lamb_b, scatter


def step_core(cfg: SVIConfig, kernel: str, gamma, rows, lamb_b, *,
              key=None, interpret=False):
    """Local solve + statistics from packed rows (B, W).

    `key` seeds the big-N iteration subsample (ops/local_step.py).
    Returns (new_lamb_b (B, K, 2), gamma_stat (N, K)).
    """
    w = rows.shape[1]
    u = local_step.pad_u(ops.exp_elog_theta(gamma), w)
    new_lamb_b, gamma_stat = local_step.step_stats(
        cfg, kernel, rows, u, lamb_b, sub_key=key,
        sub_cols=local_step.sub_columns(cfg, w), interpret=interpret)
    return new_lamb_b, gamma_stat[: gamma.shape[0]]


def step_core_dense(cfg: SVIConfig, gamma, xb, lamb_b):
    """Local solve + stats from an unpacked minibatch xb (B, N).

    Returns (new_lamb_b (B, K, 2), gamma_stat (N, K)).
    """
    dtype = jnp.dtype(cfg.compute_dtype)
    a1, a0 = ops.allele_counts(xb, jnp.float32)
    u = ops.exp_elog_theta(gamma)
    lamb_b = ops.local_solve(
        a1, a0, u, lamb_b,
        beta_a=cfg.beta_a, beta_b=cfg.beta_b,
        local_iters=cfg.local_iters, local_tol=cfg.local_tol, dtype=dtype,
        accel=cfg.local_accel,
    )
    t1, t0 = ops.exp_elog_beta(lamb_b)
    stats = ops.batch_stats(a1, a0, u, t1, t0, dtype)
    new_lamb_b = jnp.stack(
        [cfg.beta_a + stats.lam0_stat, cfg.beta_b + stats.lam1_stat], axis=-1
    )
    return new_lamb_b, stats.gamma_stat


def _global_update(cfg: SVIConfig, gamma, gamma_stat, t, l_sample):
    """Robbins–Monro natural-gradient gamma update (SURVEY.md §1.2 step 3).

    The L/B scale uses the (possibly padded) sampling range: padding SNPs
    are all-MISSING, so sampling over [0, l_sample) with scale
    l_sample/B keeps the estimator unbiased for the real-SNP sum.
    """
    rho = jnp.asarray(cfg.rho(t.astype(jnp.float32)), jnp.float32)
    scale = jnp.float32(l_sample) / jnp.float32(cfg.batch_size)
    if cfg.gamma_psum_dtype == "bf16":
        # Single-device mirror of the sharded bf16 psum('snp')
        # (parallel/sharded.py psum_gamma): the statistic crosses the
        # reduction boundary at bf16 precision, so one-chip and
        # multi-chip fits share semantics (not bitwise — the ring also
        # accumulates in bf16). reduce_precision, NOT an astype
        # round-trip: XLA's excess-precision simplifier may elide
        # f32->bf16->f32 convert pairs, while reduce_precision is
        # contractually exact bf16 RN rounding.
        gamma_stat = jax.lax.reduce_precision(gamma_stat,
                                              exponent_bits=8,
                                              mantissa_bits=7)
    gamma_target = cfg.alpha_value + scale * gamma_stat
    return (1.0 - rho) * gamma + rho * gamma_target


def step_on_batch(cfg: SVIConfig, gamma, lamb, xb, idx, t):
    """One dense SVI update given minibatch xb (B, N) and SNP ids idx.

    Kept as the simple reference building block (tests, sharded-path
    cross-checks). Pure in (gamma, lamb)."""
    new_lamb_b, gamma_stat = step_core_dense(cfg, gamma, xb, lamb[idx])
    lamb = lamb.at[idx].set(new_lamb_b)
    gamma = _global_update(cfg, gamma, gamma_stat, t, cfg.l)
    return gamma, lamb


def make_step(cfg: SVIConfig, l_sample: int | None = None, *,
              interpret: bool = False):
    """Build the jittable single-device SVI step: (state, packed) -> state.

    l_sample: the SNP range to sample over — pass the padded row count
    when the packed matrix has padding rows (defaults to cfg.l).
    `interpret` runs the Triton kernel through the Pallas interpreter
    (CPU tests only).
    """
    kernel = resolve_kernel(cfg.kernel, cfg.compute_dtype, cfg.k,
                            interpret=interpret)
    l_s = l_sample or cfg.l
    local_mode = cfg.lambda_mode == "local"

    def step(state: SVIState, packed) -> SVIState:
        gamma, lamb, t, key = state
        kb = jax.random.fold_in(key, t)
        if local_mode:
            # Cold start from the prior: nothing SNP-indexed is gathered
            # or scattered, so a plain per-row gather suffices.
            idx = _sample_batch(kb, l_s, cfg.batch_size)
            rows = packed[idx]
            lamb_b = local_step.prior_lambda(cfg, cfg.batch_size)
            scatter = None
        else:
            idx, rows, lamb_b, scatter = _gather_batch(
                cfg, packed, lamb, kb, l_s)
        new_lamb_b, gamma_stat = step_core(
            cfg, kernel, gamma, rows, lamb_b,
            key=jax.random.fold_in(kb, 0x5B), interpret=interpret)
        if scatter is not None:
            lamb = scatter(lamb, new_lamb_b)
        gamma = _global_update(cfg, gamma, gamma_stat, t, l_s)
        return SVIState(gamma=gamma, lamb=lamb, t=t + 1, key=key)

    return step


def make_run_chunk(cfg: SVIConfig, nsteps: int, l_sample: int | None = None,
                   *, interpret: bool = False):
    """jit-compiled runner of `nsteps` SVI steps (one host sync per chunk)."""
    step = make_step(cfg, l_sample, interpret=interpret)
    @functools.partial(jax.jit, donate_argnums=(0,))
    def run_chunk(state: SVIState, packed) -> SVIState:
        def body(_, s):
            return step(s, packed)
        return jax.lax.fori_loop(0, nsteps, body, state)

    return run_chunk


@functools.partial(jax.jit, static_argnames=("form",))
def entry_loglik(gamma, lamb, ind_idx, snp_idx, x, form="plugin"):
    """Mean per-entry predictive log-lik on an entry set (validation or
    heldout) — the reference `compute_likelihood` (SURVEY.md §3.3).
    form: "plugin" | "variational" (models/psd.predictive_loglik)."""
    ll = psd.predictive_loglik(gamma, lamb, ind_idx, snp_idx, x, form=form)
    return jnp.mean(ll)


def make_entry_loglik_recompute(cfg: SVIConfig, eval_rows, row_of_entry,
                                ind_idx, x, *, put=None, interpret=False):
    """Eval scorer for the 'local' lambda mode.

    eval_rows: (S, W) packed genotype rows of the distinct eval SNPs
    (training matrix — eval entries are MISSING there, no leakage);
    row_of_entry: (M,) index into eval_rows per entry. Returns a jitted
    gamma -> mean log-lik function that re-solves those SNPs' lambdas
    from the current gamma (always-converged plug-in predictive).

    `put` overrides how inputs land on device (multi-process runs pass a
    mesh-replicating putter, svi/driver.py).
    """
    from terastructure_tpu.svi.postprocess import solve_lambda_blocks

    if put is None:
        put = lambda a: jax.device_put(np.asarray(a))  # noqa: E731
    # Device-put ONCE and pass as jit arguments — closing over them
    # captures multi-GB constants in the lowered program.
    if not isinstance(eval_rows, jax.Array):
        eval_rows = put(np.asarray(eval_rows))
    row_of_entry = put(np.asarray(row_of_entry))
    ind_idx = put(np.asarray(ind_idx))
    x = put(np.asarray(x))
    w = eval_rows.shape[1]

    # Fixed subsample key: eval scores stay deterministic across checks
    # (the big-N inner-loop subsample engages only when N is large).
    sub_key = jax.random.PRNGKey(cfg.seed ^ 0xE7A1)

    @jax.jit
    def f(gamma, eval_rows, row_of_entry, ind_idx, x):
        u = local_step.pad_u(ops.exp_elog_theta(gamma), w)
        lamb_eval = solve_lambda_blocks(cfg, u, eval_rows, block=1024,
                                        sub_key=sub_key, interpret=interpret)
        if cfg.predictive == "variational":
            return jnp.mean(psd.variational_predictive_loglik(
                gamma[ind_idx], lamb_eval[row_of_entry], x))
        beta = psd.beta_mean(lamb_eval)                 # (S, K)
        th = psd.theta_mean(gamma[ind_idx])             # (M, K)
        p = jnp.sum(th * beta[row_of_entry], axis=-1)
        return jnp.mean(psd.binomial2_loglik(x, p))

    return lambda gamma: f(gamma, eval_rows, row_of_entry, ind_idx, x)
