"""Dense (jnp) sufficient statistics for PSD SVI — the plain reference.

This is the matrix-product re-derivation of the reference hot loop
(`SNPSamplingE::update_phi{mom,dad}` / `update_lambda` / `update_gamma`,
src/snpsamplinge.cc per SURVEY.md §3.1). The reference loops over
individuals per SNP with pthreads; here the whole phi/lambda/gamma update
collapses into a few matmuls, because phi for a given (i, j) depends only
on the genotype value and on exp-expected-log factors:

  u_ik  = exp E[log theta_ik]            (N, K)
  t1_jk = exp E[log beta_kj]             (B, K)   t0 likewise for 1-beta
  phi1_ijk = u_ik t1_jk / D1_ij,   D1 = T1 @ U^T  (B, N)
  phi0_ijk = u_ik t0_jk / D0_ij,   D0 = T0 @ U^T

With allele-count matrices A1 = mask*x, A0 = mask*(2-x) (B, N) and
R1 = A1/D1, R0 = A0/D0:

  lambda-stats:  L0_jk = t1_jk * (R1 @ U)_jk,  L1_jk = t0_jk * (R0 @ U)_jk
  gamma-stats:   S_ik  = u_ik * (R1^T @ T1 + R0^T @ T0)_ik

i.e. 6 matmuls of shape (B,N)x(N,K) per local iteration. The GPU kernel
of ops/lambda_pass.py computes the lambda statistic of one pass from
the packed rows without materialising the (B, N) intermediates.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from terastructure_tpu.models.psd import MISSING, elog_beta, elog_dirichlet


class BatchStats(NamedTuple):
    gamma_stat: jnp.ndarray   # (N, K) sum of phi over batch SNPs & copies
    lam0_stat: jnp.ndarray    # (B, K) allele-1 counts
    lam1_stat: jnp.ndarray    # (B, K) allele-0 counts


def exp_elog_theta(gamma):
    """u = exp E[log theta] (N, K)."""
    return jnp.exp(elog_dirichlet(gamma))


def exp_elog_beta(lamb_b):
    """(t1, t0) = exp E[log beta], exp E[log(1-beta)], each (B, K)."""
    e1, e0 = elog_beta(lamb_b)
    return jnp.exp(e1), jnp.exp(e0)


def allele_counts(xb, dtype):
    """Split genotypes (B, N) int8 into masked allele-count matrices.

    Returns A1 = #allele-1 copies, A0 = #allele-0 copies, zero where missing.
    """
    mask = xb != MISSING
    xf = xb.astype(dtype)
    a1 = jnp.where(mask, xf, 0.0).astype(dtype)
    a0 = jnp.where(mask, 2.0 - xf, 0.0).astype(dtype)
    return a1, a0


def _ratios(a1, a0, u, t1, t0, dtype):
    """R1, R0 (B, N): allele counts over mixture denominators."""
    ud = u.astype(dtype)
    d1 = jnp.dot(t1.astype(dtype), ud.T, preferred_element_type=jnp.float32)
    d0 = jnp.dot(t0.astype(dtype), ud.T, preferred_element_type=jnp.float32)
    eps = jnp.float32(1e-30)
    r1 = (a1.astype(jnp.float32) / (d1 + eps)).astype(dtype)
    r0 = (a0.astype(jnp.float32) / (d0 + eps)).astype(dtype)
    return r1, r0


def _identity(x):
    return x


def lambda_stats(a1, a0, u, t1, t0, dtype=jnp.float32, ind_reduce=_identity):
    """One coordinate-ascent lambda statistic: (L0, L1) each (B, K).

    `ind_reduce` is applied to the (B, K) individual-summed matmul results;
    under sharding it is a psum over the 'ind' mesh axis (the reference's
    pthread partial-sum join, as a collective across devices).
    """
    r1, r0 = _ratios(a1, a0, u, t1, t0, dtype)
    ud = u.astype(dtype)
    l0 = t1 * ind_reduce(jnp.dot(r1, ud, preferred_element_type=jnp.float32))
    l1 = t0 * ind_reduce(jnp.dot(r0, ud, preferred_element_type=jnp.float32))
    return l0, l1


def batch_stats(a1, a0, u, t1, t0, dtype=jnp.float32,
                ind_reduce=_identity) -> BatchStats:
    """All sufficient stats for a converged local solution.

    Note gamma_stat is the *local-SNP partial*: under sharding the caller
    psums it over the 'snp' axis (each shard's minibatch covers only its
    own SNPs)."""
    r1, r0 = _ratios(a1, a0, u, t1, t0, dtype)
    ud = u.astype(dtype)
    l0 = t1 * ind_reduce(jnp.dot(r1, ud, preferred_element_type=jnp.float32))
    l1 = t0 * ind_reduce(jnp.dot(r0, ud, preferred_element_type=jnp.float32))
    s = u * (
        jnp.dot(r1.T, t1.astype(dtype), preferred_element_type=jnp.float32)
        + jnp.dot(r0.T, t0.astype(dtype), preferred_element_type=jnp.float32)
    )
    return BatchStats(gamma_stat=s, lam0_stat=l0, lam1_stat=l1)


def aitken_final(prev, cur, new, floor=1e-3, rmax=0.9):
    """One per-coordinate Aitken Δ² extrapolation of the λ fixed point.

    The coordinate ascent λ ← F(λ) contracts slowly along a few modes
    (plain 16 passes leave ~5e-2 relative error at TGP-like shapes).
    Given three consecutive iterates λ_{n-1}, λ_n, λ_{n+1}, the geometric
    limit estimate is λ_{n+1} + d1²/(d0 - d1) with d1 = λ_{n+1} - λ_n,
    d0 = λ_n - λ_{n-1} — applied ONCE at the last iteration ("final-only"
    schedule: as accurate as every-2 extrapolation and cheapest). Floor
    keeps λ positive for the digammas in the subsequent stats pass.

    rmax clamps the implied contraction ratio r = d1/d0: the raw step
    d1·r/(1−r) blows up as r→1, and under SVI's per-step minibatch
    noise (f32, cold start) a few coordinates DO land there — unguarded,
    the extrapolation stalls the fit at visibly worse heldout (θ MAE
    about twice plain16's at N=1K×L=20K K=8); the clamp restores it to
    within Monte-Carlo error.
    The clamp bounds the step to rmax/(1−rmax)·|d1| (9×|d1| at 0.9).
    """
    d1 = new - cur
    d0 = cur - prev
    den = d0 - d1
    ok = jnp.abs(den) > 1e-12
    step = jnp.where(ok, d1 * d1 / jnp.where(ok, den, 1.0), 0.0)
    cap = (rmax / (1.0 - rmax)) * jnp.abs(d1)
    step = jnp.clip(step, -cap, cap)
    return jnp.maximum(new + step, floor)


def solve_schedule(iterate, lamb0, *, local_iters, local_tol, accel):
    """Unified local-solve schedule, shared by EVERY coordinate-ascent
    path (dense and kernel passes, sharded, compute-lambda —
    ops/local_step.py).

    plain: tol-gated lax.while_loop, up to `local_iters` passes, early
    exit on mean relative lambda change < local_tol.

    accel (needs local_iters >= 3, else falls back to plain): tol-gated
    while_loop capped at local_iters-2 passes, then ALWAYS two unrolled
    tail passes + one clamped Aitken extrapolation (`aitken_final`).
    Keeping every path on the same schedule means a tol-triggered early
    exit can never make the kernel choice change the numerics: whenever
    tol fires, all paths still run the two tail passes and extrapolate
    from the same three iterates.

    `iterate(lam) -> new_lam` is one coordinate-ascent pass (B, K, 2) ->
    (B, K, 2); the carry stays O(B*K) — ratio matrices are recomputed
    inside `iterate`, never carried.
    """
    accel = accel and local_iters >= 3
    loop_iters = local_iters - 2 if accel else local_iters

    def cond(carry):
        _, it, delta = carry
        return jnp.logical_and(it < loop_iters, delta > local_tol)

    def body(carry):
        lam, it, _ = carry
        new = iterate(lam)
        delta = jnp.mean(jnp.abs(new - lam)) / (jnp.mean(jnp.abs(lam)) + 1.0)
        return new, it + 1, delta

    lam, _, _ = jax.lax.while_loop(
        cond, body, (lamb0, jnp.int32(0), jnp.float32(jnp.inf)))
    if accel:
        mid = iterate(lam)
        new = iterate(mid)
        lam = aitken_final(lam, mid, new)
    return lam


def local_solve(a1, a0, u, lamb_b, *, beta_a, beta_b, local_iters,
                local_tol, dtype=jnp.float32, ind_reduce=_identity,
                accel=False):
    """Local coordinate ascent phi <-> lambda for the minibatch SNPs.

    Mirrors the reference inner loop "until local convergence"
    (SURVEY.md §3.1) on the `solve_schedule` above (tol-gated bounded
    loop; with accel, two always-run tail passes + Aitken).

    Returns the converged lamb_b (B, K, 2).
    """

    def iterate(lam):
        t1, t0 = exp_elog_beta(lam)
        l0, l1 = lambda_stats(a1, a0, u, t1, t0, dtype, ind_reduce=ind_reduce)
        return jnp.stack([beta_a + l0, beta_b + l1], axis=-1)

    return solve_schedule(iterate, lamb_b, local_iters=local_iters,
                          local_tol=local_tol, accel=accel)
