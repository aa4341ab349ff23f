"""ChEES-HMC — accelerator-native adaptive Hamiltonian Monte Carlo.

The iterative NUTS in mcmc/nuts.py is a CPU-era control-flow shape: per
trajectory it runs data-dependent while_loops whose tiny bodies execute
serially on-device (~ms/leaf of launch overhead vs ~50 us of math at
validator shapes). The TPU-native adaptive sampler is ChEES-HMC
(Hoffman, Radul & Sountsov, AISTATS 2021, "An Adaptive MCMC Scheme for
Setting Trajectory Lengths in Hamiltonian Monte Carlo"): run MANY
vectorized chains, integrate FIXED-shape jittered-length leapfrog scans
(perfectly batched matmuls on the MXU, no per-leaf control flow), and
adapt the trajectory length T by gradient ascent on the ChEES criterion

    ChEES(T) = (1/4) E[ (||q' - m||^2 - ||q - m||^2)^2 ],

whose per-chain stochastic gradient uses the end-of-trajectory velocity
(d q(T) / d T = v(T)):

    g_i = (||q'_i - m||^2 - ||q_i - m||^2) * <q'_i - m, v'_i> * u

with m the cross-chain mean of the proposed states and u the shared
jitter fraction. Chains share one jitter u_t ~ Halton(2) per iteration
(SIMD-friendly, as in the paper); step size adapts by dual averaging on
the cross-chain mean acceptance (target 0.651 — optimal for
jittered-HMC); the diagonal mass adapts from cross-chain+time second
moments in the Stan-style 3-phase window of hmc.run_hmc.

Static shapes everywhere: each dispatch chunk fixes the leapfrog scan
length L_max (a power-of-two bucket of ceil(T_max/eps), recomputed on
host between chunks — bounded recompiles), and chains mask the steps
beyond their iteration's target length. Expected waste is ~2x FLOPs
(E[u] = 1/2) — orders of magnitude cheaper than NUTS' per-leaf
dispatch overhead on TPU.

Chains shard over the device mesh exactly like mcmc/chains.py.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree

from terastructure_tpu.mcmc.chains import maybe_shard_leading
from terastructure_tpu.mcmc.hmc import da_init, da_update


def _halton2(i: np.ndarray) -> np.ndarray:
    """Base-2 Halton (van der Corput) sequence, host-side."""
    out = np.zeros(i.shape, np.float64)
    f = 0.5
    v = np.asarray(i, np.int64) + 1
    while v.max() > 0:
        out += f * (v & 1)
        v >>= 1
        f *= 0.5
    return out


def run_chees(
    key,
    log_prob: Callable,
    init_params,
    *,
    n_samples: int,
    n_warmup: int = 500,
    n_chains: int = 16,
    init_eps: float = 0.1,
    init_traj: float = 1.0,
    target_accept: float = 0.651,
    adam_lr: float = 0.025,
    max_leapfrog: int = 1024,
    shard_chains: bool = True,
    inv_mass0=None,
    dispatch_chunk: int = 100,
    mass_floor_frac: float = 0.25,
    sample_traj_mult: float = 1.0,
):
    """Run n_chains ChEES-HMC chains (vectorized leading axis).

    init_params must carry a leading chain axis of size n_chains.
    Returns (samples pytree with leading (chains, samples) as host
    numpy, diagnostics). inv_mass0: optional diagonal preconditioner
    (no chain axis), e.g. potential.svi_informed_inits' q-variances.

    Two levers against the slow-coordinate R-hat tail:
    mass_floor_frac floors the warmup-estimated variance at that
    fraction of inv_mass0 — coordinates that barely moved during warmup
    otherwise get a tiny mass entry, shrinking their effective step and
    freezing them harder (mean-field q UNDER-estimates posterior
    variance, so q-var is a sound lower bound); sample_traj_mult
    lengthens the frozen trajectory for the sampling phase only — the
    ChEES criterion optimizes the cross-chain AVERAGE, which under-serves
    the slowest coordinates, and extra length costs wall-clock linearly
    while leaving adaptation untouched.
    """
    if n_chains < 2:
        raise ValueError("ChEES adaptation needs >= 2 chains")

    # Flatten once on host to fix shapes/unravel.
    q0_flat, unravel = ravel_pytree(
        jax.tree.map(lambda a: a[0], init_params))
    dim = q0_flat.shape[0]
    q_all = jax.vmap(lambda p: ravel_pytree(p)[0])(init_params)
    if inv_mass0 is None:
        inv_mass = jnp.ones((dim,), jnp.float32)
    else:
        inv_mass, _ = ravel_pytree(jax.tree.map(jnp.asarray, inv_mass0))

    def lp_flat(q):
        return log_prob(unravel(q))

    grad_fn = jax.vmap(jax.value_and_grad(lp_flat))

    def make_one_iter(l_max):
      def one_iter(carry, xs):
        """One jittered-HMC transition for all chains + adaptation."""
        q, lp, g, key, da, log_t, adam_m, adam_v, adam_i, msum, msq, mcnt, \
            inv_m, adapt_eps, adapt_t, adapt_mass = carry
        u, _ = xs
        k_mom, k_acc, k_jit, key = jax.random.split(key, 4)
        eps = jnp.exp(da.log_eps).astype(q.dtype)
        # dynamics in the position dtype (f32); only energy reductions
        # and the adaptation state widen under x64
        inv_mc = inv_m.astype(q.dtype)
        traj = jnp.exp(log_t)
        # Jitter: SHARED across chains while T adapts (the ChEES
        # gradient estimator requires a common u), per-chain i.i.d.
        # once adaptation freezes — sampling with chain-independent
        # trajectory lengths breaks the length resonances that
        # under-serve the slowest coordinates (the documented ChEES
        # R-hat tail); any state-independent jitter keeps the kernel
        # valid. Cost is unchanged: the scan is l_max-static either way.
        u_chain = jnp.where(
            adapt_t, jnp.full((q.shape[0],), u, q.dtype),
            jax.random.uniform(k_jit, (q.shape[0],), q.dtype))
        n_steps = jnp.maximum(
            (u_chain * traj / eps).astype(jnp.int32), 1)
        n_steps = jnp.minimum(n_steps, l_max)

        p = jax.random.normal(k_mom, q.shape, q.dtype) / jnp.sqrt(inv_mc)
        h0 = -lp + 0.5 * jnp.sum(inv_mc * p * p, axis=-1,
                                 dtype=lp.dtype)

        def leap(c, i):
            q, p, lp_c, g_c = c
            active = i < n_steps      # (C,): per-chain step mask
            pn = p + 0.5 * eps * g_c.astype(q.dtype)
            qn = q + eps * inv_mc * pn
            lpn, gn = grad_fn(qn)
            pn = pn + 0.5 * eps * gn.astype(q.dtype)
            q = jnp.where(active[:, None], qn, q)
            p = jnp.where(active[:, None], pn, p)
            lp_c = jnp.where(active, lpn, lp_c)
            g_c = jnp.where(active[:, None], gn, g_c)
            return (q, p, lp_c, g_c), None

        # static-length scan; steps beyond n_steps pass through (masked)
        (q1, p1, lp1, g1), _ = jax.lax.scan(
            leap, (q, p, lp, g), jnp.arange(l_max))
        h1 = -lp1 + 0.5 * jnp.sum(inv_mc * p1 * p1, axis=-1,
                                  dtype=lp.dtype)
        log_acc = jnp.clip(h0 - h1, max=0.0)
        log_acc = jnp.where(jnp.isfinite(log_acc), log_acc, -jnp.inf)
        acc_prob = jnp.exp(log_acc)
        accept = jnp.log(jax.random.uniform(k_acc, (q.shape[0],),
                                            log_acc.dtype)) < log_acc
        q_new = jnp.where(accept[:, None], q1, q)
        lp_new = jnp.where(accept, lp1, lp)
        g_new = jnp.where(accept[:, None], g1, g)

        # --- eps: dual averaging on the cross-chain mean acceptance
        da = jax.tree.map(
            lambda a, b: jnp.where(adapt_eps, a, b),
            da_update(da, jnp.mean(acc_prob), target=target_accept), da)

        # --- T: Adam ascent on the ChEES gradient. Divergent chains
        # (non-finite proposals) are masked out of the cross-chain
        # statistics, or one early blow-up poisons log_t forever.
        ok = jnp.all(jnp.isfinite(q1), axis=-1) & jnp.isfinite(acc_prob)
        w = jnp.where(ok, acc_prob, 0.0)
        q1m = jnp.where(ok[:, None], q1, 0.0)
        m = jnp.sum(q1m, axis=0) / jnp.maximum(
            jnp.sum(ok, axis=0), 1)
        dsq = (jnp.sum((q1m - m) ** 2, axis=-1)
               - jnp.sum((q - m) ** 2, axis=-1))
        v1 = inv_mc * jnp.where(ok[:, None], p1, 0.0)
        dirn = jnp.sum((q1m - m) * v1, axis=-1)
        grad_t = (jnp.sum(w * dsq * dirn) /
                  jnp.maximum(jnp.sum(w), 1e-6)) * u
        # chain rule to log-space, then Adam
        grad_lt = grad_t * jnp.exp(log_t)
        grad_lt = jnp.where(jnp.isfinite(grad_lt), grad_lt, 0.0)
        adam_i1 = adam_i + 1.0
        m1 = 0.9 * adam_m + 0.1 * grad_lt
        v1a = 0.999 * adam_v + 0.001 * grad_lt**2
        mhat = m1 / (1.0 - 0.9**adam_i1)
        vhat = v1a / (1.0 - 0.999**adam_i1)
        log_t_new = log_t + adam_lr * mhat / (jnp.sqrt(vhat) + 1e-8)
        # keep the trajectory inside this chunk's static bucket
        log_t_new = jnp.clip(
            log_t_new, jnp.log(jnp.exp(da.log_eps)),
            jnp.log(jnp.exp(da.log_eps) * l_max))
        log_t = jnp.where(adapt_t, log_t_new, log_t)
        adam_m = jnp.where(adapt_t, m1, adam_m)
        adam_v = jnp.where(adapt_t, v1a, adam_v)
        adam_i = jnp.where(adapt_t, adam_i1, adam_i)

        # --- mass: cross-chain + time second moments
        msum = jnp.where(adapt_mass, msum + jnp.sum(q_new, axis=0), msum)
        msq = jnp.where(adapt_mass, msq + jnp.sum(q_new**2, axis=0), msq)
        mcnt = jnp.where(adapt_mass, mcnt + q.shape[0], mcnt)

        carry = (q_new, lp_new, g_new, key, da, log_t, adam_m, adam_v,
                 adam_i, msum, msq, mcnt, inv_m, adapt_eps, adapt_t,
                 adapt_mass)
        return carry, (q_new, acc_prob, jnp.exp(da.log_eps), jnp.exp(log_t))

      return one_iter

    # ---- host-side chunked driver with L_max bucketing --------------
    jit_cache = {}
    last_l_max = [4]

    def run_chunk(carry, us, l_max_static):
        last_l_max[0] = l_max_static
        keyk = (len(us), l_max_static)
        if keyk not in jit_cache:
            body = make_one_iter(l_max_static)

            def f(c, u_arr):
                return jax.lax.scan(body, c, (u_arr, u_arr))

            jit_cache[keyk] = jax.jit(f)
        return jit_cache[keyk](carry, jnp.asarray(us, jnp.float32))

    def bucket(t_now, eps_now):
        need = int(np.ceil(t_now / max(eps_now, 1e-12))) + 1
        b = 1
        while b < need:
            b *= 2
        return int(min(max(b, 4), max_leapfrog))

    lp0, g0 = grad_fn(q_all)
    if shard_chains:
        (q_all, lp0, g0) = maybe_shard_leading(
            (q_all, lp0, g0), n_chains, True)
    da = da_init(jnp.asarray(init_eps))
    carry = (q_all, lp0, g0, key, da, jnp.log(jnp.asarray(init_traj)),
             jnp.zeros(()), jnp.zeros(()), jnp.zeros(()),
             jnp.zeros((dim,), jnp.float32), jnp.zeros((dim,), jnp.float32),
             jnp.zeros((), jnp.float32),
             inv_mass, jnp.asarray(True), jnp.asarray(True),
             jnp.asarray(False))

    n1 = max(int(0.3 * n_warmup), 1)
    n3 = max(int(0.3 * n_warmup), 1)
    n2 = max(n_warmup - n1 - n3, 1)

    def set_flags(c, eps_f, t_f, mass_f):
        c = list(c)
        c[13] = jnp.asarray(eps_f)
        c[14] = jnp.asarray(t_f)
        c[15] = jnp.asarray(mass_f)
        return tuple(c)

    halton_i = 0

    def drive(carry, total, collect=False):
        nonlocal halton_i
        outs = []
        done = 0
        while done < total:
            step = min(dispatch_chunk, total - done)
            t_now = float(np.exp(carry[5]))
            eps_now = float(np.exp(carry[4].log_eps))
            us = _halton2(np.arange(halton_i, halton_i + step))
            halton_i += step
            carry, ys = run_chunk(carry, us, bucket(t_now, eps_now))
            if collect:
                outs.append(jax.tree.map(np.asarray, ys))
            done += step
        if not collect:
            return carry, None
        return carry, jax.tree.map(
            lambda *xs: np.concatenate(xs, axis=0), *outs)

    # phase 1: eps + T under the initial mass
    carry, _ = drive(carry, n1)
    # phase 2: + second-moment accumulation
    carry = set_flags(carry, True, True, True)
    carry, _ = drive(carry, n2)
    # phase 3: freeze mass := accumulated variance, re-adapt eps
    c = list(carry)
    mean = c[9] / jnp.maximum(c[11], 1.0)
    var = c[10] / jnp.maximum(c[11], 1.0) - mean**2
    w_sh = c[11] / (c[11] + 5.0)
    # The q-variance floor rationale (mean-field q under-estimates
    # posterior variance, so inv_mass0 is a sound lower bound) only
    # holds when a real inv_mass0 was supplied; against the identity
    # placeholder the floor would disable mass adaptation for every
    # coordinate with posterior variance < mass_floor_frac.
    floor = mass_floor_frac * inv_mass if inv_mass0 is not None else 0.0
    c[12] = jnp.maximum(
        jnp.maximum(w_sh * var + (1.0 - w_sh) * inv_mass, floor),
        1e-8).astype(jnp.float32)
    c[4] = da_init(jnp.exp(c[4].log_eps))
    carry = set_flags(tuple(c), True, True, False)
    carry, _ = drive(carry, n3)
    # freeze everything for sampling (optionally with a longer T)
    c = list(carry)
    c[4] = c[4]._replace(log_eps=c[4].log_eps_avg)
    c[5] = c[5] + jnp.log(jnp.asarray(float(sample_traj_mult)))
    # The per-chunk leapfrog bucket caps at max_leapfrog, so a
    # multiplied trajectory beyond eps*max_leapfrog would silently
    # truncate — clamp on host and surface it in the
    # diagnostics instead.
    eps_s = float(np.exp(c[4].log_eps))
    traj_req = float(np.exp(c[5]))
    traj_truncated = traj_req > eps_s * max_leapfrog
    if traj_truncated:
        c[5] = jnp.log(jnp.asarray(eps_s * max_leapfrog, jnp.float32))
    carry = set_flags(tuple(c), False, False, False)
    carry, (qs, accs, epss, trajs) = drive(carry, n_samples, collect=True)

    # qs: (samples, chains, dim) -> samples pytree (chains, samples, ...)
    qs = np.moveaxis(qs, 0, 1)
    leaves, treedef = jax.tree.flatten(
        jax.tree.map(lambda a: a[0], init_params))
    sizes = [int(np.prod(l.shape)) for l in leaves]
    shapes = [l.shape for l in leaves]
    splits = np.cumsum(sizes)[:-1]
    parts = np.split(qs, splits, axis=-1)
    samples = jax.tree.unflatten(treedef, [
        p.reshape(qs.shape[:2] + s) for p, s in zip(parts, shapes)])
    return samples, {
        "accept_rate": float(np.mean(accs)),
        "eps": float(epss[-1]),
        "trajectory_length": float(trajs[-1]),
        "n_leapfrog_bucket": last_l_max[0],
        "traj_truncated": bool(traj_truncated),
    }
