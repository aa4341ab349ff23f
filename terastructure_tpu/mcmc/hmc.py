"""Hamiltonian Monte Carlo with warmup adaptation — vmapped chains.

TPU-native design: chains are a vmapped leading axis (shard over devices
via NamedSharding on the chain axis for the validator configs,
BASELINE.json:4 "chains/particles sharded per-device"). The integrator is
a lax.scan of leapfrog steps — static shapes, no host sync inside a
sample. Warmup adapts a per-parameter diagonal mass matrix (Welford) and
the step size (dual averaging, Nesterov/Hoffman-Gelman constants).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def tree_randn_like(key, tree):
    leaves, treedef = jax.tree.flatten(tree)
    keys = jax.random.split(key, len(leaves))
    return jax.tree.unflatten(
        treedef,
        [jax.random.normal(k, x.shape, x.dtype) for k, x in zip(keys, leaves)],
    )


def tree_dot(a, b):
    return sum(
        jnp.sum(x * y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))
    )


class DualAveragingState(NamedTuple):
    log_eps: jnp.ndarray
    log_eps_avg: jnp.ndarray
    h_avg: jnp.ndarray
    mu: jnp.ndarray
    count: jnp.ndarray


def da_init(eps0):
    return DualAveragingState(
        log_eps=jnp.log(eps0),
        log_eps_avg=jnp.log(eps0),
        h_avg=jnp.zeros(()),
        mu=jnp.log(10.0 * eps0),
        count=jnp.zeros(()),
    )


def da_update(state: DualAveragingState, accept_prob, target=0.8,
              gamma=0.05, t0=10.0, kappa=0.75):
    count = state.count + 1.0
    h_avg = (1.0 - 1.0 / (count + t0)) * state.h_avg + (
        target - accept_prob
    ) / (count + t0)
    log_eps = state.mu - jnp.sqrt(count) / gamma * h_avg
    w = count ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_avg, state.mu, count)


def leapfrog(grad_fn, params, momentum, eps, inv_mass, n_steps):
    """n_steps of leapfrog; inv_mass is a pytree of per-param variances."""

    def half_kick(m, g):
        return jax.tree.map(lambda mi, gi: mi + 0.5 * eps * gi, m, g)

    def drift(p, m):
        return jax.tree.map(
            lambda pi, mi, vi: pi + eps * vi * mi, p, m, inv_mass
        )

    def body(carry, _):
        p, m = carry
        m = half_kick(m, grad_fn(p))
        p = drift(p, m)
        m = half_kick(m, grad_fn(p))
        return (p, m), None

    (params, momentum), _ = jax.lax.scan(
        body, (params, momentum), None, length=n_steps
    )
    return params, momentum


def kinetic(momentum, inv_mass):
    return 0.5 * sum(
        jnp.sum(v * m * m)
        for m, v in zip(jax.tree.leaves(momentum), jax.tree.leaves(inv_mass))
    )


def hmc_kernel(log_prob: Callable, n_leapfrog: int):
    """One HMC proposal+MH step. Returns (params, log_p, accept_prob, key)."""
    grad_fn = jax.grad(log_prob)

    def kernel(key, params, log_p, eps, inv_mass):
        k_mom, k_acc, key = jax.random.split(key, 3)
        # Keep trajectory arithmetic in the parameter dtype even when
        # dual averaging (and the energy sums) run in f64 under x64.
        eps = jnp.asarray(eps, jax.tree.leaves(params)[0].dtype)
        # momentum ~ N(0, mass): sample with std = 1/sqrt(inv_mass)
        noise = tree_randn_like(k_mom, params)
        momentum = jax.tree.map(
            lambda z, v: z / jnp.sqrt(v), noise, inv_mass
        )
        h0 = -log_p + kinetic(momentum, inv_mass)
        new_params, new_mom = leapfrog(
            grad_fn, params, momentum, eps, inv_mass, n_leapfrog
        )
        new_log_p = log_prob(new_params)
        h1 = -new_log_p + kinetic(new_mom, inv_mass)
        log_accept = jnp.clip(h0 - h1, max=0.0)
        log_accept = jnp.where(jnp.isfinite(log_accept), log_accept, -jnp.inf)
        accept = jnp.log(jax.random.uniform(k_acc)) < log_accept
        params = jax.tree.map(
            lambda a, b: jnp.where(accept, b, a), params, new_params
        )
        log_p = jnp.where(accept, new_log_p, log_p)
        return params, log_p, jnp.exp(log_accept), key

    return kernel


class WelfordState(NamedTuple):
    mean: object
    m2: object
    count: jnp.ndarray


def welford_init(params):
    # f32 count: under x64 a default-f64 scalar would promote the whole
    # mass-matrix accumulator (and the warmup scan carry) to f64.
    return WelfordState(
        mean=jax.tree.map(jnp.zeros_like, params),
        m2=jax.tree.map(jnp.zeros_like, params),
        count=jnp.zeros((), jnp.float32),
    )


def welford_update(state: WelfordState, params):
    count = state.count + 1.0
    delta = jax.tree.map(lambda p, m: p - m, params, state.mean)
    mean = jax.tree.map(lambda m, d: m + d / count, state.mean, delta)
    delta2 = jax.tree.map(lambda p, m: p - m, params, mean)
    m2 = jax.tree.map(lambda a, d, d2: a + d * d2, state.m2, delta, delta2)
    return WelfordState(mean=mean, m2=m2, count=count)


def welford_variance(state: WelfordState, regularize=True, prior=None):
    """Sample variance, shrunk toward `prior` (Stan-style; Stan's fixed
    target is 1e-3, the default). Passing the q-variance preconditioner
    as `prior` keeps a good externally-supplied mass from being dragged
    toward an arbitrary constant by a short adaptation window."""

    def var(m2, pv):
        v = m2 / jnp.maximum(state.count - 1.0, 1.0)
        if regularize:
            w = state.count / (state.count + 5.0)
            v = w * v + (1.0 - w) * pv
        return jnp.maximum(v, 1e-8)

    if prior is None:
        prior = jax.tree.map(lambda m2: 1e-3, state.m2)
    return jax.tree.map(var, state.m2, prior)


def _bcast_chains(n: int, tree):
    """Give every leaf a leading chain axis of size n (identity if 0)."""
    if not n:
        return tree
    return jax.tree.map(
        lambda x: jnp.broadcast_to(jnp.asarray(x), (n,) + jnp.shape(x)),
        tree)


def _wf_init(params, n: int):
    """welford_init whose count leaf carries the chain axis too (params
    already has it when n > 0) — every carry leaf must be vmappable."""
    wf = welford_init(params)
    if n:
        wf = wf._replace(count=jnp.zeros((n,), jnp.float32))
    return wf


def _chunk_runner(body, vmapped: bool, chunk: int):
    """Host-side driver for a lax.scan body: runs `total` transitions
    as ceil(total/chunk) bounded device programs, carrying state between
    dispatches and streaming collected outputs to host numpy.

    Bounding per-program runtime keeps any one device program short,
    keeps only O(chunk) sample state in device memory, and costs one
    dispatch round-trip per chunk. One jit
    per DISTINCT chunk length (at most two: `chunk` and a remainder).
    """
    cache = {}

    def compiled(length):
        if length not in cache:
            def run(carry):
                return jax.lax.scan(body, carry, None, length=length)

            cache[length] = jax.jit(jax.vmap(run) if vmapped else run)
        return cache[length]

    def drive(carry, total, collect=False):
        outs = []
        done = 0
        while done < total:
            step = min(chunk, total - done)
            carry, ys = compiled(step)(carry)
            if collect:
                outs.append(jax.tree.map(np.asarray, ys))
            done += step
        if not collect:
            return carry, None
        axis = 1 if vmapped else 0
        return carry, jax.tree.map(
            lambda *xs: np.concatenate(xs, axis=axis), *outs)

    return drive


def run_hmc(
    key,
    log_prob: Callable,
    init_params,
    *,
    n_samples: int,
    n_warmup: int = 500,
    n_leapfrog: int = 32,
    init_eps: float = 0.1,
    target_accept: float = 0.8,
    n_chains: int = 1,
    thin: int = 1,
    shard_chains: bool = True,
    inv_mass0=None,
    dispatch_chunk: int = 100,
):
    """Run `n_chains` HMC chains (vmapped). Returns (samples, diagnostics).

    samples: pytree with leading axes (n_chains, n_samples // thin).
    init_params must have a leading chain axis iff n_chains > 1.
    shard_chains: place the chain axis on a device mesh when several
    devices are available (mcmc/chains.py) — XLA runs chains fully in
    parallel, one per device, no communication.
    inv_mass0: optional diagonal preconditioner pytree (no chain axis,
    e.g. potential.svi_informed_inits' q-variances) used through warmup
    phases 1-2 and as the Welford shrinkage target in phase 3.

    Execution is chunked into bounded device programs with samples
    streamed to host (see _chunk_runner); samples come back as numpy.
    """
    import functools

    from terastructure_tpu.mcmc.chains import maybe_shard_leading

    kernel = hmc_kernel(log_prob, n_leapfrog)
    vmapped = n_chains > 1

    def warm_body(carry, _):
        params, log_p, key, da, wf, inv_mass = carry
        params, log_p, acc, key = kernel(
            key, params, log_p, jnp.exp(da.log_eps), inv_mass
        )
        da = da_update(da, acc, target=target_accept)
        wf = welford_update(wf, params)
        return (params, log_p, key, da, wf, inv_mass), None

    def sample_body(carry, _):
        params, log_p, key, eps, inv_mass = carry
        accs = jnp.zeros(())
        for _ in range(thin):
            params, log_p, acc, key = kernel(
                key, params, log_p, eps, inv_mass
            )
            accs = accs + acc / thin
        return (params, log_p, key, eps, inv_mass), (params, accs)

    warm = _chunk_runner(warm_body, vmapped, dispatch_chunk)
    sample = _chunk_runner(sample_body, vmapped, dispatch_chunk)

    if vmapped:
        keys = jax.random.split(key, n_chains)
        keys, init_params = maybe_shard_leading(
            (keys, init_params), n_chains, shard_chains)
    else:
        keys = key
    if inv_mass0 is None:
        im0 = jax.tree.map(
            jnp.ones_like,
            jax.tree.map(lambda a: a[0], init_params)
            if vmapped else init_params)
    else:
        im0 = jax.tree.map(jnp.asarray, inv_mass0)

    nb = n_chains if vmapped else 0
    bc = functools.partial(_bcast_chains, nb)
    # lambda wrap: log_prob may be a (frozen-dataclass) potential whose
    # array fields make it unhashable as a jit cache key.
    lp = lambda p: log_prob(p)
    log_p0 = (jax.jit(jax.vmap(lp)) if vmapped else jax.jit(lp))(
        init_params)
    # Stan-style windowed warmup:
    #   phase 1 (30%): adapt eps under unit mass;
    #   phase 2 (40%): keep adapting eps, accumulate Welford variance;
    #   phase 3 (30%): freeze mass = variance, RE-adapt eps under it
    # (re-initializing dual averaging — eps tuned for unit mass is
    # wrong once the mass changes).
    n1 = max(int(0.3 * n_warmup), 1)
    n3 = max(int(0.3 * n_warmup), 1)
    n2 = max(n_warmup - n1 - n3, 1)
    da0 = bc(da_init(jnp.asarray(init_eps)))
    carry = (init_params, log_p0, keys, da0, _wf_init(init_params, nb),
             bc(im0))
    carry, _ = warm(carry, n1)
    params, log_p, keys, da, wf, _ = carry
    carry = (params, log_p, keys, da, _wf_init(params, nb), bc(im0))
    carry, _ = warm(carry, n2)
    params, log_p, keys, da, wf, _ = carry
    var_fn = lambda w: welford_variance(
        w, prior=None if inv_mass0 is None else im0)
    inv_mass = jax.vmap(var_fn)(wf) if vmapped else var_fn(wf)
    da3 = (jax.vmap(da_init)(jnp.exp(da.log_eps)) if vmapped
           else da_init(jnp.exp(da.log_eps)))
    carry = (params, log_p, keys, da3, _wf_init(params, nb), inv_mass)
    carry, _ = warm(carry, n3)
    params, log_p, keys, da, _, _ = carry
    eps = jnp.exp(da.log_eps_avg)

    carry = (params, log_p, keys, eps, inv_mass)
    carry, (samples, accs) = sample(carry, n_samples // thin, collect=True)
    return samples, {"accept_rate": float(np.mean(accs)), "eps": eps}
