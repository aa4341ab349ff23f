"""No-U-Turn Sampler — iterative multinomial NUTS, jit/vmap-native.

Implements the dynamic-trajectory HMC of Hoffman & Gelman (2014) with the
multinomial state sampling and generalized U-turn criterion of Betancourt
(2017), in the ITERATIVE formulation (O(max_depth) memory, no recursion)
so the whole sampler is a fixed-shape lax.while_loop nest that XLA
compiles to a single TPU program. Chains vmap over a leading axis.

Everything operates on a flat parameter vector via
jax.flatten_util.ravel_pytree; the diagonal inverse mass matrix is a flat
vector too. Warmup (step size dual averaging + Welford mass adaptation)
reuses terastructure_tpu.mcmc.hmc utilities.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree

from terastructure_tpu.mcmc.hmc import (
    _bcast_chains, _chunk_runner, _wf_init, da_init, da_update,
    welford_variance, welford_update,
)


class _TreeState(NamedTuple):
    """One end (or proposal) of a trajectory: flat position/momentum."""
    q: jnp.ndarray
    p: jnp.ndarray
    grad: jnp.ndarray
    log_prob: jnp.ndarray


def _leapfrog_flat(log_prob_flat):
    grad_fn = jax.value_and_grad(log_prob_flat)

    def step(state: _TreeState, eps, inv_mass):
        p = state.p + 0.5 * eps * state.grad
        q = state.q + eps * inv_mass * p
        lp, g = grad_fn(q)
        p = p + 0.5 * eps * g
        return _TreeState(q=q, p=p, grad=g, log_prob=lp)

    return step


def _energy(state: _TreeState, inv_mass):
    return -state.log_prob + 0.5 * jnp.sum(inv_mass * state.p**2)


def _is_turning(inv_mass, p_left, p_right, p_sum):
    """Generalized U-turn criterion on a subtree (Betancourt App. A.4.2)."""
    v_left = inv_mass * p_left
    v_right = inv_mass * p_right
    s = p_sum - 0.5 * (p_left + p_right)
    # f32 dots: near-zero U-turn crossings shouldn't flip on MXU bf16
    # rounding (same class of noise as the potential matmul, lower
    # stakes — the criterion only gates termination).
    hi = jax.lax.Precision.HIGHEST
    return (jnp.dot(v_left, s, precision=hi) <= 0) | (
        jnp.dot(v_right, s, precision=hi) <= 0)


def _leaf_to_ckpt(n):
    """Map leaf index -> (idx_min, idx_max) checkpoint range to test.

    idx_max = popcount(n >> 1); the number of complete subtrees ending at
    leaf n equals the count of trailing one-bits of n.
    """
    def popcount(x):
        def body(c):
            v, acc = c
            return v >> 1, acc + (v & 1)
        return jax.lax.while_loop(lambda c: c[0] > 0, body, (x, 0))[1]

    def trailing_ones(x):
        def body(c):
            v, acc = c
            return v >> 1, acc + 1
        return jax.lax.while_loop(lambda c: (c[0] & 1) == 1, body, (x, 0))[1]

    idx_max = popcount(n >> 1)
    idx_min = idx_max - trailing_ones(n) + 1
    return idx_min, idx_max


def _iterative_turning(inv_mass, p, p_sum, p_ckpts, psum_ckpts, idx_min, idx_max):
    """Check U-turns of the current leaf against checkpointed subtree starts."""
    def body(c):
        i, _ = c
        sub_psum = p_sum - psum_ckpts[i] + p_ckpts[i]
        return i - 1, _is_turning(inv_mass, p_ckpts[i], p, sub_psum)

    _, turning = jax.lax.while_loop(
        lambda c: (c[0] >= idx_min) & ~c[1], body, (idx_max, False)
    )
    return turning


def nuts_kernel(log_prob: Callable, max_depth: int = 8,
                max_delta_energy: float = 1000.0):
    """One NUTS transition on a params pytree. Returns a kernel fn.

    kernel(key, params, eps, inv_mass_tree) -> (params, info dict)
    """

    def kernel(key, params, eps, inv_mass_tree):
        q0, unravel = ravel_pytree(params)
        inv_mass, _ = ravel_pytree(inv_mass_tree)
        # Dual-averaging runs in f64 under x64; cast eps back so the
        # trajectory arithmetic stays in the parameter dtype.
        eps = jnp.asarray(eps, q0.dtype)
        dim = q0.shape[0]

        def log_prob_flat(q):
            return log_prob(unravel(q))

        leapfrog = _leapfrog_flat(log_prob_flat)
        lp0, g0 = jax.value_and_grad(log_prob_flat)(q0)

        k_mom, k_traj = jax.random.split(key)
        # q0.dtype keeps momentum/dynamics f32 under x64 (energy sums
        # alone widen to f64 — see potential._acc_dtype).
        p0 = jax.random.normal(k_mom, (dim,), q0.dtype) / jnp.sqrt(inv_mass)
        init = _TreeState(q=q0, p=p0, grad=g0, log_prob=lp0)
        h0 = _energy(init, inv_mass)

        def build_subtree(key, from_state, direction, depth_num_leaves):
            """Simulate `depth_num_leaves` leapfrog steps in one direction,
            with progressive multinomial sampling + iterative U-turn checks.
            Returns (end_state, proposal, log_weight, p_sum, turning,
            diverging, sum_accept_prob, num_leaves_done)."""
            eps_d = direction * eps

            ckpt_shape = (max_depth + 1, dim)
            # Momentum buffers in the trajectory dtype (f32); log-weight
            # and acceptance accumulators in the ENERGY dtype (f64 under
            # x64) — jnp.zeros defaults would silently widen everything.
            carry = dict(
                key=key,
                state=from_state,
                proposal=from_state,
                log_w=jnp.asarray(-jnp.inf, h0.dtype),
                p_sum=jnp.zeros((dim,), q0.dtype),
                p_ckpts=jnp.zeros(ckpt_shape, q0.dtype),
                psum_ckpts=jnp.zeros(ckpt_shape, q0.dtype),
                leaf=jnp.int32(0),
                turning=False,
                diverging=False,
                sum_acc=jnp.zeros((), h0.dtype),
            )

            def cond(c):
                return (c["leaf"] < depth_num_leaves) & ~c["turning"] & ~c["diverging"]

            def body(c):
                state = leapfrog(c["state"], eps_d, inv_mass)
                h = _energy(state, inv_mass)
                dh = h - h0                     # > 0 means worse
                # Non-finite energies ARE divergences: NaN fails the >
                # comparison, so without the isfinite the trajectory
                # kept integrating from a NaN state and the NaN reached
                # sum_acc -> dual averaging -> the chain's eps for good
                # (observed: one chain of a 3-chain run NaN-frozen).
                diverging = ~jnp.isfinite(dh) | (dh > max_delta_energy)
                log_w_leaf = jnp.where(jnp.isfinite(dh), -dh, -jnp.inf)
                log_w = jnp.logaddexp(c["log_w"], log_w_leaf)
                # progressive multinomial: accept leaf w.p. w_leaf / w_total
                k_sel, key = jax.random.split(c["key"])
                take = (
                    jnp.log(jax.random.uniform(k_sel)) < log_w_leaf - log_w
                )
                proposal = jax.tree.map(
                    lambda a, b: jnp.where(take, b, a), c["proposal"], state
                )
                sum_acc = c["sum_acc"] + jnp.where(
                    jnp.isfinite(dh), jnp.exp(jnp.clip(-dh, max=0.0)), 0.0)

                leaf = c["leaf"]
                p_sum = c["p_sum"] + state.p
                idx_min, idx_max = _leaf_to_ckpt(leaf)
                is_even = (leaf % 2) == 0
                p_ckpts = jnp.where(
                    is_even,
                    c["p_ckpts"].at[idx_max].set(state.p),
                    c["p_ckpts"],
                )
                psum_ckpts = jnp.where(
                    is_even,
                    c["psum_ckpts"].at[idx_max].set(p_sum),
                    c["psum_ckpts"],
                )
                turning = jax.lax.cond(
                    is_even,
                    lambda: False,
                    lambda: _iterative_turning(
                        inv_mass, state.p, p_sum, p_ckpts, psum_ckpts,
                        idx_min, idx_max,
                    ),
                )
                return dict(
                    key=key, state=state, proposal=proposal, log_w=log_w,
                    p_sum=p_sum, p_ckpts=p_ckpts, psum_ckpts=psum_ckpts,
                    leaf=leaf + 1, turning=turning, diverging=diverging,
                    sum_acc=sum_acc,
                )

            out = jax.lax.while_loop(cond, body, carry)
            return out

        # Outer doubling loop.
        traj = dict(
            key=k_traj,
            left=init, right=init,
            proposal=init,
            log_w=jnp.zeros((), h0.dtype),  # weight of initial state: exp(0)
            p_sum=p0,
            depth=jnp.int32(0),
            turning=False,
            diverging=False,
            sum_acc=jnp.zeros((), h0.dtype),
            num_steps=jnp.zeros((), jnp.int32),
        )

        def t_cond(t):
            return (t["depth"] < max_depth) & ~t["turning"] & ~t["diverging"]

        def t_body(t):
            k_dir, k_sub, k_merge, key = jax.random.split(t["key"], 4)
            direction = jnp.where(
                jax.random.bernoulli(k_dir), 1.0, -1.0
            )
            from_state = jax.tree.map(
                lambda l, r: jnp.where(direction > 0, r, l),
                t["left"], t["right"],
            )
            n_leaves = 2 ** t["depth"]
            sub = build_subtree(k_sub, from_state, direction, n_leaves)

            new_left = jax.tree.map(
                lambda l, s: jnp.where(direction > 0, l, s),
                t["left"], sub["state"],
            )
            new_right = jax.tree.map(
                lambda r, s: jnp.where(direction > 0, s, r),
                t["right"], sub["state"],
            )
            sub_ok = ~(sub["turning"] | sub["diverging"])
            # biased progressive sampling between old tree and new subtree
            take_new = (
                jnp.log(jax.random.uniform(k_merge))
                < sub["log_w"] - t["log_w"]
            ) & sub_ok
            proposal = jax.tree.map(
                lambda a, b: jnp.where(take_new, b, a),
                t["proposal"], sub["proposal"],
            )
            log_w = jnp.logaddexp(t["log_w"], sub["log_w"])
            p_sum = t["p_sum"] + sub["p_sum"]
            turning_full = _is_turning(
                inv_mass, new_left.p, new_right.p, p_sum
            )
            return dict(
                key=key,
                left=new_left, right=new_right,
                proposal=proposal,
                log_w=jnp.where(sub_ok, log_w, t["log_w"]),
                p_sum=p_sum,
                depth=t["depth"] + 1,
                turning=sub["turning"] | (sub_ok & turning_full),
                diverging=sub["diverging"],
                sum_acc=t["sum_acc"] + sub["sum_acc"],
                num_steps=t["num_steps"] + sub["leaf"],
            )

        out = jax.lax.while_loop(t_cond, t_body, traj)
        accept_prob = out["sum_acc"] / jnp.maximum(
            out["num_steps"].astype(jnp.float32), 1.0
        )
        new_params = unravel(out["proposal"].q)
        info = {
            "accept_prob": accept_prob,
            "num_steps": out["num_steps"],
            "diverging": out["diverging"],
            "depth": out["depth"],
            "log_prob": out["proposal"].log_prob,
        }
        return new_params, info

    return kernel


def run_nuts(
    key,
    log_prob: Callable,
    init_params,
    *,
    n_samples: int,
    n_warmup: int = 500,
    max_depth: int = 8,
    init_eps: float = 0.1,
    target_accept: float = 0.8,
    n_chains: int = 1,
    shard_chains: bool = True,
    inv_mass0=None,
    dispatch_chunk: int = 100,
):
    """Run NUTS chains (vmapped leading axis when n_chains > 1).

    Returns (samples pytree with leading (chains, samples) as HOST
    numpy arrays, diagnostics). shard_chains: place the chain axis on a
    device mesh when several devices are available (mcmc/chains.py).
    inv_mass0: optional diagonal preconditioner pytree (no chain axis,
    e.g. potential.svi_informed_inits' q-variances) used through warmup
    phases 1-2 and as the Welford shrinkage target in phase 3.

    Execution is CHUNKED: at most `dispatch_chunk` transitions run per
    device program, with the carry round-tripped (donated) between
    dispatches and samples streamed to host RAM. Bounding per-program
    runtime keeps any one device program short, and streaming keeps
    O(chunk) — not O(n_samples) — sample state in device memory.
    """
    from terastructure_tpu.mcmc.chains import maybe_shard_leading

    kernel = nuts_kernel(log_prob, max_depth=max_depth)
    vmapped = n_chains > 1

    def warm_body(carry, _):
        params, key, da, wf, inv_mass = carry
        k_step, key = jax.random.split(key)
        params, info = kernel(
            k_step, params, jnp.exp(da.log_eps), inv_mass
        )
        da = da_update(da, info["accept_prob"], target=target_accept)
        wf = welford_update(wf, params)
        return (params, key, da, wf, inv_mass), None

    def sample_body(carry, _):
        params, key, eps, inv_mass = carry
        k_step, key = jax.random.split(key)
        params, info = kernel(k_step, params, eps, inv_mass)
        return (params, key, eps, inv_mass), (
            params, info["accept_prob"], info["diverging"])

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

    bc = functools.partial(_bcast_chains, n_chains if vmapped else 0)
    # Stan-style windowed warmup (see hmc.run_hmc): eps-only, then
    # mass accumulation, then eps RE-adaptation under the new mass.
    n1 = max(int(0.3 * n_warmup), 1)
    n3 = max(int(0.3 * n_warmup), 1)
    n2 = max(n_warmup - n1 - n3, 1)
    da0 = bc(da_init(jnp.asarray(init_eps)))
    wf0 = _wf_init(init_params, n_chains if vmapped else 0)
    carry = (init_params, keys, da0, wf0, bc(im0))
    carry, _ = warm(carry, n1)
    params, keys, da, wf, _ = carry
    carry = (params, keys, da, _wf_init(params, n_chains if vmapped else 0),
             bc(im0))
    carry, _ = warm(carry, n2)
    params, keys, da, wf, _ = carry
    var_fn = lambda w: welford_variance(
        w, prior=None if inv_mass0 is None else im0)
    inv_mass = jax.vmap(var_fn)(wf) if vmapped else var_fn(wf)
    da3 = (jax.vmap(da_init)(jnp.exp(da.log_eps)) if vmapped
           else da_init(jnp.exp(da.log_eps)))
    carry = (params, keys, da3,
             _wf_init(params, n_chains if vmapped else 0), inv_mass)
    carry, _ = warm(carry, n3)
    params, keys, da, _, _ = carry
    eps = jnp.exp(da.log_eps_avg)

    carry = (params, keys, eps, inv_mass)
    carry, outs = sample(carry, n_samples, collect=True)
    samples, accs, divs = outs
    return samples, {
        "accept_rate": float(np.mean(accs)),
        "divergence_rate": float(np.mean(divs)),
        "eps": eps,
    }
