"""Unified accel x local_tol schedule.

Every local-solve path (dense XLA pass, fused GPU kernel pass) must run
the SAME schedule — with accel: a tol-gated loop capped at
local_iters-2 passes, then two ALWAYS-run tail passes + one clamped
Aitken extrapolation (ops/stats_dense.solve_schedule). These tests pin
the semantics with a local_tol that actually FIRES mid-loop, the case
where paths with their own schedules would disagree.
"""

import numpy as np
import jax.numpy as jnp

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data.pack import pack2bit, unpack2bit_jnp
from terastructure_tpu.ops import stats_dense as ops


def _problem(b=16, n=512, l=64, k=3, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, size=(l, n)).astype(np.int8)
    packed = jnp.asarray(pack2bit(x))
    gamma = jnp.asarray(rng.uniform(0.3, 3.0, size=(n, k)), jnp.float32)
    idx = jnp.asarray(rng.integers(0, l, size=b), jnp.int32)
    return packed, gamma, idx


def _dense_solve(packed, gamma, idx, n, *, local_iters, local_tol, accel):
    xb = unpack2bit_jnp(packed, n)[idx]
    a1, a0 = ops.allele_counts(xb, jnp.float32)
    u = ops.exp_elog_theta(gamma)
    b, k = idx.shape[0], gamma.shape[1]
    lamb0 = jnp.ones((b, k, 2), jnp.float32)
    return ops.local_solve(
        a1, a0, u, lamb0, beta_a=1.0, beta_b=1.0,
        local_iters=local_iters, local_tol=local_tol,
        dtype=jnp.float32, accel=accel)


def _manual_passes(packed, gamma, idx, n, npasses):
    """npasses plain coordinate-ascent iterates, returned as a list."""
    xb = unpack2bit_jnp(packed, n)[idx]
    a1, a0 = ops.allele_counts(xb, jnp.float32)
    u = ops.exp_elog_theta(gamma)
    b, k = idx.shape[0], gamma.shape[1]
    lam = jnp.ones((b, k, 2), jnp.float32)
    out = [lam]
    for _ in range(npasses):
        t1, t0 = ops.exp_elog_beta(lam)
        l0, l1 = ops.lambda_stats(a1, a0, u, t1, t0, jnp.float32)
        lam = jnp.stack([1.0 + l0, 1.0 + l1], axis=-1)
        out.append(lam)
    return out


def test_accel_schedule_semantics_exact():
    """With a tol that fires after the FIRST loop pass, the accel
    schedule must equal: 1 loop pass + 2 tail passes + aitken_final of
    the last three iterates — computed manually, exactly."""
    packed, gamma, idx = _problem()
    n = gamma.shape[0]
    got = _dense_solve(packed, gamma, idx, n,
                       local_iters=9, local_tol=1e9, accel=True)
    # tol=1e9 fires right after pass 1 (delta is finite by then)
    it = _manual_passes(packed, gamma, idx, n, 3)
    want = ops.aitken_final(it[1], it[2], it[3])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_plain_schedule_tol_exit_unchanged():
    """Non-accel: tol early-exit still stops after the firing pass."""
    packed, gamma, idx = _problem()
    n = gamma.shape[0]
    got = _dense_solve(packed, gamma, idx, n,
                       local_iters=9, local_tol=1e9, accel=False)
    it = _manual_passes(packed, gamma, idx, n, 1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(it[1]),
                               rtol=1e-6, atol=1e-6)


def _firing_tol(packed, gamma, idx, n, local_iters):
    """A local_tol that fires mid-loop (between two observed deltas),
    far from both so f32 noise can't flip the exit iteration."""
    it = _manual_passes(packed, gamma, idx, n, local_iters)
    deltas = [
        float(jnp.mean(jnp.abs(b_ - a_)) / (jnp.mean(jnp.abs(a_)) + 1.0))
        for a_, b_ in zip(it[:-1], it[1:])
    ]
    # pick a tol between delta after pass 2 and pass 3 (geometric decay)
    lo, hi = deltas[2], deltas[1]
    assert lo < hi, deltas
    return float(np.sqrt(lo * hi)), deltas


def test_fused_matches_dense_when_tol_fires():
    """The fused GPU kernel (interpreted) and the dense pass run the same
    schedule with accel ON and a local_tol that fires mid-loop: the
    kernel choice must not change the numerics."""
    from terastructure_tpu.ops import local_step

    packed, gamma, idx = _problem()
    n = gamma.shape[0]
    iters = 7
    tol, deltas = _firing_tol(packed, gamma, idx, n, iters)
    # sanity: tol actually fires inside the accel loop (cap iters-2=5)
    assert deltas[2] < tol < deltas[1]

    want = _dense_solve(packed, gamma, idx, n,
                        local_iters=iters, local_tol=tol, accel=True)
    # the early exit made a difference vs the tol-never-fires run
    full = _dense_solve(packed, gamma, idx, n,
                        local_iters=iters, local_tol=-1.0, accel=True)
    assert float(jnp.max(jnp.abs(want - full))) > 1e-5

    u = ops.exp_elog_theta(gamma)
    b, k = idx.shape[0], gamma.shape[1]
    cfg = SVIConfig(n=n, l=packed.shape[0], k=k, local_iters=iters,
                    local_tol=tol, local_accel=True)
    lamb0 = jnp.ones((b, k, 2), jnp.float32)
    for kernel in ("triton", "dense"):
        got = local_step.solve(cfg, kernel, packed[idx], u, lamb0,
                               interpret=True)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)
