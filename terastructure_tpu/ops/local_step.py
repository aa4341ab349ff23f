"""The local step from packed genotype rows, for every backend.

One SNP minibatch's phi <-> lambda coordinate ascent and its sufficient
statistics, shared by the single-device step (svi/engine.py), the
streaming step (svi/stream.py), the sharded step and post-pass
(parallel/sharded.py) and the lambda re-solve (svi/postprocess.py).

The per-pass lambda statistic runs on the kernel that
ops/lambda_pass.resolve_kernel picked: 'dense' decodes the rows into
(B, N) allele counts once and iterates ops/stats_dense.lambda_stats;
'triton' iterates the fused GPU kernel over the packed rows. The
schedule (stats_dense.solve_schedule) and the final statistics pass
(stats_dense.batch_stats, which also yields the gamma statistic) are the
same for both.

Big-N subsample (cfg.local_sub_n): when a minibatch spans at least 4x
`sub_cols` packed bytes, the coordinate-ascent iterations run on a
random subsample of `sub_cols` byte columns (4 individuals each) with
the statistics scaled by W / sub_cols; the final statistics always come
from one exact pass over every individual.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data.pack import unpack2bit_jnp
from terastructure_tpu.ops import lambda_pass
from terastructure_tpu.ops import stats_dense as ops


def sub_columns(cfg: SVIConfig, w: int, ind: int = 1) -> int:
    """Byte columns of the big-N iteration subsample for a (B, w) row
    block, one of `ind` individual shards; 0 when the subsample is off."""
    sub_w = ((cfg.local_sub_n // 4 // ind) // 128) * 128
    return sub_w if sub_w >= 128 and w >= 4 * sub_w else 0


def prior_lambda(cfg: SVIConfig, b: int):
    """(B, K, 2) Beta prior: the cold start of the local solve."""
    return jnp.stack(
        [jnp.full((b, cfg.k), cfg.beta_a, jnp.float32),
         jnp.full((b, cfg.k), cfg.beta_b, jnp.float32)], axis=-1)


def pad_u(u, w: int):
    """Pad u (n, K) to the 4w individuals of w packed bytes. Padding
    genotypes decode as MISSING, so the fill value never contributes."""
    if u.shape[0] != 4 * w:
        u = jnp.pad(u, ((0, 4 * w - u.shape[0]), (0, 0)),
                    constant_values=1.0)
    return u


def counts(rows, dtype=jnp.float32):
    """Packed rows (B, W) -> allele counts (A1, A0), each (B, 4W)."""
    return ops.allele_counts(unpack2bit_jnp(rows, 4 * rows.shape[1]), dtype)


def make_pass(cfg: SVIConfig, kernel: str, rows, u, *, stat_scale=1.0,
              ind_reduce=ops._identity, interpret=False):
    """One coordinate-ascent pass over packed rows: lam -> new lam.

    rows (B, W) uint8 and u (4W, K). `ind_reduce` sums the (B, K)
    statistics over individual shards (psum over 'ind' under sharding)."""
    if kernel == "triton":
        planes = lambda_pass.u_to_planes(u)

        def stats(t1, t0):
            l0, l1 = lambda_pass.lambda_pass(rows, planes, t1, t0,
                                             stat_scale, interpret=interpret)
            return ind_reduce(l0), ind_reduce(l1)
    else:
        dtype = jnp.dtype(cfg.compute_dtype)
        a1, a0 = counts(rows)

        def stats(t1, t0):
            l0, l1 = ops.lambda_stats(a1, a0, u, t1, t0, dtype,
                                      ind_reduce=ind_reduce)
            return stat_scale * l0, stat_scale * l1

    def one_pass(lam):
        t1, t0 = ops.exp_elog_beta(lam)
        l0, l1 = stats(t1, t0)
        return jnp.stack([cfg.beta_a + l0, cfg.beta_b + l1], axis=-1)

    return one_pass


def solve(cfg: SVIConfig, kernel: str, rows, u, lamb_b, *, sub_key=None,
          sub_cols: int = 0, ind_reduce=ops._identity, interpret=False):
    """Converged lamb_b (B, K, 2) of the local coordinate ascent.

    With `sub_key` and `sub_cols` > 0 the iterations run on the big-N
    column subsample (then, with cfg.local_refine_full, one exact pass).
    """
    kw = dict(ind_reduce=ind_reduce, interpret=interpret)
    if sub_key is not None and sub_cols:
        w = rows.shape[1]
        cols = jax.random.choice(sub_key, w, (sub_cols,), replace=False)
        u_sub = u.reshape(w, 4, -1)[cols].reshape(4 * sub_cols, -1)
        iterate = make_pass(cfg, kernel, rows[:, cols], u_sub,
                            stat_scale=w / sub_cols, **kw)
    else:
        iterate = make_pass(cfg, kernel, rows, u, **kw)
    lam = ops.solve_schedule(iterate, lamb_b, local_iters=cfg.local_iters,
                             local_tol=cfg.local_tol, accel=cfg.local_accel)
    if sub_key is not None and sub_cols and cfg.local_refine_full:
        lam = make_pass(cfg, kernel, rows, u, **kw)(lam)
    return lam


def step_stats(cfg: SVIConfig, kernel: str, rows, u, lamb_b, *,
               sub_key=None, sub_cols: int = 0, ind_reduce=ops._identity,
               interpret=False):
    """Local solve + exact statistics of one minibatch.

    Returns (new_lamb_b (B, K, 2), gamma_stat (4W, K)); gamma_stat is
    this shard's partial over its SNPs (callers psum it over 'snp')."""
    lam = solve(cfg, kernel, rows, u, lamb_b, sub_key=sub_key,
                sub_cols=sub_cols, ind_reduce=ind_reduce,
                interpret=interpret)
    t1, t0 = ops.exp_elog_beta(lam)
    a1, a0 = counts(rows)
    stats = ops.batch_stats(a1, a0, u, t1, t0, jnp.dtype(cfg.compute_dtype),
                            ind_reduce=ind_reduce)
    new_lamb_b = jnp.stack([cfg.beta_a + stats.lam0_stat,
                            cfg.beta_b + stats.lam1_stat], axis=-1)
    return new_lamb_b, stats.gamma_stat
