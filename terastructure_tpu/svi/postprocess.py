"""compute-beta post-pass: refit every SNP's lambda with theta frozen.

Reference parity: the `-compute-beta` mode (SURVEY.md §3.2) reloads a
converged run's theta and, for each SNP j, runs the local phi/lambda fit
with theta fixed, writing beta.txt. Here it is a loop over SNP blocks
reusing the training step's local solve (ops/local_step.py) —
embarrassingly parallel on the SNP axis (shard over 'snp' for
multi-chip).

`solve_lambda_blocks` is the shared core: it also powers the "local"
lambda mode's on-demand eval/export recomputation (svi/driver.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.models import psd
from terastructure_tpu.ops import local_step
from terastructure_tpu.ops import stats_dense as ops
from terastructure_tpu.ops.lambda_pass import resolve_kernel


def solve_lambda_blocks(cfg: SVIConfig, u, packed_rows, *,
                        block: int = 1024, sub_key=None,
                        interpret: bool = False):
    """Converged lambda for each packed row given fixed u = expElogtheta.

    u: (N', K) where N' = 4 * packed_rows.shape[1] (caller pads);
    packed_rows: (S, W) uint8. Returns lamb (S, K, 2) f32 (jnp).

    Rows are processed one fixed-size block at a time through a single
    jitted block solver — NOT by stacking all blocks first: packed_rows
    may be a device-resident biobank matrix (reshuffling it would double
    device memory) or a host memmap larger than it (each block is
    transferred on demand). Only one (block, W) slice is live per
    iteration.

    sub_key enables the big-N iteration subsample (cfg.local_sub_n,
    ops/local_step.py): the coordinate-ascent iterations run on a fixed
    byte-column subsample, the final lambda statistic is one exact
    pass. Pass a FIXED key (eval scoring) so scores stay deterministic
    across checks.
    """
    s, w = packed_rows.shape
    nblocks = (s + block - 1) // block
    kernel = resolve_kernel(cfg.kernel, cfg.compute_dtype, cfg.k,
                            interpret=interpret)
    lamb0 = local_step.prior_lambda(cfg, block)
    sub_cols = local_step.sub_columns(cfg, w)

    def solve_block(rows, u, lamb0):
        lam = local_step.solve(cfg, kernel, rows, u, lamb0, sub_key=sub_key,
                               sub_cols=sub_cols, interpret=interpret)
        return local_step.make_pass(cfg, kernel, rows, u,
                                    interpret=interpret)(lam)

    solve = jax.jit(solve_block)
    outs = []
    for i in range(nblocks):
        lo = i * block
        hi = min(lo + block, s)
        rows = jnp.asarray(packed_rows[lo:hi])
        if hi - lo < block:
            rows = jnp.concatenate(
                [rows, jnp.full((block - (hi - lo), w), 0xFF, jnp.uint8)])
        outs.append(solve(rows, u, lamb0))
    out = outs[0] if nblocks == 1 else jnp.concatenate(outs, axis=0)
    return out[:s]


def compute_lambda(cfg: SVIConfig, gamma, packed, *, block: int = 1024):
    """Full-matrix converged lambda (L, K, 2) given gamma — used by the
    'local' lambda mode before export, and by compute_beta."""
    u = local_step.pad_u(ops.exp_elog_theta(jnp.asarray(gamma)),
                         packed.shape[1])
    lamb = solve_lambda_blocks(cfg, u, packed, block=block)
    return lamb[: cfg.l]


def compute_beta(cfg: SVIConfig, gamma, packed, *, block: int = 1024) -> np.ndarray:
    """Final beta estimates (L, K) given converged gamma (N, K)."""
    return np.asarray(psd.beta_mean(compute_lambda(cfg, gamma, packed,
                                                   block=block)))
