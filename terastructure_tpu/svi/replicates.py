"""Batched multi-seed replicates — the reference's 10-seed workflow as
ONE vmapped compile.

The reference's recommended protocol fits R seeds and keeps the best
validation log-likelihood (SURVEY.md §1.2 step 6; upstream scripts
drive the binary R times). The serial port (cli.py --replicates) pays
R full fits: R compiles, R x per-chunk dispatch tax, R eval recomputes.
On an accelerator the replicates are a pure data-parallel axis ON TOP
of the model: every replicate shares the packed genotype matrix
(read-only in device memory) and the step program, differing only in
(gamma, lamb, key). So: stack the R states and `jax.vmap` the step —
one compile, one dispatch per chunk for all R, one batched eval per
check.

Semantics vs the serial loop:
  - identical per-replicate math: the minibatch stream comes from each
    replicate's own fold_in(key, t) schedule, exactly as a serial fit
    with that seed (verified: tests/test_replicates.py asserts the
    batched gamma trajectory == R serial fits, bitwise on CPU);
  - identical best-validation selection: each replicate's validation
    ll is frozen at ITS OWN convergence check (the step it would have
    stopped at serially); stepping past convergence in lockstep does
    not change the recorded score;
  - the batch runs until EVERY replicate has converged (or max_steps).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data.dataset import GenotypeData
from terastructure_tpu.models import psd
from terastructure_tpu.ops import local_step
from terastructure_tpu.ops import stats_dense as ops
from terastructure_tpu.svi import engine


@dataclasses.dataclass
class ReplicateResult:
    seed: int
    converged: bool
    steps: int                  # step of this replicate's convergence
    validation_ll: float        # ll frozen at its convergence check
    heldout_ll: Optional[float]


@dataclasses.dataclass
class BatchedFitResult:
    replicates: List[ReplicateResult]
    best: int                   # index into replicates / states
    states: engine.SVIState     # stacked (R, ...) final states
    trace: List[dict]
    wall_s: float


def _stack_states(cfg: SVIConfig, seeds, l_padded) -> engine.SVIState:
    states = [engine.init_state(cfg.replace(seed=s), l_padded=l_padded)
              for s in seeds]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def fit_replicates_batched(
    cfg: SVIConfig,
    data: GenotypeData,
    seeds,
    *,
    callback=None,
) -> BatchedFitResult:
    """Fit len(seeds) replicates in lockstep under one vmapped jit.

    Shares driver.fit's convergence rule per replicate (relative
    validation-ll improvement < conv_tol for conv_patience consecutive
    checks). Single-process, single-device (the sharded/stream paths
    keep the serial loop)."""
    seeds = list(seeds)
    r = len(seeds)
    packed = np.asarray(data.packed)
    wpad = (-packed.shape[1]) % 128
    if wpad:
        packed = np.pad(packed, ((0, 0), (0, wpad)), constant_values=0xFF)
    packed = jax.device_put(packed)
    l_sample = int(packed.shape[0])

    states = _stack_states(cfg, seeds, l_sample)
    step = engine.make_step(cfg, l_sample)

    def chunk_one(state, packed_):
        def body(_, s):
            return step(s, packed_)
        return jax.lax.fori_loop(0, cfg.rfreq, body, state)

    run_chunk = jax.jit(jax.vmap(chunk_one, in_axes=(0, None)),
                        donate_argnums=(0,))

    # ---- batched validation scorer --------------------------------------
    local_mode = cfg.lambda_mode == "local"
    val = data.validation
    scorer = None
    if val is not None and len(val):
        ii = jax.device_put(np.asarray(val.ind_idx))
        xv = jax.device_put(np.asarray(val.x))
        if local_mode:
            from terastructure_tpu.svi.postprocess import solve_lambda_blocks

            uniq, inv = np.unique(val.snp_idx, return_inverse=True)
            if data.eval_rows_full is not None:
                snps = np.asarray(data.eval_row_snps)
                pos = np.searchsorted(snps, uniq)
                eval_rows = np.asarray(data.eval_rows_full)[pos]
            else:
                eval_rows = np.asarray(data.packed)[uniq]
            if wpad:
                eval_rows = np.pad(eval_rows, ((0, 0), (0, wpad)),
                                   constant_values=0xFF)
            eval_rows = jax.device_put(eval_rows)
            inv = jax.device_put(inv.astype(np.int32))
            w = eval_rows.shape[1]
            # one fixed eval subsample key for EVERY replicate: scores
            # stay deterministic AND directly comparable across seeds
            sub_key = jax.random.PRNGKey(cfg.seed ^ 0xE7A1)

            @jax.jit
            def scores(gammas):
                def one(gamma):
                    u = local_step.pad_u(ops.exp_elog_theta(gamma), w)
                    lamb_eval = solve_lambda_blocks(
                        cfg, u, eval_rows, block=1024, sub_key=sub_key)
                    if cfg.predictive == "variational":
                        return jnp.mean(psd.variational_predictive_loglik(
                            gamma[ii], lamb_eval[inv], xv))
                    beta = psd.beta_mean(lamb_eval)
                    th = psd.theta_mean(gamma[ii])
                    p = jnp.sum(th * beta[inv], axis=-1)
                    return jnp.mean(psd.binomial2_loglik(xv, p))
                return jax.vmap(one)(gammas)

            scorer = lambda st: np.asarray(scores(st.gamma))  # noqa: E731
        else:
            jj = jax.device_put(np.asarray(val.snp_idx))

            @jax.jit
            def scores_stored(gammas, lambs):
                return jax.vmap(
                    lambda g, lm: engine.entry_loglik(
                        g, lm, ii, jj, xv, form=cfg.predictive)
                )(gammas, lambs)

            scorer = lambda st: np.asarray(      # noqa: E731
                scores_stored(st.gamma, st.lamb))

    best_ll = np.full(r, -np.inf)
    stall = np.zeros(r, np.int32)
    done = np.zeros(r, bool)
    ll_at_stop = np.full(r, np.nan)
    step_at_stop = np.zeros(r, np.int64)
    trace: List[dict] = []
    t0 = time.time()
    steps_done = 0
    while steps_done < cfg.max_steps:
        states = run_chunk(states, packed)
        steps_done = int(states.t[0])
        rec = {"step": steps_done,
               "wall_s": round(time.time() - t0, 3)}
        if scorer is not None:
            lls = scorer(states)
            rec["validation_ll"] = [round(float(v), 6) for v in lls]
            if not np.isfinite(lls).all():
                break
            with np.errstate(invalid="ignore"):
                # first check: best_ll is -inf -> rel = +inf (improved)
                rel = np.where(
                    np.isfinite(best_ll),
                    (lls - best_ll) / (np.abs(best_ll) + 1e-12), np.inf)
            best_ll = np.maximum(best_ll, lls)
            stall = np.where(rel < cfg.conv_tol, stall + 1, 0)
            newly = (~done) & (stall >= cfg.conv_patience)
            ll_at_stop[newly] = lls[newly]
            step_at_stop[newly] = steps_done
            done |= newly
        trace.append(rec)
        if callback:
            callback(rec)
        if scorer is not None and done.all():
            break

    lls_final = scorer(states) if scorer is not None else np.full(r, np.nan)
    ll_at_stop = np.where(done, ll_at_stop, lls_final)
    step_at_stop = np.where(done, step_at_stop, steps_done)

    reps = [ReplicateResult(
        seed=seeds[i], converged=bool(done[i]),
        steps=int(step_at_stop[i]),
        validation_ll=float(ll_at_stop[i]),
        heldout_ll=None) for i in range(r)]
    best = int(np.nanargmax(ll_at_stop)) if np.isfinite(
        ll_at_stop).any() else 0
    return BatchedFitResult(replicates=reps, best=best, states=states,
                            trace=trace, wall_s=time.time() - t0)


def unstack_state(states: engine.SVIState, i: int) -> engine.SVIState:
    """Extract replicate i's SVIState from the stacked result."""
    return jax.tree.map(lambda x: x[i], states)
