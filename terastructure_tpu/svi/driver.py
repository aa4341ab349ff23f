"""Fit driver: the host-side outer loop with convergence assessment.

Reference behavior reproduced (SURVEY.md §1.2 step 5, §3.1): every `rfreq`
iterations compute validation predictive log-likelihood; declare
convergence when relative improvement stays below `conv_tol` for
`conv_patience` consecutive checks (or it decreases); keep a log-lik trace.
On top of that we emit structured JSONL metrics (SURVEY.md §5) and can
checkpoint via io/checkpoint.py.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data.dataset import GenotypeData
from terastructure_tpu.svi import engine

log = logging.getLogger("terastructure_tpu")


@dataclasses.dataclass
class FitResult:
    state: engine.SVIState
    trace: List[dict]                 # per-check metrics
    converged: bool
    steps: int
    validation_ll: float
    heldout_ll: Optional[float]
    wall_s: float


def fit(
    cfg: SVIConfig,
    data: GenotypeData,
    *,
    state: Optional[engine.SVIState] = None,
    step_fn_factory: Optional[Callable] = None,
    packed=None,
    metrics_path: Optional[str] = None,
    trace_path: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 5,
    callback: Optional[Callable[[dict], None]] = None,
    stream: bool = False,
) -> FitResult:
    """Run SVI until convergence or cfg.max_steps.

    `step_fn_factory(cfg, nsteps, l_sample)` lets the sharded path
    (parallel/) substitute its own chunk runner while reusing this
    convergence logic; `packed` may be a pre-sharded device array
    (otherwise the host matrix is width-padded and device_put here).

    stream=True keeps the packed matrix HOST-side (ndarray or np.memmap)
    and double-buffers minibatch rows to the device per step
    (svi/stream.py) — the out-of-core path for datasets larger than HBM
    or host RAM. Requires lambda_mode='local', single process.
    """
    assert cfg.n == data.n and cfg.l == data.l, "config/data shape mismatch"
    multiproc = jax.process_count() > 1
    lead = jax.process_index() == 0

    def _pad_width(arr):
        # Pad the byte-width to a multiple of 128 (padding decodes as
        # MISSING): matrices of nearby N then share one compiled step.
        wpad = (-arr.shape[1]) % 128
        if wpad:
            arr = np.pad(arr, ((0, 0), (0, wpad)), constant_values=0xFF)
        return arr

    if stream:
        from terastructure_tpu.svi import stream as stream_mod

        if multiproc and step_fn_factory is None:
            # Only the DEFAULT single-device streamer is single-process;
            # parallel.fit_sharded(stream=True) supplies a mesh-aware
            # factory whose ShardedBatchStream assembles per-process
            # addressable blocks (parallel/stream.py).
            raise ValueError("the single-device streamer is a single-"
                             "process path; use fit_sharded(stream=True) "
                             "for multi-host")
        if packed is not None:
            raise ValueError("stream=True keeps the host matrix "
                             "host-side; don't pass a device `packed`")
        packed = data.packed                    # stays host-side
        # the sharded path (parallel.fit_sharded(stream=True)) supplies
        # its mesh-aware chunk runner; default is the 1-device streamer
        factory = step_fn_factory or stream_mod.make_stream_chunk
    elif packed is None:
        packed = jax.device_put(_pad_width(np.asarray(data.packed)))
    if state is None:
        state = engine.init_state(cfg, l_padded=packed.shape[0])
        if cfg.init == "spectral":
            from terastructure_tpu.svi.init import spectral_gamma

            state = state._replace(gamma=spectral_gamma(
                data.packed, cfg.n, cfg.k, alpha=cfg.alpha_value,
                seed=cfg.seed, l_real=cfg.l))

    factory = (factory if stream
               else step_fn_factory or engine.make_run_chunk)
    run_chunk = factory(cfg, cfg.rfreq, int(packed.shape[0]))

    local_mode = cfg.lambda_mode == "local"

    def _eval_rows(uniq):
        """Full-width packed rows of the unique eval SNPs."""
        if data.eval_rows_full is not None:
            snps = np.asarray(data.eval_row_snps)
            pos = np.searchsorted(snps, uniq)
            if not np.array_equal(snps[pos], uniq):
                raise ValueError("eval entry SNPs missing from eval_rows_full")
            if isinstance(data.eval_rows_full, jax.Array):
                # Device-resident rows (carve_eval_device): gather on
                # device, never round-trip to host.
                return data.eval_rows_full[jnp.asarray(pos)]
            return _pad_width(np.asarray(data.eval_rows_full)[pos])
        if data.is_local_slice:
            raise ValueError(
                "local-slice GenotypeData needs eval_rows_full for "
                "local-mode eval (multihost.load_bed_shard provides it)")
        return _pad_width(np.asarray(data.packed)[uniq])

    def _put(a):
        """Host array -> device. In multi-process runs small eval inputs
        must be globally replicated (every process holds the same data —
        the carve is deterministic) so they can feed SPMD jits alongside
        the mesh-sharded state."""
        a = np.asarray(a)
        if multiproc:
            from jax.sharding import NamedSharding, PartitionSpec

            rep = NamedSharding(state.gamma.sharding.mesh, PartitionSpec())
            return jax.make_array_from_callback(a.shape, rep,
                                                lambda idx: a[idx])
        return jax.device_put(a)

    def make_scorer(es):
        """(state -> mean ll) for an entry set, honoring lambda_mode."""
        if es is None or not len(es):
            return None
        if local_mode:
            uniq, inv = np.unique(es.snp_idx, return_inverse=True)
            f = engine.make_entry_loglik_recompute(
                cfg, _eval_rows(uniq), inv.astype(np.int32),
                es.ind_idx, es.x, put=_put)
            return lambda st: float(f(st.gamma))
        i = _put(es.ind_idx)
        j = _put(es.snp_idx)
        xv = _put(es.x)
        return lambda st: float(engine.entry_loglik(
            st.gamma, st.lamb, i, j, xv, form=cfg.predictive))

    val_scorer = make_scorer(data.validation)

    trace: List[dict] = []
    best_ll = -np.inf
    stall = 0
    converged = False
    checks = 0
    t0 = time.time()
    mfile = open(metrics_path, "a") if metrics_path and lead else None
    tfile = open(trace_path, "a") if trace_path and lead else None

    try:
        while int(state.t) < cfg.max_steps:
            tc = time.time()
            state = run_chunk(state, packed)
            steps_done = int(state.t)
            tc = time.time() - tc
            rec = {
                "step": steps_done,
                "wall_s": round(time.time() - t0, 3),
                "rho": float(cfg.rho(float(steps_done))),
                # fit-loop phase budget: chunk_s is the
                # dispatch-until-host-visible time of the rfreq step
                # chunk (int(state.t) syncs); eval_s the validation
                # scorer wall. Device-side asynchrony can shift work
                # between the two — their SUM per check is the honest
                # number.
                "chunk_s": round(tc, 3),
            }
            if not trace:
                rec["predictive"] = cfg.predictive
            if val_scorer is not None:
                te = time.time()
                ll = val_scorer(state)
                rec["eval_s"] = round(time.time() - te, 3)
                rec["validation_ll"] = ll
                if not np.isfinite(ll):
                    log.error("validation ll is not finite at step %d", steps_done)
                    break
                rel = (ll - best_ll) / (abs(best_ll) + 1e-12)
                if ll > best_ll:
                    best_ll = ll
                stall = stall + 1 if rel < cfg.conv_tol else 0
                if stall >= cfg.conv_patience:
                    converged = True
            trace.append(rec)
            log.info("step %(step)d  val_ll %(validation_ll).6f",
                     {**{"validation_ll": float("nan")}, **rec})
            if mfile:
                mfile.write(json.dumps(rec) + "\n")
                mfile.flush()
            if tfile and "validation_ll" in rec:
                # reference-style plain trace: iteration  loglik  wall
                tfile.write(f"{rec['step']}\t{rec['validation_ll']:.8f}"
                            f"\t{rec['wall_s']}\n")
                tfile.flush()
            if callback:
                callback(rec)
            checks += 1
            if checkpoint_dir and (converged or
                                   checks % max(checkpoint_every, 1) == 0):
                from terastructure_tpu.io.checkpoint import save_checkpoint

                # async: serialization overlaps the next chunk's steps
                save_checkpoint(checkpoint_dir, state, cfg, block=False)
            if converged:
                break
    finally:
        if mfile:
            mfile.close()
        if tfile:
            tfile.close()

    if local_mode and multiproc:
        # The full-lambda materialization below gathers the packed matrix
        # row-block-wise — fine on one host, wrong across hosts (no host
        # has all columns). Export lambda via the (sharded) compute-beta
        # post-pass instead; eval scoring above never needed state.lamb.
        log.info("multi-process run: lambda left at prior in the result; "
                 "run compute-beta for final per-SNP estimates")
    elif local_mode:
        # Materialize the full converged lambda for export/checkpoint/
        # heldout (lambda is derived state in this mode).
        if stream:
            from terastructure_tpu.svi.stream import compute_lambda_stream

            lamb_full = jnp.asarray(compute_lambda_stream(
                cfg, state.gamma[: cfg.n], packed))
        else:
            from terastructure_tpu.svi.postprocess import compute_lambda

            lamb_full = compute_lambda(cfg, state.gamma[: cfg.n], packed)
        lamb_state = state.lamb
        if lamb_state.shape[0] > cfg.l:
            lamb_full = jnp.concatenate(
                [lamb_full, lamb_state[cfg.l:]], axis=0)
        state = state._replace(lamb=lamb_full)

    if checkpoint_dir:
        from terastructure_tpu.io import checkpoint as ckpt

        # commit any in-flight async save before fit() returns
        ckpt.wait_until_finished()
    held_scorer = make_scorer(data.heldout)
    held_ll = held_scorer(state) if held_scorer is not None else None
    return FitResult(
        state=state,
        trace=trace,
        converged=converged,
        steps=int(state.t),
        validation_ll=float(trace[-1].get("validation_ll", np.nan)) if trace else np.nan,
        heldout_ll=held_ll,
        wall_s=time.time() - t0,
    )
