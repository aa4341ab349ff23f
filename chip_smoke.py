#!/usr/bin/env python3
"""Smoke test of the SVI fit on a GPU: the quickest proof that the system
still starts on the card.

    python chip_smoke.py              # one card: phases A-E
    python chip_smoke.py --cards 4    # four cards: A and the sharded phase F

Phases (all in this one process — a JAX process reserves most of the
card's memory, so a second one could not start):

  A  device: the platform must be 'gpu'; print the card and power limit.
  B  CLI round trip through cli.main at 1000 x 10,000, K=3, seed 11: the
     fit converges, theta MAE < 0.05 against the simulated truth, heldout
     log-likelihood > oracle - 0.02, and the checkpoint restores and
     resumes.
  C  full width: driver.fit at the TGP shape (2,504 x 1,000,000, K=8,
     B=4096, accel-7, local lambda mode) for three rfreq chunks with evals.
  D  the lambda-pass kernel against the plain float32 reference
     (stats_dense.lambda_stats at matmul precision 'highest') at
     B=4096 x N=2,504 K=8 and B=4096 x N=100,000 K=10 with 2% missing
     entries, then one full step of each path from the same state.
  E  steady-state run_chunk with the kernel and with the dense path at
     both shapes of D.
  F  (--cards 4) parallel.fit_sharded at the config-5 per-card share
     (100,000 x 100,000, K=10, B=4096) on a 1x4 and a 2x2 mesh: rates,
     and gamma after a few steps against the same steps on one card.

Every phase prints one JSON line with the card's name and power limit.
Any failure raises: the script exits non-zero and prints no result. The
last line is {"ok": true, "device": {...}} as JAX reports the device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out", "chip_smoke")

# Tolerances of phase D, relative to the float32 'highest' reference.
# The kernel's dots and the dense path's default-precision dots both
# take TF32 operands (10 explicit mantissa bits, rounding 2^-11 ~ 4.9e-4
# per operand); a pass rounds t, u and R once each before float32
# accumulation, so 2e-3 bounds one pass. A full step carries that through
# ~7 passes and the Aitken extrapolation, whose step d1^2/(d0-d1)
# amplifies noise near its clamp, so gamma after one step is held to
# 2e-2 at its worst coordinate and 2e-3 at its 99th percentile.
TOL_PASS = 2e-3
TOL_STEP_MAX = 2e-2
TOL_STEP_P99 = 2e-3
# Phase F: sharded vs one-card gamma after a few steps. Same kernel and
# inputs; only the order of float32 sums differs (psum over shards), so
# rounding-level differences amplified by the Aitken step.
TOL_SHARD_MAX = 1e-2


class Compiles:
    """Seconds spent in XLA backend compiles (cache reads included) and
    persistent-cache hits/misses, from JAX's monitoring events."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.hits = 0
        self.misses = 0
        jax.monitoring.register_event_duration_secs_listener(self._dur)
        jax.monitoring.register_event_listener(self._event)

    def _dur(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1


class Report:
    def __init__(self, card: str, compiles: Compiles):
        self.card = card
        self.compiles = compiles
        self._mark = 0.0

    def phase(self, name: str, **numbers):
        spent = self.compiles.seconds - self._mark
        self._mark = self.compiles.seconds
        rec = {"phase": name, "card": self.card, **numbers,
               "compile_s": round(spent, 3)}
        print(json.dumps(rec), flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    lines = out.splitlines()
    print(out, flush=True)
    return lines[0].strip()


def _rel(got, want):
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / (np.abs(want) + 1e-6)


def _peak_bytes(dev) -> int:
    return int(dev.memory_stats().get("peak_bytes_in_use", -1))


# ---- B: CLI round trip ------------------------------------------------------

def phase_b(rep: Report):
    import jax.numpy as jnp
    import numpy as np

    from terastructure_tpu import cli
    from terastructure_tpu.data import GenotypeData, simulate_psd
    from terastructure_tpu.io.checkpoint import restore_checkpoint
    from terastructure_tpu.models import psd
    from terastructure_tpu.utils import mean_abs_theta_error

    n, l, k, seed = 1000, 10_000, 3, 11
    work = os.path.join(OUT, "cli")
    stem = os.path.join(work, "sim")
    theta_true, beta_true, _ = simulate_psd(n, l, k, seed=seed)
    cli.main(["simulate", "-n", str(n), "-l", str(l), "-k", str(k),
              "--seed", str(seed), "-o", stem])
    fit_args = ["fit", "--bed", stem + ".bed", "-k", str(k),
                "--batch-size", "256", "--rfreq", "50", "--seed", str(seed),
                "--label", "smoke", "--out-base", work]
    t0 = time.perf_counter()
    cli.main(fit_args + ["--max-steps", "3000"])
    wall = time.perf_counter() - t0
    run_dir = os.path.join(work, f"n{n}-k{k}-l{l}-smoke")
    with open(os.path.join(run_dir, "result.json")) as f:
        res = json.load(f)

    state, _ = restore_checkpoint(os.path.join(run_dir, "checkpoint"))
    theta = np.asarray(psd.theta_mean(jnp.asarray(state.gamma[:n])))
    mae = mean_abs_theta_error(theta, theta_true)
    data = GenotypeData.from_bed(stem + ".bed", validation_frac=0.005,
                                 heldout_frac=0.005, seed=seed)
    h = data.heldout
    p = (theta_true[h.ind_idx] * beta_true[h.snp_idx]).sum(-1)
    oracle = float(np.mean(np.asarray(psd.binomial2_loglik(
        jnp.asarray(h.x), jnp.asarray(p, jnp.float32)))))

    steps = int(res["steps"])
    cli.main(fit_args + ["--max-steps", str(steps + 100), "--resume"])
    with open(os.path.join(run_dir, "result.json")) as f:
        res2 = json.load(f)
    rep.phase("B", converged=res["converged"], steps=steps,
              fit_wall_s=round(wall, 3), theta_mae=round(mae, 5),
              heldout_ll=res["heldout_ll"], oracle_ll=oracle,
              resumed_steps=res2["steps"],
              resumed_validation_ll=res2["validation_ll"])
    assert res["converged"], res
    assert mae < 0.05, mae
    assert res["heldout_ll"] > oracle - 0.02, (res["heldout_ll"], oracle)
    assert res2["steps"] == steps + 100, res2
    assert np.isfinite(res2["validation_ll"]), res2


# ---- C: full width ------------------------------------------------------------

TGP = dict(n=2504, l=1_000_000, k=8)
C5 = dict(n=100_000, l=100_000, k=10)


def _device_data(n, l, k, seed=0, carve=True):
    """Simulated PSD matrix drawn and kept on the device, with the
    driver's validation/heldout carve (data/dataset.carve_eval_device)."""
    from terastructure_tpu.data.dataset import GenotypeData, carve_eval_device
    from terastructure_tpu.data.simulate import (
        simulate_packed_device_resident)

    packed, _ = simulate_packed_device_resident(n, l, k, seed=seed)
    if not carve:
        return packed, None
    packed, val, held, pool, rows = carve_eval_device(packed, n, seed=seed)
    data = GenotypeData(n=n, l=l, packed=packed, validation=val,
                        heldout=held, eval_rows_full=rows,
                        eval_row_snps=pool)
    return packed, data


def phase_c(rep: Report, dev):
    import numpy as np

    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.svi import driver

    t0 = time.perf_counter()
    packed, data = _device_data(**TGP)
    sim_s = time.perf_counter() - t0
    cfg = SVIConfig(**TGP, batch_size=4096, rfreq=100, max_steps=300,
                    seed=0)
    t0 = time.perf_counter()
    res = driver.fit(cfg, data, packed=packed)
    wall = time.perf_counter() - t0
    steady = res.trace[1:]                    # the first chunk compiles
    chunk_s = sum(r["chunk_s"] for r in steady)
    eval_s = sum(r.get("eval_s", 0.0) for r in steady)
    steps = len(steady) * cfg.rfreq
    rep.phase("C", shape=[TGP["n"], TGP["l"], TGP["k"]],
              batch=cfg.batch_size, steps=res.steps,
              snp_updates_per_s=steps * cfg.batch_size / (chunk_s + eval_s),
              chunk_only_snp_updates_per_s=steps * cfg.batch_size / chunk_s,
              chunk_s=[r["chunk_s"] for r in res.trace],
              eval_s=[r.get("eval_s") for r in res.trace],
              validation_ll=res.validation_ll, heldout_ll=res.heldout_ll,
              peak_bytes_in_use=_peak_bytes(dev), sim_s=round(sim_s, 3),
              fit_wall_s=round(wall, 3))
    assert res.steps == 300, res.steps
    assert np.isfinite(res.validation_ll), res.validation_ll
    return packed, res.state


# ---- D: kernel against the plain reference -----------------------------------

def _pass_inputs(b, n, k, seed):
    """Packed rows with 2% MISSING entries and realistic u, t factors."""
    import jax
    import jax.numpy as jnp

    from terastructure_tpu.ops import stats_dense as ops

    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    w = n // 4
    p = jax.random.uniform(ks[0], (b, 1), minval=0.05, maxval=0.95)
    g = ((jax.random.uniform(ks[1], (b, 4 * w)) < p).astype(jnp.int32)
         + (jax.random.uniform(ks[2], (b, 4 * w)) < p).astype(jnp.int32))
    g = jnp.where(jax.random.uniform(ks[3], (b, 4 * w)) < 0.02, 3, g)
    g = g.reshape(b, w, 4)
    rows = (g[..., 0] | g[..., 1] << 2 | g[..., 2] << 4
            | g[..., 3] << 6).astype(jnp.uint8)
    u = ops.exp_elog_theta(
        1.0 / k + 40.0 * jax.random.uniform(ks[4], (4 * w, k)))
    t1, t0 = ops.exp_elog_beta(
        1.0 + 300.0 * jax.random.uniform(ks[5], (b, k, 2)))
    return rows, u, t1, t0


def phase_d(rep: Report, tgp_packed, tgp_state, c5_packed):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.ops import lambda_pass, local_step
    from terastructure_tpu.ops import stats_dense as ops
    from terastructure_tpu.svi import engine

    lam_ref = jax.jit(ops.lambda_stats)
    for (b, n, k) in ((4096, TGP["n"], TGP["k"]), (4096, C5["n"], C5["k"])):
        rows, u, t1, t0 = _pass_inputs(b, n, k, seed=n)
        a1, a0 = local_step.counts(rows)
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(ops.lambda_stats)(a1, a0, u, t1, t0)
        dense = lam_ref(a1, a0, u, t1, t0)
        kern = lambda_pass.lambda_pass(rows, lambda_pass.u_to_planes(u),
                                       t1, t0)
        err_k = max(float(_rel(g, w).max()) for g, w in zip(kern, ref))
        err_d = max(float(_rel(g, w).max()) for g, w in zip(dense, ref))
        rep.phase("D-pass", shape=[b, n, k], missing=0.02,
                  kernel_max_rel_err=err_k, dense_max_rel_err=err_d,
                  tolerance=TOL_PASS)
        assert err_k <= TOL_PASS, (err_k, TOL_PASS)
        del rows, a1, a0, ref, dense, kern

    # One full step of each path from the same state.
    cases = (("tgp", TGP, tgp_packed, tgp_state),
             ("config5_share", C5, c5_packed, None))
    for tag, shape, packed, state in cases:
        cfg = SVIConfig(**shape, batch_size=4096, seed=1)
        if state is None:
            state = engine.init_state(cfg)
        state = engine.SVIState(state.gamma[: shape["n"]],
                                state.lamb[:1], jnp.int32(0), state.key)
        out = {}
        for kern in ("triton", "dense", "reference"):
            c = cfg.replace(kernel="dense" if kern == "reference" else kern)
            step = jax.jit(engine.make_step(c, shape["l"]))
            if kern == "reference":
                with jax.default_matmul_precision("highest"):
                    step = jax.jit(engine.make_step(c, shape["l"]))
                    out[kern] = np.asarray(step(state, packed).gamma)
            else:
                out[kern] = np.asarray(step(state, packed).gamma)
        rk = _rel(out["triton"], out["reference"])
        rd = _rel(out["dense"], out["reference"])
        rep.phase("D-step", case=tag, kernel_max_rel_err=float(rk.max()),
                  kernel_p99_rel_err=float(np.quantile(rk, 0.99)),
                  dense_max_rel_err=float(rd.max()),
                  dense_p99_rel_err=float(np.quantile(rd, 0.99)),
                  tolerance_max=TOL_STEP_MAX, tolerance_p99=TOL_STEP_P99)
        assert np.isfinite(out["triton"]).all()
        assert rk.max() <= TOL_STEP_MAX, rk.max()
        assert np.quantile(rk, 0.99) <= TOL_STEP_P99


# ---- E: kernel against XLA, end to end ----------------------------------------

def phase_e(rep: Report, dev, tag, shape, packed, nsteps):
    import jax

    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.svi import engine

    cfg = SVIConfig(**shape, batch_size=4096, seed=2)
    runs = {k: engine.make_run_chunk(cfg.replace(kernel=k), nsteps,
                                     shape["l"])
            for k in ("dense", "triton")}
    times = {"dense": [], "triton": []}
    for kern in ("dense", "triton"):            # compile + warm
        jax.block_until_ready(runs[kern](engine.init_state(cfg), packed))
    for kern in ("dense", "triton", "triton", "dense"):
        state = engine.init_state(cfg)
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        jax.block_until_ready(runs[kern](state, packed))
        times[kern].append(time.perf_counter() - t0)
    ms = {k: 1e3 * sum(v) / len(v) / nsteps for k, v in times.items()}
    rep.phase("E", case=tag, shape=[shape["n"], shape["l"], shape["k"]],
              batch=cfg.batch_size, steps_per_chunk=nsteps,
              dense_ms_per_step=ms["dense"], triton_ms_per_step=ms["triton"],
              dense_snp_updates_per_s=cfg.batch_size / ms["dense"] * 1e3,
              triton_snp_updates_per_s=cfg.batch_size / ms["triton"] * 1e3,
              speedup=ms["dense"] / ms["triton"],
              chunk_times_s={k: [round(x, 6) for x in v]
                             for k, v in times.items()},
              peak_bytes_in_use=_peak_bytes(dev))
    return ms


# ---- F: four cards ---------------------------------------------------------------

def _replay_one_card(cfg, data_packed, snp, nsteps, dev):
    """The sharded steps' arithmetic on one card: each SNP shard's
    minibatch drawn from the same keys, its local step, the summed gamma
    statistic (the psum over 'snp'), the same update."""
    import jax
    import jax.numpy as jnp

    from terastructure_tpu.ops import local_step
    from terastructure_tpu.ops import stats_dense as ops
    from terastructure_tpu.ops.lambda_pass import resolve_kernel
    from terastructure_tpu.svi import engine

    kernel = resolve_kernel(cfg.kernel, cfg.compute_dtype, cfg.k)
    b_local, l_local = cfg.batch_size // snp, cfg.l // snp
    state = engine.init_state(cfg)
    packed = jax.device_put(data_packed, dev)

    @jax.jit
    def step(gamma, packed, key, t):
        u = ops.exp_elog_theta(gamma)
        stat = jnp.zeros_like(gamma)
        for s in range(snp):
            kb = jax.random.fold_in(jax.random.fold_in(key, t), s)
            idx = jax.random.randint(kb, (b_local,), 0, l_local, jnp.int32)
            rows = packed[s * l_local + idx]
            _, g = local_step.step_stats(
                cfg, kernel, rows, u, local_step.prior_lambda(cfg, b_local))
            stat = stat + g
        return engine._global_update(cfg, gamma, stat, t, cfg.l)

    gamma = jax.device_put(state.gamma, dev)
    for t in range(nsteps):
        gamma = step(gamma, packed, state.key, jnp.int32(t))
    return jax.device_get(gamma)


def phase_f(rep: Report):
    import jax
    import numpy as np

    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.parallel import fit_sharded
    from terastructure_tpu.parallel import mesh as meshlib
    from terastructure_tpu.parallel import sharded

    devs = jax.devices()
    assert len(devs) == 4, devs
    t0 = time.perf_counter()
    packed0, data = _device_data(**C5)      # on the first card
    sim_s = time.perf_counter() - t0
    base = SVIConfig(**C5, batch_size=4096, seed=3, rfreq=25, max_steps=150)
    nsteps = 3

    # One card, same data and config: the scaling reference.
    from terastructure_tpu.svi import engine

    run1 = engine.make_run_chunk(base, base.rfreq, C5["l"])
    jax.block_until_ready(run1(engine.init_state(base), packed0))
    t0 = time.perf_counter()
    jax.block_until_ready(run1(engine.init_state(base), packed0))
    rate1 = base.rfreq * base.batch_size / (time.perf_counter() - t0)
    rep.phase("F-one-card", shape=[C5["n"], C5["l"], C5["k"]],
              batch=base.batch_size, snp_updates_per_s=rate1)
    for ind, snp in ((1, 4), (2, 2)):
        mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=ind, snp=snp))
        # Parity: the exact solve (local_sub_n=0), so that the column
        # subsample, drawn per 'ind' shard, does not differ by layout.
        cfg_p = base.replace(local_sub_n=0)
        plan, pk = sharded.prepare(cfg_p, data, mesh)
        st = sharded.make_sharded_run_chunk(cfg_p, plan, mesh, nsteps)(
            sharded.init_sharded_state(cfg_p, plan, mesh), pk)
        got = np.asarray(jax.device_get(st.gamma))[: C5["n"]]
        del pk, st
        want = _replay_one_card(cfg_p, data.packed, snp, nsteps, devs[0])
        err = _rel(got, want)

        res = fit_sharded(base, data, mesh=mesh)
        steady = res.trace[1:]
        secs = sum(r["chunk_s"] + r.get("eval_s", 0.0) for r in steady)
        rate = len(steady) * base.rfreq * base.batch_size / secs
        rep.phase("F", mesh=[ind, snp], shape=[C5["n"], C5["l"], C5["k"]],
                  batch=base.batch_size, parity_steps=nsteps,
                  gamma_max_rel_err=float(err.max()),
                  gamma_p99_rel_err=float(np.quantile(err, 0.99)),
                  tolerance=TOL_SHARD_MAX, steps=res.steps,
                  snp_updates_per_s=rate,
                  scaling_efficiency=rate / (4 * rate1),
                  chunk_s=[r["chunk_s"] for r in res.trace],
                  eval_s=[r.get("eval_s") for r in res.trace],
                  validation_ll=res.validation_ll, sim_s=round(sim_s, 3))
        assert err.max() <= TOL_SHARD_MAX, err.max()
        assert np.isfinite(res.validation_ll)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="1: phases A-E on one card; 4: phase F only")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "terastructure_tpu")):
        sys.exit("chip_smoke.py must run from a checkout of the repository")
    if args.cards == 1:
        # One card: the CLI shards over every visible device otherwise.
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    sys.path.insert(0, HERE)

    import jax

    from terastructure_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    compiles = Compiles()
    t_start = time.perf_counter()

    # ---- A: device
    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU: JAX found {dev.platform!r} devices")
    if len(devs) != args.cards:
        sys.exit(f"--cards {args.cards} but JAX sees {len(devs)} GPUs")
    card = _card_line()
    rep = Report(card, compiles)
    rep.phase("A", platform=dev.platform, device_kind=dev.device_kind,
              count=len(devs), jax=jax.__version__, cache_dir=cache_dir)
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT, exist_ok=True)

    if args.cards == 4:
        phase_f(rep)
    else:
        phase_b(rep)
        tgp_packed, tgp_state = phase_c(rep, dev)
        c5_packed, _ = _device_data(**C5, carve=False)
        phase_d(rep, tgp_packed, tgp_state, c5_packed)
        ms_tgp = phase_e(rep, dev, "tgp", TGP, tgp_packed, 100)
        ms_c5 = phase_e(rep, dev, "config5_share", C5, c5_packed, 10)
        rep.phase("E-decision",
                  tgp_kernel_faster=ms_tgp["triton"] < ms_tgp["dense"],
                  config5_kernel_not_slower=(ms_c5["triton"]
                                             <= ms_c5["dense"]))

    rep.phase("total", wall_s=round(time.perf_counter() - t_start, 3),
              compile_s_total=round(compiles.seconds, 3),
              cache_hits=compiles.hits, cache_misses=compiles.misses)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
