"""Headline benchmark: SNP-updates/s on one GPU at the TGP shape.

Engine config: the shipping defaults (kernel='auto' -> the fused
lambda-pass kernel on a GPU, lambda_mode='local', accel-7, float32
compute), batch 4096.

Prints ONE JSON line:
  {"metric": "snp_updates_per_s_per_chip", "value": N, "unit": "SNP-updates/s",
   "vs_baseline": R, "device_kind": "...", ...}

Config: BASELINE.json #3 shape — N=2,504 individuals x L=1,000,000 SNPs,
K=8 (synthetic PSD draw, simulated on the device), SVI minibatch 4096
SNPs/step. One "SNP-update" = one sampled SNP's full local phi/lambda
solve plus its share of the global gamma update (the unit the reference
loop processes per inner iteration, SURVEY.md §3.1).

vs_baseline: BASELINE.json has "published": {} (no machine-readable
reference numbers), so the baseline is the same algorithm executed by a
numpy/BLAS CPU implementation (same math, same early-exit local solve,
same shapes) measured in this run on this host — a reproducible stand-in
for the reference's multicore CPU C++ binary.

Env knobs: BENCH_L (default 1_000_000), BENCH_STEPS (default 50),
BENCH_DTYPE (float32|bfloat16, default float32). Needs a GPU.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Pin the BLAS thread pool BEFORE numpy loads: host-load-dependent
# OpenBLAS threading otherwise swings the CPU baseline by 2x.
for _v in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_v, "8")

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def numpy_step_factory(cfg, packed, n):
    """Same-algorithm CPU baseline (numpy + scipy digamma + BLAS matmuls)."""
    import scipy.special as sps

    from terastructure_tpu.data.pack import unpack2bit
    from terastructure_tpu.models.psd import MISSING

    rng = np.random.default_rng(0)
    b = cfg.batch_size

    def step(gamma, lamb, t):
        idx = rng.integers(0, lamb.shape[0], size=b)
        xb = unpack2bit(packed[idx], n)                    # (B, N)
        mask = xb != MISSING
        a1 = np.where(mask, xb, 0).astype(np.float32)
        a0 = np.where(mask, 2 - xb, 0).astype(np.float32)
        u = np.exp(sps.digamma(gamma) - sps.digamma(gamma.sum(1, keepdims=True)))
        lam = lamb[idx]
        delta, it = np.inf, 0
        while it < cfg.local_iters and delta > cfg.local_tol:
            tot = sps.digamma(lam.sum(-1))
            t1 = np.exp(sps.digamma(lam[..., 0]) - tot)
            t0 = np.exp(sps.digamma(lam[..., 1]) - tot)
            d1 = t1 @ u.T + 1e-30
            d0 = t0 @ u.T + 1e-30
            l0 = t1 * ((a1 / d1) @ u)
            l1 = t0 * ((a0 / d0) @ u)
            new = np.stack([cfg.beta_a + l0, cfg.beta_b + l1], -1)
            delta = np.abs(new - lam).mean() / (np.abs(lam).mean() + 1.0)
            lam = new
            it += 1
        tot = sps.digamma(lam.sum(-1))
        t1 = np.exp(sps.digamma(lam[..., 0]) - tot)
        t0 = np.exp(sps.digamma(lam[..., 1]) - tot)
        r1 = a1 / (t1 @ u.T + 1e-30)
        r0 = a0 / (t0 @ u.T + 1e-30)
        s = u * (r1.T @ t1 + r0.T @ t0)
        lamb[idx] = lam
        rho = (cfg.tau0 + t) ** (-cfg.kappa)
        gamma = (1 - rho) * gamma + rho * (
            cfg.alpha_value + (lamb.shape[0] / b) * s
        )
        return gamma, lamb

    return step


def main():
    n, k = 2504, 8
    l = int(os.environ.get("BENCH_L", 1_000_000))
    steps = int(os.environ.get("BENCH_STEPS", 50))
    dtype = os.environ.get("BENCH_DTYPE", "float32")

    import jax

    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.data.simulate import simulate_packed_device
    from terastructure_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    batch = int(os.environ.get("BENCH_BATCH", 4096))
    # Default = the SVIConfig defaults (accel7);
    # BENCH_ACCEL=0 + BENCH_ITERS=16 time the plain reference schedule.
    accel = os.environ.get("BENCH_ACCEL", "1") not in ("", "0")
    iters = int(os.environ.get("BENCH_ITERS",
                               7 if accel else 16))
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=batch, seed=0,
                    compute_dtype=dtype, local_accel=accel,
                    local_iters=iters)
    log(f"simulating {n}x{l} K={k} genotypes on the device ...")
    t0 = time.time()
    packed, _ = simulate_packed_device(n, l, k, seed=0)
    log(f"simulated in {time.time()-t0:.1f}s")
    return _run(cfg, packed, n, steps, dev)


def _run(cfg, packed, n, steps, dev):
    l, k = cfg.l, cfg.k
    import jax
    from terastructure_tpu.svi import engine

    log(f"backend: {jax.default_backend()} devices: {jax.devices()}")
    state = engine.init_state(cfg)
    packed_dev = jax.device_put(packed)
    run_chunk = engine.make_run_chunk(cfg, steps)

    t0 = time.time()
    state = jax.block_until_ready(run_chunk(state, packed_dev))
    log(f"compile+warmup {time.time()-t0:.1f}s")

    # Steady-state measurement: several chunk dispatches back-to-back
    # with ONE final sync — exactly how the fit loop runs between rfreq
    # evals.
    nchunks = int(os.environ.get("BENCH_CHUNKS", 8))
    t0 = time.time()
    for _ in range(nchunks):
        state = run_chunk(state, packed_dev)
    jax.block_until_ready(state)
    dt = time.time() - t0
    rate = cfg.batch_size * steps * nchunks / dt
    log(f"{dev.device_kind}: {nchunks}x{steps} steps in {dt:.2f}s -> "
        f"{rate:,.0f} SNP-updates/s")

    # One chunk, one sync: the per-dispatch latency is not overlapped.
    single_dt = np.inf
    for _ in range(3):
        t0 = time.time()
        state = jax.block_until_ready(run_chunk(state, packed_dev))
        single_dt = min(single_dt, time.time() - t0)
    single_rate = cfg.batch_size * steps / single_dt
    log(f"{dev.device_kind} single-sync: {steps} steps in {single_dt:.2f}s"
        f" -> {single_rate:,.0f} SNP-updates/s")

    # ---- CPU numpy baseline (same algorithm) ---------------------------
    # The baseline always runs the reference's PLAIN 16-pass local solve
    # (the accel lever is ours, not the reference's) with the pinned
    # BLAS thread pool above, so vs_baseline compares against a stable
    # stand-in for the reference C++ loop.
    base_cfg = cfg.replace(local_accel=False, local_iters=16)
    base_steps = int(os.environ.get("BENCH_BASE_STEPS", 5))
    gamma_np = np.asarray(engine.init_state(cfg).gamma, dtype=np.float32)
    lamb_np = np.ones((l, k, 2), dtype=np.float32)
    np_step = numpy_step_factory(base_cfg, packed, n)
    gamma_np, lamb_np = np_step(gamma_np, lamb_np, 0)      # warmup
    t0 = time.time()
    for t in range(1, base_steps + 1):
        gamma_np, lamb_np = np_step(gamma_np, lamb_np, t)
    base_dt = time.time() - t0
    base_rate = cfg.batch_size * base_steps / base_dt
    log(f"CPU baseline: {base_steps} steps in {base_dt:.2f}s -> "
        f"{base_rate:,.0f} SNP-updates/s")

    print(json.dumps({
        "metric": "snp_updates_per_s_per_chip",
        "value": round(rate, 1),
        "unit": "SNP-updates/s",
        "vs_baseline": round(rate / base_rate, 2),
        "device_kind": dev.device_kind,
        # `value` is pipelined over nchunks dispatches with one final
        # sync; `value_single_sync` is one chunk, one sync.
        "value_single_sync": round(single_rate, 1),
        "nchunks": nchunks,
        "accel": cfg.local_accel,
        "local_iters": cfg.local_iters,
    }))


if __name__ == "__main__":
    main()
