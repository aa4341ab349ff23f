"""Per-pass sweep of the lambda-pass kernel's launch shapes on a GPU.

Times one coordinate-ascent pass (ops/lambda_pass.lambda_pass) for each
candidate `Tiles` (rows per program, byte columns per chunk, warps,
pipeline stages, programs per SM) beside the dense XLA pass
(ops/stats_dense.lambda_stats on decoded counts) and the dense final
statistics pass (batch_stats), at the widths the fit runs:

  4096 x 2,504 K=8     the TGP batch (config 3)
  4096 x 8,192 K=10    the big-N column subsample of the config-5 share
  4096 x 100,000 K=10  the config-5 per-card share at full width
  1024 x 100,000 K=10  the per-card batch of that share on a 1x4 mesh

The shipped default, ops/lambda_pass.Tiles(), was chosen from this
sweep (PERF.md). Random packed rows with 2% missing entries and u, t
factors at fit-like magnitudes.

    python benchmarks/lambda_pass_sweep.py            # full sweep
    python benchmarks/lambda_pass_sweep.py --quick    # shipped tiles only

One JSON line per shape to stdout (times in microseconds, best first),
also written to chiprun_out/lambda_pass_sweep.jsonl.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((4096, 2504, 8), (4096, 8192, 10), (4096, 100_000, 10),
          (1024, 100_000, 10))
# (rows, cols, warps, stages); each is tried at every PER_SM.
LAUNCH = ((64, 64, 4, 2), (64, 64, 8, 2), (64, 64, 4, 1), (64, 64, 4, 3),
          (128, 64, 4, 2), (128, 64, 8, 2), (128, 32, 4, 2), (64, 32, 4, 2),
          (256, 32, 8, 2), (128, 32, 8, 3))
PER_SM = (1, 2, 4)


def _inputs(b, n, k, seed=0):
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


def _time_us(f, *args, reps=20, warm_s=0.2):
    """Mean microseconds per call over `reps` calls, after `warm_s`
    seconds of untimed calls that bring the card's clocks up."""
    import jax

    jax.block_until_ready(f(*args))
    t_end = time.perf_counter() + warm_s
    while time.perf_counter() < t_end:
        jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(*args)
    jax.block_until_ready(out)
    return 1e6 * (time.perf_counter() - t0) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="time only the shipped Tiles() against dense")
    args = ap.parse_args(argv)

    import jax

    from terastructure_tpu.ops import lambda_pass as lp
    from terastructure_tpu.ops import local_step
    from terastructure_tpu.ops import stats_dense as ops
    from terastructure_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"lambda_pass_sweep.py needs a GPU; JAX found "
                 f"{dev.platform!r}")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    shipped = lp.Tiles()
    cands = [shipped] if args.quick else [
        lp.Tiles(*launch, per_sm=m)
        for launch, m in itertools.product(LAUNCH, PER_SM)]

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    dense = jax.jit(ops.lambda_stats)
    final = jax.jit(ops.batch_stats)
    with open(os.path.join(out_dir, "lambda_pass_sweep.jsonl"), "w") as log:
        for b, n, k in SHAPES:
            rows, u, t1, t0 = _inputs(b, n, k)
            a1, a0 = local_step.counts(rows)
            planes = lp.u_to_planes(u)
            res = []
            for tiles in cands:
                f = jax.jit(lambda r, p, x, y, t=tiles: lp.lambda_pass(
                    r, p, x, y, tiles=t))
                res.append((_time_us(f, rows, planes, t1, t0),
                            tiles._asdict(),
                            lp.grid_shape(b, n // 4, tiles, lp.sm_count())))
            res.sort(key=lambda r: r[0])
            line = {
                "card": card, "device_kind": dev.device_kind,
                "sms": lp.sm_count(), "shape": [b, n, k],
                "dense_pass_us": _time_us(dense, a1, a0, u, t1, t0),
                "final_stats_us": _time_us(final, a1, a0, u, t1, t0),
                "shipped_us": next(r[0] for r in res
                                   if r[1] == shipped._asdict()),
                "best": [{"us": us, "tiles": t, "grid": g}
                         for us, t, g in res[:8]],
            }
            print(json.dumps(line), flush=True)
            log.write(json.dumps(line) + "\n")
            del rows, a1, a0


if __name__ == "__main__":
    main()
