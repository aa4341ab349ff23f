"""Quality A/B for the bf16 gamma-statistic reduction.

The gamma psum('snp') is the one collective whose payload is
N-proportional and batch-independent — the communication term that
grows with the cohort, not the batch. Halving its wire payload with cfg.gamma_psum_dtype='bf16' lifts that bound, IF the
~2^-8-relative rounding of the statistic is quality-neutral under the
Robbins-Monro average (which already integrates 1/sqrt(B) minibatch
noise every step).

This harness measures that on the card: two full fits at a
BASELINE config shape, same seed/data/schedule, f32 vs bf16 reduction
(the engine path rounds the whole statistic at the reduction boundary
— the single-device mirror of the sharded psum's rounding;
multi-shard bf16 ACCUMULATION is covered by the 8-dev CPU-mesh test
tests/test_sharded.py::test_gamma_psum_bf16_trajectory_quality).

    python benchmarks/gamma_bf16_ab.py [--config 3] [--max-steps N]

One JSON doc to stdout, saved to chiprun_out/gamma_bf16_ab.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = {
    1: dict(n=1000, l=10_000, k=3, batch=256),
    2: dict(n=940, l=640_000, k=7, batch=1024),
    3: dict(n=2504, l=1_000_000, k=8, batch=1024),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=3, choices=SHAPES)
    ap.add_argument("--max-steps", type=int, default=8000)
    ap.add_argument("--fixed-steps", type=int, default=0,
                    help="run BOTH arms exactly N steps (convergence "
                         "stop disabled) — removes the step-count "
                         "confound when early stopping fires at "
                         "different checks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    spec = SHAPES[args.config]

    import jax
    import numpy as np

    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.data import GenotypeData
    from terastructure_tpu.data.simulate import simulate_psd
    from terastructure_tpu.models.psd import theta_mean
    from terastructure_tpu.svi import fit
    from terastructure_tpu.utils.labels import mean_abs_theta_error

    n, l, k = spec["n"], spec["l"], spec["k"]
    theta_true, _, x = simulate_psd(n, l, k, seed=args.seed)
    # Pooled/capped eval carve (same policy as baseline_configs): at
    # big L an unpooled carve makes every rfreq check re-solve ~every
    # SNP the eval entries touch.
    n_eval = min(max(int(0.005 * n * l), 100), 200_000)
    pool = 2048 if (n >= 50_000 or l >= 131_072) else 0
    data = GenotypeData.from_dense(x, validation_frac=0.005,
                                   heldout_frac=0.005, seed=args.seed,
                                   max_eval_entries=n_eval,
                                   eval_snp_pool=pool)
    cfg0 = SVIConfig(n=n, l=l, k=k, batch_size=min(spec["batch"], l),
                     rfreq=100, max_steps=args.max_steps, seed=args.seed)
    if args.fixed_steps:
        cfg0 = cfg0.replace(max_steps=args.fixed_steps, conv_tol=-1.0)
    out = dict(backend=jax.default_backend(), n=n, l=l, k=k,
               batch=cfg0.batch_size, seed=args.seed,
               max_steps=args.max_steps)

    for dt in ("f32", "bf16"):
        cfg = cfg0.replace(gamma_psum_dtype=dt)
        t0 = time.time()
        r = fit(cfg, data)
        wall = time.time() - t0
        th = np.asarray(theta_mean(r.state.gamma[:n]))
        out[dt] = dict(
            converged=r.converged, steps=r.steps,
            wall_s=round(wall, 1),
            validation_ll=round(r.validation_ll, 6),
            heldout_ll=round(r.heldout_ll, 6) if r.heldout_ll else None,
            theta_mae=round(mean_abs_theta_error(th, theta_true), 6),
            upd_per_s=round(cfg.batch_size * r.steps / wall, 1),
        )
        print(f"{dt}: steps={r.steps} ll={r.validation_ll:.6f} "
              f"theta_mae={out[dt]['theta_mae']:.5f} wall={wall:.0f}s",
              file=sys.stderr, flush=True)

    out["deltas"] = dict(
        heldout_nats=round((out["bf16"]["heldout_ll"] or 0)
                           - (out["f32"]["heldout_ll"] or 0), 6),
        theta_mae=round(out["bf16"]["theta_mae"]
                        - out["f32"]["theta_mae"], 6),
    )
    doc = json.dumps(out, indent=1)
    print(doc)
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = args.out or os.path.join(out_dir, "gamma_bf16_ab.json")
    with open(path, "w") as f:
        f.write(doc)


if __name__ == "__main__":
    main()
