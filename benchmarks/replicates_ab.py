"""Serial vs batched multi-seed replicates on the card.

The reference's recommended workflow fits R seeds and keeps the best
validation ll (SURVEY.md §1.2 step 6). Serial pays R compiles + R x
dispatch/eval tax; svi/replicates.py runs all R in lockstep under one
vmapped jit. This harness measures both at a BASELINE config shape and
checks the selections agree.

    python benchmarks/replicates_ab.py [--config 1] [--r 4]

One JSON document to stdout (+ saved under chiprun_out/).
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
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=1, choices=SHAPES)
    ap.add_argument("--r", type=int, default=4)
    ap.add_argument("--max-steps", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    spec = SHAPES[args.config]

    import jax
    import numpy as np

    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.data import GenotypeData
    from terastructure_tpu.data.simulate import simulate_psd
    from terastructure_tpu.svi import fit
    from terastructure_tpu.svi.replicates import fit_replicates_batched

    n, l, k = spec["n"], spec["l"], spec["k"]
    _, _, x = simulate_psd(n, l, k, seed=args.seed)
    # Same eval-carve policy as baseline_configs: cap entries by
    # MC-error needs and POOL the unique eval SNPs at big L, or each
    # rfreq check's local-mode lambda re-solve visits ~every SNP the
    # entries touch (an unpooled carve makes each check re-solve more
    # SNPs than the chunk itself steps on).
    n_eval = min(max(int(0.005 * n * l), 100), 200_000)
    pool = 2048 if (n >= 50_000 or l >= 131_072) else 0
    data = GenotypeData.from_dense(x, validation_frac=0.005,
                                   heldout_frac=0.005, seed=args.seed,
                                   max_eval_entries=n_eval,
                                   eval_snp_pool=pool)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=min(spec["batch"], l),
                    rfreq=100, max_steps=args.max_steps, seed=args.seed)
    seeds = [args.seed + i for i in range(args.r)]
    out = dict(backend=jax.default_backend(), n=n, l=l, k=k,
               batch=cfg.batch_size, r=args.r, seeds=seeds)

    # ---- serial ---------------------------------------------------------
    t0 = time.time()
    serial = []
    for s in seeds:
        r = fit(cfg.replace(seed=s), data)
        serial.append(dict(seed=s, converged=r.converged, steps=r.steps,
                           validation_ll=round(r.validation_ll, 6)))
        print(f"serial seed={s}: ll={r.validation_ll:.6f} "
              f"steps={r.steps}", file=sys.stderr, flush=True)
    serial_wall = time.time() - t0
    serial_best = max(range(args.r),
                      key=lambda i: serial[i]["validation_ll"])

    # ---- batched --------------------------------------------------------
    t0 = time.time()
    res = fit_replicates_batched(cfg, data, seeds)
    batched_wall = time.time() - t0
    batched = [dict(seed=rr.seed, converged=rr.converged, steps=rr.steps,
                    validation_ll=round(rr.validation_ll, 6))
               for rr in res.replicates]
    for b in batched:
        print(f"batched seed={b['seed']}: ll={b['validation_ll']:.6f} "
              f"steps={b['steps']}", file=sys.stderr, flush=True)

    out.update(
        serial=dict(wall_s=round(serial_wall, 1), fits=serial,
                    best_seed=seeds[serial_best]),
        batched=dict(wall_s=round(batched_wall, 1), fits=batched,
                     best_seed=seeds[res.best]),
        speedup=round(serial_wall / batched_wall, 2),
        same_best=bool(seeds[res.best] == seeds[serial_best]),
        ll_max_abs_delta=round(max(
            abs(a["validation_ll"] - b["validation_ll"])
            for a, b in zip(serial, batched)), 6),
    )
    doc = json.dumps(out, indent=1)
    print(doc)
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = args.out or os.path.join(out_dir,
                                    f"replicates_ab_c{args.config}.json")
    with open(path, "w") as f:
        f.write(doc)


if __name__ == "__main__":
    main()
