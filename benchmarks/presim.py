"""Pre-build the simulation caches used by baseline_configs.py in a
CPU-only process (JAX_PLATFORMS=cpu).

The big-N host simulations are CPU-bound (tens of minutes at
100K x 100K) while the fits take seconds to minutes on the card;
building the caches ahead, in a process that never opens the card,
keeps the card's one JAX process free for the fits.

    python benchmarks/presim.py --targets config3,config5@0.1
"""

import argparse
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import benchmarks.baseline_configs as bc  # noqa: E402


def build_config(config: int, scale: float, seed: int = 0,
                 missing: float = 0.0):
    spec = bc.CONFIGS[config]
    n = max(int(spec["n"] * scale), 16)
    l = max(int(spec["l"] * scale), 64)
    k = spec["k"]
    cache = bc.cache_path(spec, seed, n, l, k, missing)
    if os.path.exists(cache):
        print(f"exists: {cache}", flush=True)
        return
    ns = argparse.Namespace(seed=seed, missing_frac=missing)
    t0 = time.time()
    packed, theta, sim_s = bc._simulate(ns, n, l, k)
    os.makedirs(bc.SIM_CACHE, exist_ok=True)
    np.savez(cache, packed=packed, theta=theta)
    print(f"built {cache} in {time.time()-t0:.0f}s", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--targets", default="config3,config5@0.1",
                    help="comma list: configN[@scale]")
    args = ap.parse_args()
    for t in args.targets.split(","):
        t = t.strip()
        if t.startswith("config"):
            cfg, _, sc = t.partition("@")
            build_config(int(cfg[len("config"):]), float(sc or 1.0))
        else:
            raise SystemExit(f"unknown target {t}")


if __name__ == "__main__":
    main()
