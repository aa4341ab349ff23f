"""Scaling-efficiency harness: SNP-updates/s vs mesh size.

BASELINE.json:2/:10 target: >=80% SNP-updates/s scaling efficiency from
1 chip to N>=2 hosts on the 1M x 1M synthetic. On real multi-chip
hardware run:

    python benchmarks/scaling.py --n 1000000 --l 1000000 --k 10 \
        --batch-size 4096 --meshes 1x1,1x4,2x4

On a single-host dev box, --emulate 8 forces 8 virtual CPU devices to
exercise the sharded path end-to-end (functional, not a perf number).

Per mesh it reports steps/s, SNP-updates/s, per-device efficiency vs the
smallest mesh, and writes JSONL to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--l", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--meshes", default="",
                    help="comma list of IxS meshes, e.g. 1x1,1x4,2x4")
    ap.add_argument("--emulate", type=int, default=0,
                    help="force N virtual CPU devices")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    if args.emulate:
        os.environ.pop("JAX_PLATFORMS", None)
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.emulate}"
        ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import numpy as np

    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.data.dataset import GenotypeData
    from terastructure_tpu.data.pack import packed_width
    from terastructure_tpu.parallel import mesh as meshlib
    from terastructure_tpu.parallel import sharded

    ndev = len(jax.devices())
    meshes = []
    if args.meshes:
        for tok in args.meshes.split(","):
            i, s = tok.lower().split("x")
            meshes.append(meshlib.MeshSpec(int(i), int(s)))
    else:
        s = 1
        while s <= ndev:
            meshes.append(meshlib.MeshSpec(1, s))
            s *= 2

    # Synthetic uniform random genotypes (throughput only — content-
    # independent): generated once at the largest padded shape.
    rng = np.random.default_rng(0)
    w = packed_width(args.n)
    packed = rng.integers(0, 255, size=(args.l, w), dtype=np.uint8)
    data = GenotypeData(n=args.n, l=args.l, packed=packed)

    out_f = open(args.out, "a") if args.out else None
    base_rate = None
    for spec in meshes:
        if spec.n_devices > ndev:
            print(f"skip {spec}: only {ndev} devices", file=sys.stderr)
            continue
        cfg = SVIConfig(n=args.n, l=args.l, k=args.k,
                        batch_size=args.batch_size, seed=0)
        mesh = meshlib.make_mesh(spec)
        plan, packed_dev = sharded.prepare(cfg, data, mesh)
        state = sharded.init_sharded_state(cfg, plan, mesh)
        run = sharded.make_sharded_run_chunk(cfg, plan, mesh, args.steps)
        t0 = time.time()
        state = run(state, packed_dev)
        float(state.gamma[0, 0])
        compile_s = time.time() - t0
        state = run(state, packed_dev)
        float(state.gamma[0, 0])
        t0 = time.time()
        state = run(state, packed_dev)
        float(state.gamma[0, 0])
        dt = time.time() - t0
        rate = args.batch_size * args.steps / dt
        per_dev = rate / spec.n_devices
        if base_rate is None:
            base_rate = per_dev
        rec = dict(
            mesh=f"{spec.ind}x{spec.snp}", devices=spec.n_devices,
            n=args.n, l=args.l, k=args.k, batch_size=args.batch_size,
            steps_per_s=args.steps / dt, snp_updates_per_s=rate,
            per_device=per_dev, efficiency=per_dev / base_rate,
            compile_s=round(compile_s, 1),
            backend=jax.default_backend(),
            emulated=bool(args.emulate),
        )
        if args.emulate or jax.default_backend() == "cpu":
            # every emulated record carries its own caveat — the number
            # measures HOST CORE CONTENTION (all virtual devices share
            # one CPU's cores), not device scaling; the HLO-level
            # evidence is benchmarks/comm_model.py
            rec["measures"] = "host core contention, NOT device scaling"
        print(json.dumps(rec))
        if out_f:
            out_f.write(json.dumps(rec) + "\n")
            out_f.flush()
    if out_f:
        out_f.close()


if __name__ == "__main__":
    main()
