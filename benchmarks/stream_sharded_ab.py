"""A/B: single-device streamer vs mesh-sharded streamer at mesh 1x1.

Composing streaming with the sharded step must not regress per-step
cost on one card. Measures steady-state s/step of (a)
svi.stream.make_stream_chunk (the single-device path) and (b)
parallel.stream's make_sharded_stream_chunk on a 1x1 mesh. Writes
chiprun_out/stream_sharded_ab.json.

Usage: python benchmarks/stream_sharded_ab.py [--n 100352] [--l 16384]
       [--b 512] [--k 10] [--steps 30]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100352)
    ap.add_argument("--l", type=int, default=16384)
    ap.add_argument("--b", type=int, default=512)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()

    import jax

    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.data.pack import packed_width
    from terastructure_tpu.parallel import mesh as meshlib
    from terastructure_tpu.parallel import sharded
    from terastructure_tpu.parallel.stream import make_sharded_stream_chunk
    from terastructure_tpu.svi import engine, stream

    cfg = SVIConfig(n=args.n, l=args.l, k=args.k, batch_size=args.b,
                    seed=0, lambda_mode="local")
    w = packed_width(args.n)
    rng = np.random.default_rng(0)
    packed_host = rng.integers(0, 256, size=(args.l, w), dtype=np.uint8)
    print(f"host matrix {packed_host.nbytes/2**20:.0f} MiB, "
          f"batch {args.b * (w + (-w) % 128) / 2**20:.1f} MiB",
          file=sys.stderr, flush=True)

    out = {"n": args.n, "l": args.l, "b": args.b, "k": args.k,
           "steps": args.steps, "backend": jax.default_backend()}

    def timed(tag, chunk, state):
        t0 = time.time()
        state = chunk(state, packed_host)
        float(np.asarray(jax.device_get(state.gamma))[0, 0])
        out[tag + "_warm_s"] = round(time.time() - t0, 2)
        t0 = time.time()
        state = chunk(state, packed_host)
        float(np.asarray(jax.device_get(state.gamma))[0, 0])
        dt = (time.time() - t0) / args.steps
        out[tag + "_s_per_step"] = round(dt, 4)
        out[tag + "_updps"] = round(args.b / dt, 0)
        print(tag, out[tag + "_s_per_step"], "s/step",
              file=sys.stderr, flush=True)

    # (a) single-device streamer (round-2 path)
    timed("single", stream.make_stream_chunk(cfg, args.steps, args.l),
          engine.init_state(cfg))

    # (b) mesh 1x1 sharded streamer
    mesh = meshlib.make_mesh(meshlib.MeshSpec(ind=1, snp=1),
                             devices=jax.devices()[:1])
    plan = sharded.make_plan(cfg, mesh)
    timed("sharded1x1",
          make_sharded_stream_chunk(cfg, plan, mesh, args.steps),
          sharded.init_sharded_state(cfg, plan, mesh))

    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "stream_sharded_ab.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
