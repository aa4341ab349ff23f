"""Measured per-step collective volume of the sharded step.

Compiles the real sharded step (parallel/sharded.py) on an emulated
multi-device CPU mesh and reads the collective operations and their
byte volumes straight out of the optimized HLO — not from the source's
intent, from what XLA actually scheduled — and checks them against the
analytic model. Per step on an (I, S) mesh the step's only
communication is
  - lambda-stats psum over 'ind': 2 x (B/S) x K f32 per local
    iteration (+1 final pair)        -> only when I > 1
  - gamma-stat  psum over 'snp': (N/I) x K f32 once

overlap_report() checks that the pipelined chunk runner's next-step
gather does not depend on the gamma all-reduce. tests/test_sharded.py
pins both.

    python benchmarks/comm_model.py            # emulated 8-dev measure
"""

from __future__ import annotations

import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def measured_collective_bytes(n=256, l=1024, k=4, batch=128, ind=2, snp=4,
                              gamma_psum_dtype="f32"):
    """Compile the sharded step on an emulated ind x snp CPU mesh and
    sum the bytes of every cross-replica collective in the final HLO.

    gamma_psum_dtype='bf16' compiles the half-payload gamma reduction
    (config.gamma_psum_dtype); the returned per-kind summary then
    carries a 'dtypes' set so callers can assert the wire dtype that
    XLA actually scheduled, not just the byte count."""
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={ind * snp}")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp  # noqa: F401

    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.data.dataset import GenotypeData
    from terastructure_tpu.data.simulate import simulate_psd
    from terastructure_tpu.parallel import mesh as meshlib
    from terastructure_tpu.parallel import sharded

    cfg = SVIConfig(n=n, l=l, k=k, batch_size=batch, seed=0,
                    ind_shards=ind, snp_shards=snp,
                    gamma_psum_dtype=gamma_psum_dtype)
    _, _, x = simulate_psd(n, l, k, seed=0)
    data = GenotypeData.from_dense(x, validation_frac=0.01,
                                   heldout_frac=0.0, seed=0)
    mesh = meshlib.make_mesh(meshlib.choose_mesh_shape(ind * snp, ind, snp))
    plan, packed = sharded.prepare(cfg, data, mesh)
    state = sharded.init_sharded_state(cfg, plan, mesh)
    step = sharded.make_sharded_step(cfg, plan, mesh)
    lowered = jax.jit(step).lower(state, packed)
    hlo = lowered.compile().as_text()

    # Every cross-replica op line; the result type may be a single
    # array `f32[32,4]{..} all-reduce(..)` or a tuple
    # `(f32[32,4]{..}, f32[32,4]{..}) all-reduce(..)` — sum every
    # f32[...] group in the line's result type (text left of the op).
    ops = {}
    for line in hlo.splitlines():
        m = re.search(
            r"=\s*(.*?)\b"
            r"(all-reduce|reduce-scatter|all-gather|collective-permute)"
            r"(?:-start|-done)?\(", line)
        if not m:
            continue
        result_type, kind = m.groups()
        if kind == "all-reduce" and "-done(" in line:
            continue                     # avoid double-counting start/done
        total = 0
        dts = set()
        for dt, shape in re.findall(r"(f32|bf16)\[([\d,]*)\]",
                                    result_type):
            dims = [int(d) for d in shape.split(",") if d] or [1]
            total += int(np.prod(dims)) * (4 if dt == "f32" else 2)
            dts.add(dt)
        if total:
            ops.setdefault(kind, []).append((total, dts))
    summary = {kind: dict(count=len(v), bytes=sum(t for t, _ in v),
                          dtypes=sorted(set().union(*(d for _, d in v))))
               for kind, v in ops.items()}
    # Did the (N/I, K) gamma statistic cross a bf16 rounding boundary?
    # The rounding is a reduce-precision(e=8, m=7) — contractual, no
    # backend may elide it (XLA's excess-precision simplifier DOES
    # elide bare f32->bf16->f32 convert pairs, and the CPU backend
    # promotes bf16 collectives back to f32 via BFloat16Normalization,
    # so neither the converts nor the wire dtype are reliable evidence
    # here). Match the op on the statistic's local shape.
    summary["gamma_bf16_round"] = bool(re.search(
        rf"f32\[{n // ind},{k}\][^=]*\breduce-precision\(", hlo))
    # analytic check (per compiled program = ONE step):
    iters = cfg.local_iters + 1            # solve passes + final stats
    lam_bytes = 2 * (batch // snp) * k * 4 * (iters if ind > 1 else 0)
    gam_bytes = (n // ind) * k * (2 if gamma_psum_dtype == "bf16" else 4)
    summary["model"] = dict(
        lambda_psum_bytes_max=lam_bytes, gamma_psum_bytes=gam_bytes,
        note="one lambda-pair all-reduce sits in the while body (static"
             " HLO shows it ONCE; runtime volume is bytes x iterations)"
             " and, under the accel default, the two UNROLLED Aitken"
             " tail passes each carry their own — so the static count"
             " is 1 gamma + 3 lambda ARs for the same dataflow")
    return summary


def _parse_hlo_computations(hlo: str):
    """HLO text -> {computation_name: [(instr, opcode, [operands])]}.

    Operands are the %tokens inside the opcode's first balanced paren
    group (attribute references like calls=%fused... come after it and
    are excluded on purpose — we want DATAFLOW edges only)."""
    comps = {}
    cur = None
    instr_re = re.compile(
        r"^\s*(?:ROOT\s+)?(%?[\w\.\-]+)\s*=\s*(.*?)\s([\w\-]+)\((.*)")
    for line in hlo.splitlines():
        # computation headers start at column 0 and end with "{";
        # instruction lines are indented (the header's param list may
        # contain '=' inside /*index=N*/ comments, so don't key on '=')
        if (line and not line[0].isspace()
                and line.rstrip().endswith("{")):
            name = line.strip().split(" ")[0]
            if name == "ENTRY":
                name = line.strip().split(" ")[1]
            cur = comps.setdefault(name.lstrip("%") or "entry", [])
            continue
        if line.strip() == "}":
            cur = None
            continue
        if cur is None:
            continue
        m = instr_re.match(line)
        if not m:
            continue
        instr, rtype, opcode, rest = m.groups()
        # operand section: up to the matching close paren
        depth, end = 1, len(rest)
        for i, ch in enumerate(rest):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    end = i
                    break
        operands = re.findall(r"%([\w\.\-]+)", rest[:end])
        cur.append((instr.lstrip("%"), rtype.strip(), opcode, operands))
    return comps


def overlap_report(n=256, l=1024, k=4, batch=128, ind=2, snp=4, nsteps=3):
    """Verify, at the HLO level, that the pipelined chunk runner's
    next-step minibatch gather is dataflow-INDEPENDENT of the gamma
    all-reduce — the structural property that lets the latency-hiding
    scheduler start the collective before the gather and finish it
    after (an async all-reduce spanning real work).

    Returns {gamma_ar: instr, rows_producers: [...],
    rows_depend_on_allreduce: bool} for the while-body computation of
    the compiled chunk."""
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={ind * snp}")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.data.dataset import GenotypeData
    from terastructure_tpu.data.simulate import simulate_psd
    from terastructure_tpu.parallel import mesh as meshlib
    from terastructure_tpu.parallel import sharded
    from terastructure_tpu.data.pack import packed_width

    cfg = SVIConfig(n=n, l=l, k=k, batch_size=batch, seed=0,
                    ind_shards=ind, snp_shards=snp)
    _, _, x = simulate_psd(n, l, k, seed=0)
    data = GenotypeData.from_dense(x, validation_frac=0.01,
                                   heldout_frac=0.0, seed=0)
    mesh = meshlib.make_mesh(meshlib.choose_mesh_shape(ind * snp, ind, snp))
    plan, packed = sharded.prepare(cfg, data, mesh)
    state = sharded.init_sharded_state(cfg, plan, mesh)
    chunk = sharded.make_sharded_run_chunk(cfg, plan, mesh, nsteps)
    hlo = chunk.lower(state, packed).compile().as_text()
    comps = _parse_hlo_computations(hlo)

    gamma_shape = f"f32[{plan.n_padded // ind},{k}]"
    rows_shape = (f"u8[{batch // snp},"
                  f"{packed_width(plan.n_padded) // ind}]")
    report = {"gamma_ar": None, "rows_producers": [],
              "rows_depend_on_allreduce": None, "body": None}
    for cname, instrs in comps.items():
        ars = [i for i in instrs
               if i[2].startswith("all-reduce")
               and i[1].replace("{1,0}", "").strip() == gamma_shape]
        rows = [i for i in instrs
                if i[1].replace("{1,0}", "").strip() == rows_shape
                and i[2] not in ("parameter", "get-tuple-element",
                                 "copy", "tuple")]
        if not ars or not rows:
            continue
        # BFS forward from the all-reduce through dataflow edges
        users = {}
        for name, _, _, operands in instrs:
            for op in operands:
                users.setdefault(op, []).append(name)
        reach = set()
        frontier = [a[0] for a in ars]
        while frontier:
            cur = frontier.pop()
            for u in users.get(cur, []):
                if u not in reach:
                    reach.add(u)
                    frontier.append(u)
        depend = any(r[0] in reach for r in rows)
        report.update(
            gamma_ar=ars[0][0], rows_producers=[r[0] for r in rows],
            rows_depend_on_allreduce=depend, body=cname)
        break
    return report


def main():
    out = dict(measured_hlo_collectives=measured_collective_bytes(),
               overlap_hlo=overlap_report())
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
