"""Sharded SVI step over a 2-D (ind x snp) device mesh via shard_map.

Dataflow (SURVEY.md §7.4, the "inverted global/local split under sharding"):

  per device (a, s) with gamma shard a and SNP/lambda shard s:
    - sample B_local SNPs from the local padded SNP range
      (key folds in the snp axis index ONLY, so the whole 'ind' column
      agrees on the sample);
    - gather + unpack the local (B_local, N_local) genotype block;
    - local phi<->lambda coordinate ascent where each lambda statistic is
      psum'ed over 'ind' (the sum over individuals spans hosts);
    - gamma natural-gradient statistic psum'ed over 'snp' (each shard's
      minibatch covers only its SNPs);
    - scatter converged lambda into the local lambda shard; update the
      local gamma shard. No other communication.

Sampling from the padded range keeps the estimator unbiased: padding SNPs
are all-MISSING so they contribute zero, and the L/B scale uses padded L
(expectation over uniform-on-padded-range = sum over real SNPs).

Requirements: N divisible by 4 * mesh.ind (byte-aligned individual
shards), padded L divisible by mesh.snp — see `prepare()`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data.dataset import GenotypeData
from terastructure_tpu.data.pack import packed_width
from terastructure_tpu.ops import local_step
from terastructure_tpu.ops import stats_dense as ops
from terastructure_tpu.ops.lambda_pass import resolve_kernel
from terastructure_tpu.parallel import mesh as meshlib
from terastructure_tpu.parallel.mesh import IND_AXIS, SNP_AXIS
from terastructure_tpu.svi.engine import SVIState


class ShardPlan(NamedTuple):
    """Static padded shapes for an even 2-D sharding."""
    n: int            # real individuals
    l: int            # real SNPs
    n_padded: int     # multiple of 4 * ind_shards
    l_padded: int     # multiple of snp_shards
    ind: int
    snp: int
    batch_per_shard: int


def make_plan(cfg: SVIConfig, mesh: Mesh) -> ShardPlan:
    ind = mesh.shape[IND_AXIS]
    snp = mesh.shape[SNP_AXIS]
    if cfg.batch_size % snp:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by snp axis {snp}")
    # Byte-aligned individual shards; padding individuals decode as
    # MISSING and never contribute statistics.
    quantum = 4 * ind
    n_padded = ((cfg.n + quantum - 1) // quantum) * quantum
    l_padded = ((cfg.l + snp - 1) // snp) * snp
    return ShardPlan(
        n=cfg.n, l=cfg.l, n_padded=n_padded, l_padded=l_padded,
        ind=ind, snp=snp, batch_per_shard=cfg.batch_size // snp,
    )


def prepare(cfg: SVIConfig, data: GenotypeData, mesh: Mesh):
    """Pad + shard the packed genotypes onto the 2-D mesh.

    Returns (plan, packed_sharded). Padding individuals/SNPs decode as
    MISSING (0xFF bytes) so they never contribute statistics.

    `data.packed` may be either the full (l, ceil(n/4)) matrix (single
    host) or this process's byte-column slice at `data.byte_col_offset`
    (multi-host ingest, parallel/multihost.load_bed_shard). Either way
    the global array is assembled per addressable device — no host needs
    the whole matrix, so 1M x 1M (250 GB packed) runs with O(1/hosts)
    RSS per host.
    """
    plan = make_plan(cfg, mesh)
    packed = data.packed
    col0 = data.byte_col_offset
    w_padded = packed_width(plan.n_padded)
    lp = plan.l_padded
    sh = NamedSharding(mesh, meshlib.PACKED_SPEC)
    multiproc = jax.process_count() > 1
    if not multiproc and col0 == 0 and packed.shape[1] == packed_width(data.n):
        if packed.shape != (lp, w_padded):
            out = np.full((lp, w_padded), 0xFF, dtype=np.uint8)
            out[: packed.shape[0], : packed.shape[1]] = packed
            packed = out
        return plan, jax.device_put(packed, sh)

    # Assemble from (possibly partial) host buffers: for each addressable
    # device, cut its (rows, cols) block out of the local buffer, filling
    # out-of-range positions (padding, or columns another host owns) with
    # 0xFF. Columns owned by other hosts are never touched here — every
    # process contributes exactly its addressable shards.
    gshape = (lp, w_padded)
    lrows, lcols = packed.shape
    arrs = []
    devs = []
    for dev, (rs, cs) in sh.addressable_devices_indices_map(gshape).items():
        r0 = rs.start or 0
        r1 = rs.stop if rs.stop is not None else lp
        c0 = cs.start or 0
        c1 = cs.stop if cs.stop is not None else w_padded
        buf = np.full((r1 - r0, c1 - c0), 0xFF, dtype=np.uint8)
        rr1 = min(r1, lrows)
        cc0, cc1 = max(c0, col0), min(c1, col0 + lcols)
        if rr1 > r0 and cc1 > cc0:
            buf[: rr1 - r0, cc0 - c0: cc1 - c0] = (
                packed[r0:rr1, cc0 - col0: cc1 - col0])
        elif c1 > col0 + lcols and c0 < w_padded and c0 < packed_width(data.n):
            raise ValueError(
                f"process-local packed slice [{col0}, {col0 + lcols}) does "
                f"not cover addressable byte columns [{c0}, {c1}); load "
                "the range given by multihost.local_byte_cols()")
        arrs.append(jax.device_put(buf, dev))
        devs.append(dev)
    global_arr = jax.make_array_from_single_device_arrays(gshape, sh, arrs)
    return plan, global_arr


def init_sharded_state(cfg: SVIConfig, plan: ShardPlan, mesh: Mesh) -> SVIState:
    """Like engine.init_state but with padded shapes and mesh shardings.

    Init is computed UNDER jit with sharded out_shardings so it works
    identically in multi-process runs (no host materializes the global
    arrays; threefry values are sharding-independent, so this matches
    the single-process init bit-for-bit). The step counter and key come
    back replicated over the mesh, as the chunk runner returns them, so
    the runner's second call reuses the first call's program.
    """
    key = jax.random.PRNGKey(cfg.seed)
    k_init, k_run = jax.random.split(key)
    gsh = NamedSharding(mesh, meshlib.GAMMA_SPEC)
    lsh = NamedSharding(mesh, meshlib.LAMB_SPEC)
    rep = NamedSharding(mesh, meshlib.REPLICATED)

    @functools.partial(jax.jit, out_shardings=(gsh, lsh, rep, rep))
    def _init(k, k_run):
        gamma = (
            cfg.alpha_value
            + cfg.gamma_init_scale
            * jax.random.uniform(k, (plan.n_padded, cfg.k),
                                 dtype=jnp.float32)
        )
        lamb = jnp.stack(
            [
                jnp.full((plan.l_padded, cfg.k), cfg.beta_a, jnp.float32),
                jnp.full((plan.l_padded, cfg.k), cfg.beta_b, jnp.float32),
            ],
            axis=-1,
        )
        return gamma, lamb, jnp.int32(0), k_run

    gamma, lamb, t, key = _init(k_init, k_run)
    return SVIState(gamma=gamma, lamb=lamb, t=t, key=key)


def _replicated(x, mesh: Mesh):
    """Host value -> array replicated over the mesh (multi-process safe)."""
    x = np.asarray(x)
    return jax.make_array_from_callback(
        x.shape, NamedSharding(mesh, meshlib.REPLICATED), lambda idx: x[idx])


def _build_step_parts(cfg: SVIConfig, plan: ShardPlan, mesh: Mesh, *,
                      interpret: bool = False):
    """Build the per-shard closures every sharded runner composes:
    (sample_gather, stats_from_rows, apply_gamma, psum_gamma).

    The local solve is ops/local_step's, on the kernel that
    ops/lambda_pass.resolve_kernel picks; every lambda statistic is
    psum'ed over 'ind' inside each pass (the sum over individuals spans
    the 'ind' shards), so the coordinate ascent stays in lockstep across
    'ind'. The big-N iteration subsample applies per 'ind' shard, each
    shard drawing its share of the byte columns; the W/sub_cols scale is
    shard-independent. lambda_mode='local' skips the stored lambda
    gather/scatter entirely (cold start from the prior).

    The gamma psum over 'snp' is deliberately NOT fused into
    stats_from_rows: callers place psum_gamma between stats_from_rows
    and apply_gamma, which is what lets make_sharded_run_chunk overlap
    the collective with the next step's gather. psum_gamma reduces in
    cfg.gamma_psum_dtype — "bf16" rounds each shard's partial and rides
    the wire at half the f32 payload, then casts back to f32 for the
    Robbins-Monro update.
    """
    kernel = resolve_kernel(cfg.kernel, cfg.compute_dtype, cfg.k,
                            interpret=interpret)
    b_local = plan.batch_per_shard
    l_local = plan.l_padded // plan.snp
    wl = packed_width(plan.n_padded) // plan.ind
    sub_cols = local_step.sub_columns(cfg, wl, plan.ind)
    psum_ind = functools.partial(jax.lax.psum, axis_name=IND_AXIS)
    local_mode = cfg.lambda_mode == "local"

    def _stats_from_rows(gamma_l, lamb_l, rows, idx, t, kb):
        """Everything after the minibatch gather: the local solve and
        the lambda scatter (stored mode only — idx may be None in local
        mode). Returns (lamb_l, gamma_stat_local) with the gamma
        statistic NOT yet psum'ed over 'snp' — the caller inserts the
        collective so the chunk runner can overlap it with the next
        step's minibatch gather. Shared by the resident step (which
        samples+gathers on device) and the streaming step (rows
        pre-gathered by the host)."""
        u = ops.exp_elog_theta(gamma_l)                 # (4*wl, K)
        sub_key = None
        if sub_cols:
            i_idx = jax.lax.axis_index(IND_AXIS)
            sub_key = jax.random.fold_in(jax.random.fold_in(kb, i_idx),
                                         0x5B)
        lamb_b0 = (local_step.prior_lambda(cfg, b_local) if local_mode
                   else lamb_l[idx])
        new_lamb_b, gamma_stat = local_step.step_stats(
            cfg, kernel, rows, u, lamb_b0, sub_key=sub_key,
            sub_cols=sub_cols, ind_reduce=psum_ind, interpret=interpret)
        if not local_mode:
            lamb_l = lamb_l.at[idx].set(new_lamb_b)
        return lamb_l, gamma_stat

    def _apply_gamma(gamma_l, gamma_stat, t):
        """Robbins–Monro natural-gradient gamma update from the
        ALREADY-psum'ed (over 'snp') gamma statistic."""
        rho = jnp.asarray(cfg.rho(t.astype(jnp.float32)), jnp.float32)
        scale = jnp.float32(plan.l_padded) / jnp.float32(cfg.batch_size)
        return (1.0 - rho) * gamma_l + rho * (
            cfg.alpha_value + scale * gamma_stat)

    def _sample_gather(packed_l, t, key):
        """Sample this shard's minibatch rows for step t. Depends only
        on (t, key) — NOT on gamma/lambda — which is what lets the
        chunk runner issue step t+1's gather inside step t's gamma
        all-reduce latency window."""
        s_idx = jax.lax.axis_index(SNP_AXIS)
        kb = jax.random.fold_in(jax.random.fold_in(key, t), s_idx)
        idx = jax.random.randint(kb, (b_local,), 0, l_local,
                                 dtype=jnp.int32)
        return packed_l[idx], idx, kb

    def _psum_gamma(gstat):
        """Reduce the per-shard gamma statistic over 'snp' in
        cfg.gamma_psum_dtype.

        reduce_precision BEFORE the cast: a backend is free to promote
        the collective back to f32 and elide the convert pair (the
        emulated CPU mesh does — BFloat16Normalization; XLA's
        excess-precision simplifier can do the same to bare converts),
        but reduce_precision is contractually exact bf16 RN rounding,
        so the partials are rounded on every backend."""
        if cfg.gamma_psum_dtype == "bf16":
            gstat = jax.lax.reduce_precision(gstat, exponent_bits=8,
                                             mantissa_bits=7)
            gstat = jax.lax.psum(gstat.astype(jnp.bfloat16),
                                 axis_name=SNP_AXIS)
            return gstat.astype(jnp.float32)
        return jax.lax.psum(gstat, axis_name=SNP_AXIS)

    return _sample_gather, _stats_from_rows, _apply_gamma, _psum_gamma


def make_sharded_step(cfg: SVIConfig, plan: ShardPlan, mesh: Mesh,
                      streaming: bool = False, *, interpret: bool = False):
    """Build the shard_map'ed single step: (state, packed) -> state.

    See _build_step_parts for the local solve. For chunked
    stepping prefer make_sharded_run_chunk, which pipelines the gamma
    all-reduce against the next step's minibatch gather.

    streaming=True returns (state, rows) -> state instead: the minibatch
    rows arrive pre-gathered from the host (parallel/stream.py), sharded
    P('snp', 'ind') — shard s's b_local rows were sampled by the host
    with the SAME threefry schedule the resident step uses on device, so
    resident and streaming runs are bit-identical (tests/test_stream.py).
    Requires lambda_mode='local' (nothing SNP-indexed to scatter back).
    """
    sample_gather, stats_from_rows, apply_gamma, psum_gamma = (
        _build_step_parts(cfg, plan, mesh, interpret=interpret))

    def local_step(gamma_l, lamb_l, packed_l, t, key):
        # gamma_l: (N/I, K)  lamb_l: (L/S, K, 2)  packed_l: (L/S, W/I)
        rows, idx, kb = sample_gather(packed_l, t, key)
        lamb_l, gstat = stats_from_rows(gamma_l, lamb_l, rows, idx, t, kb)
        gstat = psum_gamma(gstat)
        gamma_l = apply_gamma(gamma_l, gstat, t)
        return gamma_l, lamb_l

    if streaming:
        if cfg.lambda_mode != "local":
            raise ValueError("sharded streaming requires "
                             "lambda_mode='local' (nothing SNP-indexed "
                             "to scatter back against a host matrix)")

        def local_step_stream(gamma_l, lamb_l, rows_l, t, key):
            # rows_l: (B/S, W/I) — this shard's slice of the host-
            # sampled minibatch. kb matches the resident step exactly
            # (the subsampled big-N solve folds it further on device).
            s_idx = jax.lax.axis_index(SNP_AXIS)
            kb = jax.random.fold_in(jax.random.fold_in(key, t), s_idx)
            lamb_l, gstat = stats_from_rows(gamma_l, lamb_l, rows_l,
                                            None, t, kb)
            gstat = psum_gamma(gstat)
            gamma_l = apply_gamma(gamma_l, gstat, t)
            return gamma_l, lamb_l

        sharded_stream = jax.shard_map(
            local_step_stream,
            mesh=mesh,
            in_specs=(
                meshlib.GAMMA_SPEC, meshlib.LAMB_SPEC, meshlib.PACKED_SPEC,
                P(), P(),
            ),
            out_specs=(meshlib.GAMMA_SPEC, meshlib.LAMB_SPEC),
            check_vma=False,
        )

        def step_stream(state: SVIState, rows) -> SVIState:
            gamma, lamb = sharded_stream(
                state.gamma, state.lamb, rows, state.t, state.key)
            return SVIState(gamma=gamma, lamb=lamb, t=state.t + 1,
                            key=state.key)

        return step_stream

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            meshlib.GAMMA_SPEC, meshlib.LAMB_SPEC, meshlib.PACKED_SPEC,
            P(), P(),
        ),
        out_specs=(meshlib.GAMMA_SPEC, meshlib.LAMB_SPEC),
        check_vma=False,
    )

    def step(state: SVIState, packed) -> SVIState:
        gamma, lamb = sharded(state.gamma, state.lamb, packed, state.t, state.key)
        return SVIState(gamma=gamma, lamb=lamb, t=state.t + 1, key=state.key)

    return step


def make_sharded_run_chunk(cfg: SVIConfig, plan: ShardPlan, mesh: Mesh,
                           nsteps: int, *, overlap: bool | None = None,
                           interpret: bool = False):
    """jit-compiled runner of `nsteps` sharded steps (one dispatch).

    The whole chunk runs as ONE shard_map around a local fori_loop, and
    the loop body is software-pipelined: step t+1's minibatch gather is
    issued BETWEEN step t's gamma all-reduce and the gamma update that
    consumes it. The gather depends only on (t, key), so XLA's
    latency-hiding scheduler can run the collective asynchronously
    (all-reduce-start before the gather, -done after), hiding the
    (N/I, K) payload — the one collective whose size grows with N and
    not with B — behind the gather's memory traffic. Semantics are
    EXACT: the
    update still consumes the fully-reduced statistic each step; only
    instruction order changes. Verified two ways: trajectory equality
    with the per-step runner (tests/test_sharded.py) and HLO dataflow
    independence of the gather from the all-reduce
    (benchmarks/comm_model.py overlap report).

    overlap=False falls back to the per-step shard_map loop (A/B and
    debugging); default (None) pipelines, matching cfg.comm_overlap.
    """
    if overlap is None:
        overlap = getattr(cfg, "comm_overlap", True)
    if not overlap:
        step = make_sharded_step(cfg, plan, mesh, interpret=interpret)

        @functools.partial(jax.jit, donate_argnums=(0,))
        def run_chunk_plain(state: SVIState, packed) -> SVIState:
            def body(_, s):
                return step(s, packed)
            return jax.lax.fori_loop(0, nsteps, body, state)

        return run_chunk_plain

    sample_gather, stats_from_rows, apply_gamma, psum_gamma = (
        _build_step_parts(cfg, plan, mesh, interpret=interpret))

    def local_chunk(gamma_l, lamb_l, packed_l, t0, key):
        rows, idx, kb = sample_gather(packed_l, t0, key)

        def body(i, carry):
            gamma_l, lamb_l, rows, idx, kb = carry
            t = t0 + i
            lamb_l, gstat = stats_from_rows(
                gamma_l, lamb_l, rows, idx, t, kb)
            gstat = psum_gamma(gstat)
            # prefetch the NEXT minibatch between the collective and
            # its consumer — no data dependency on gstat, so the
            # all-reduce can span it
            rows_n, idx_n, kb_n = sample_gather(packed_l, t + 1, key)
            gamma_l = apply_gamma(gamma_l, gstat, t)
            return gamma_l, lamb_l, rows_n, idx_n, kb_n

        gamma_l, lamb_l, _, _, _ = jax.lax.fori_loop(
            0, nsteps, body, (gamma_l, lamb_l, rows, idx, kb))
        return gamma_l, lamb_l

    chunk_sharded = jax.shard_map(
        local_chunk,
        mesh=mesh,
        in_specs=(
            meshlib.GAMMA_SPEC, meshlib.LAMB_SPEC, meshlib.PACKED_SPEC,
            P(), P(),
        ),
        out_specs=(meshlib.GAMMA_SPEC, meshlib.LAMB_SPEC),
        check_vma=False,
    )

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run_chunk(state: SVIState, packed) -> SVIState:
        gamma, lamb = chunk_sharded(
            state.gamma, state.lamb, packed, state.t, state.key)
        return SVIState(gamma=gamma, lamb=lamb, t=state.t + nsteps,
                        key=state.key)

    return run_chunk


def shard_state(state: SVIState, plan: ShardPlan, mesh: Mesh) -> SVIState:
    """Pad + reshard an unsharded state onto the mesh (e.g. after resume)."""
    gamma = np.asarray(state.gamma)
    lamb = np.asarray(state.lamb)
    if gamma.shape[0] != plan.n_padded:
        pad = np.ones((plan.n_padded - gamma.shape[0], gamma.shape[1]), gamma.dtype)
        gamma = np.concatenate([gamma, pad])
    if lamb.shape[0] != plan.l_padded:
        pad = np.ones((plan.l_padded - lamb.shape[0],) + lamb.shape[1:], lamb.dtype)
        lamb = np.concatenate([lamb, pad])
    gsh = NamedSharding(mesh, meshlib.GAMMA_SPEC)
    lsh = NamedSharding(mesh, meshlib.LAMB_SPEC)
    # make_array_from_callback works in multi-process runs (each process
    # materializes only its addressable shards from the host copy).
    return SVIState(
        gamma=jax.make_array_from_callback(
            gamma.shape, gsh, lambda idx: gamma[idx]),
        lamb=jax.make_array_from_callback(
            lamb.shape, lsh, lambda idx: lamb[idx]),
        t=_replicated(np.asarray(state.t, np.int32), mesh),
        key=(state.key
             if jax.dtypes.issubdtype(state.key.dtype, jax.dtypes.prng_key)
             else _replicated(state.key, mesh)),
    )


def shard_packed(cfg, data, mesh):
    """Convenience: prepare() returning only the sharded packed matrix."""
    return prepare(cfg, data, mesh)[1]


def make_sharded_compute_lambda(cfg: SVIConfig, plan: ShardPlan, mesh: Mesh,
                                *, block: int = 512, interpret: bool = False):
    """Sharded compute-beta core: converged lambda for EVERY SNP row.

    The post-pass (svi/postprocess.compute_lambda, reference
    `-compute-beta`, SURVEY.md §3.2) refits each SNP's lambda with theta
    frozen. Multi-host, no host holds the full matrix, so the solve runs
    under shard_map: each (ind, snp) shard processes its local SNP rows
    in blocks, individual sums psum over 'ind' between iterations
    (lockstep across ind shards), lambda lands sharded over 'snp'.

    Returns fn(gamma_sharded, packed_sharded) -> lamb (l_padded, K, 2)
    sharded with LAMB_SPEC.
    """
    kernel = resolve_kernel(cfg.kernel, cfg.compute_dtype, cfg.k,
                            interpret=interpret)
    wl = packed_width(plan.n_padded) // plan.ind
    l_local = plan.l_padded // plan.snp
    blk = min(block, l_local)
    nblocks = (l_local + blk - 1) // blk
    pad_rows = nblocks * blk - l_local
    psum_ind = functools.partial(jax.lax.psum, axis_name=IND_AXIS)

    def local_solve_rows(gamma_l, packed_l):
        u = ops.exp_elog_theta(gamma_l)                 # (4*wl, K)
        rows_all = packed_l
        if pad_rows:
            rows_all = jnp.concatenate(
                [rows_all, jnp.full((pad_rows, wl), 0xFF, jnp.uint8)])
        blocks = rows_all.reshape(nblocks, blk, wl)
        lamb0 = local_step.prior_lambda(cfg, blk)

        def solve_block(rows):
            # Same schedule and trailing exact pass as the single-device
            # post-pass (postprocess.solve_lambda_blocks).
            lam = local_step.solve(cfg, kernel, rows, u, lamb0,
                                   ind_reduce=psum_ind, interpret=interpret)
            return local_step.make_pass(cfg, kernel, rows, u,
                                        ind_reduce=psum_ind,
                                        interpret=interpret)(lam)

        lamb = jax.lax.map(solve_block, blocks)
        return lamb.reshape(-1, cfg.k, 2)[:l_local]

    solve = jax.shard_map(
        local_solve_rows,
        mesh=mesh,
        in_specs=(meshlib.GAMMA_SPEC, meshlib.PACKED_SPEC),
        out_specs=meshlib.LAMB_SPEC,
        check_vma=False,
    )
    return jax.jit(solve)
