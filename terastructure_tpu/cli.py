"""Command-line interface — the reference binary's user surface, rebuilt.

Reference parity (src/main.cc + Env, SURVEY.md §2/§3): a run creates the
output directory ``n{N}-k{K}-l{L}-{label}/`` containing infer.log, the
validation log-likelihood trace, and gamma/theta/lambda/beta text files.
Subcommands replace the reference's flag soup:

    python -m terastructure_tpu.cli fit --bed data.bed -k 8 [--replicates 10]
    python -m terastructure_tpu.cli compute-beta --run-dir n..-k..-l..-run/
    python -m terastructure_tpu.cli simulate -n 1000 -l 10000 -k 3 -o sim
    python -m terastructure_tpu.cli validate --bed data.bed -k 3 --sampler nuts

The reference workflow of ~10 seeds / keep the best validation run
(SURVEY.md §1.2 step 6) is `fit --replicates R`.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np


def _add_model_args(p):
    p.add_argument("-k", type=int, required=True, help="ancestral populations")
    p.add_argument("--alpha", type=float, default=None,
                   help="Dirichlet prior (default 1/K)")
    p.add_argument("--beta-a", type=float, default=1.0)
    p.add_argument("--beta-b", type=float, default=1.0)


def _add_svi_args(p):
    p.add_argument("--batch-size", type=int, default=256,
                   help="SNP minibatch per iteration")
    p.add_argument("--tau0", type=float, default=1.0)
    p.add_argument("--kappa", type=float, default=0.5)
    p.add_argument("--local-iters", type=int, default=None,
                   help="coordinate-ascent passes per minibatch. Default "
                        "7 with the Aitken accel (or 16 plain under "
                        "--no-accel). An EXPLICIT value runs the plain "
                        "schedule unless paired with --accel — only the "
                        "accel7/plain16 points carry A/B quality data")
    p.add_argument("--accel", action="store_true",
                   help="pair an explicit --local-iters with the Aitken-"
                        "accelerated schedule (accel is the default only "
                        "at the studied --local-iters 7 point)")
    p.add_argument("--no-accel", action="store_true",
                   help="disable the Aitken-accelerated local solve "
                        "(SVIConfig.local_accel) — the reference's plain "
                        "fixed-point schedule (16 passes by default)")
    p.add_argument("--rfreq", type=int, default=100,
                   help="validation check every rfreq iterations")
    p.add_argument("--max-steps", type=int, default=20000)
    p.add_argument("--validation-frac", type=float, default=0.005)
    p.add_argument("--heldout-frac", type=float, default=0.005)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--label", default="run")
    p.add_argument("--out-base", default=".", help="where to create the run dir")
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--kernel", default="auto",
                   choices=["auto", "dense", "triton"],
                   help="per-pass lambda statistic: the fused GPU kernel "
                        "(triton), plain XLA (dense), or auto (triton on "
                        "a GPU at float32, else dense)")
    p.add_argument("--init-mode", default="random",
                   choices=["random", "spectral"],
                   help="gamma init: reference-style random, or "
                        "randomized-PCA + soft k-means warm start")
    p.add_argument("--predictive", default="plugin",
                   choices=["plugin", "variational"],
                   help="heldout predictive: plug-in Binom(2, E[th]^T "
                        "E[beta]) or the proper variational form")
    p.add_argument("--lambda-mode", default="local",
                   choices=["local", "stored"],
                   help="local: lambda recomputed on demand (fast); "
                        "stored: reference-style warm start + scatter")
    p.add_argument("--ind-shards", type=int, default=0,
                   help="mesh axis over individuals (hosts); 0 = auto")
    p.add_argument("--snp-shards", type=int, default=0,
                   help="mesh axis over SNPs (chips); 0 = auto")
    p.add_argument("--gamma-psum-dtype", default="f32",
                   choices=("f32", "bf16"),
                   help="reduction dtype for the gamma statistic's "
                        "psum('snp') — bf16 halves the N-proportional "
                        "wire payload")
    p.add_argument("--force-cpu", action="store_true",
                   help="run on CPU (tests/debug)")
    p.add_argument("--stream", action="store_true",
                   help="out-of-core fit: keep the packed matrix host-side "
                        "(disk memmap for --bed) and stream minibatches to "
                        "the device — for datasets larger than device HBM "
                        "or host RAM (requires --lambda-mode local)")
    p.add_argument("--stream-cache", default=None,
                   help="path for the on-disk packed cache of --bed "
                        "(default: <bed stem>.terapacked.npy)")
    p.add_argument("--eval-snp-pool", type=int, default=0,
                   help="restrict eval entries to this many unique SNPs "
                        "(bounds local-mode eval cost at big N; 0 = off)")
    _add_dist_args(p)


def _add_dist_args(p):
    p.add_argument("--distributed", action="store_true",
                   help="multi-host: jax.distributed.initialize; on GPU "
                        "hosts pass --coordinator, --num-processes and "
                        "--process-id")
    p.add_argument("--coordinator", default=None,
                   help="coordinator address host:port (implies --distributed)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def _add_data_args(p):
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--bed", help="PLINK .bed (with sibling .bim/.fam)")
    g.add_argument("--txt", help="text genotype matrix (SNP-major rows)")
    g.add_argument("--simulate", action="store_true",
                   help="fit a simulated PSD dataset (-n/-l required)")
    p.add_argument("-n", type=int, help="individuals (txt/simulate)")
    p.add_argument("-l", type=int, help="SNPs (txt/simulate)")
    p.add_argument("--idfile", default=None,
                   help="one individual ID per line; overrides .fam IDs "
                        "in every output (reference -idfile / "
                        "SNP::read_idfile)")


def _force_cpu():
    os.environ.pop("JAX_PLATFORMS", None)
    import jax

    jax.config.update("jax_platforms", "cpu")


def _load_data(args, *, seed: int):
    from terastructure_tpu.data import GenotypeData
    from terastructure_tpu.data.bed import read_text_genotypes
    from terastructure_tpu.data.dataset import EntrySet  # noqa: F401
    from terastructure_tpu.data.simulate import simulate_psd

    vf = getattr(args, "validation_frac", 0.005)
    hf = getattr(args, "heldout_frac", 0.005)
    pool = getattr(args, "eval_snp_pool", 0)
    if args.bed:
        if getattr(args, "stream", False):
            # Out-of-core ingest: translate the .bed into an on-disk
            # packed cache (chunked, O(chunk) RAM) and carve eval sets
            # on the resulting memmap — nothing biobank-sized is ever
            # resident (svi/stream.py).
            from terastructure_tpu.data.bed import bed_to_packed_cache

            cache = (getattr(args, "stream_cache", None)
                     or os.path.splitext(args.bed)[0] + ".terapacked.npy")
            packed, ind_ids, snp_ids = bed_to_packed_cache(args.bed, cache)
            data = GenotypeData.from_packed(
                packed, len(ind_ids), validation_frac=vf, heldout_frac=hf,
                seed=seed, ind_ids=ind_ids, snp_ids=snp_ids,
                eval_snp_pool=pool)
        else:
            # Packed-native ingest: .bed -> 2-bit working layout directly,
            # peak host RSS O(packed) not O(dense) (reference SNP::read_bed).
            data = GenotypeData.from_bed(
                args.bed, validation_frac=vf, heldout_frac=hf, seed=seed,
                eval_snp_pool=pool)
    elif args.txt:
        x = read_text_genotypes(args.txt).T            # (N, L)
        if args.n and x.shape[0] != args.n:
            raise SystemExit(
                f"-n {args.n} does not match {x.shape[0]} individuals in {args.txt}")
        data = GenotypeData.from_dense(
            x, validation_frac=vf, heldout_frac=hf, seed=seed,
            eval_snp_pool=pool)
    else:
        if not (args.n and args.l):
            raise SystemExit("--simulate requires -n and -l")
        _, _, x = simulate_psd(args.n, args.l, args.k, seed=seed)
        data = GenotypeData.from_dense(
            x, validation_frac=vf, heldout_frac=hf, seed=seed,
            eval_snp_pool=pool)
    idfile = getattr(args, "idfile", None)
    if idfile:
        with open(idfile) as f:
            ids = [ln.split()[0] for ln in f if ln.strip()]
        if len(ids) != data.n:
            raise SystemExit(
                f"--idfile has {len(ids)} IDs for {data.n} individuals")
        import dataclasses as _dc

        data = _dc.replace(data, ind_ids=ids)
    return data


def _setup_run_dir(cfg, base):
    run_dir = cfg.make_run_dir(base)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
        handlers=[
            logging.FileHandler(os.path.join(run_dir, "infer.log")),
            logging.StreamHandler(sys.stderr),
        ],
        force=True,
    )
    # absl/jax emit copious INFO; keep infer.log to our own records.
    for noisy in ("absl", "jax._src"):
        logging.getLogger(noisy).setLevel(logging.WARNING)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    return run_dir


def _cfg_from_args(args, n, l):
    from terastructure_tpu.config import SVIConfig

    # Accel pairing: the accel default applies only at the
    # studied accel7 point. An explicit --local-iters runs the plain
    # schedule unless --accel opts the extrapolation back in — so a
    # pre-round-4 `--local-iters 16` invocation still means plain16, not
    # a silent accel16 with no A/B data behind it.
    no_accel = getattr(args, "no_accel", False)
    want_accel = getattr(args, "accel", False)
    explicit_iters = args.local_iters is not None
    accel = (not no_accel) and (want_accel or not explicit_iters)
    iters = (args.local_iters if explicit_iters
             else (7 if accel else 16))
    if accel and iters < 3:
        accel = False              # extrapolation needs three iterates
    if explicit_iters and not (want_accel or no_accel):
        print(f"note: --local-iters {iters} runs the PLAIN fixed-point "
              "schedule; add --accel for the Aitken-accelerated solve "
              "or --no-accel to silence this note", file=sys.stderr)
    return SVIConfig(
        n=n, l=l, k=args.k, alpha=args.alpha,
        beta_a=args.beta_a, beta_b=args.beta_b,
        batch_size=min(args.batch_size, l),
        tau0=args.tau0, kappa=args.kappa,
        local_iters=iters,
        local_accel=accel,
        rfreq=args.rfreq, max_steps=args.max_steps,
        validation_frac=args.validation_frac,
        heldout_frac=args.heldout_frac,
        compute_dtype=args.compute_dtype,
        predictive=args.predictive,
        kernel=args.kernel, lambda_mode=args.lambda_mode,
        ind_shards=args.ind_shards, snp_shards=args.snp_shards,
        gamma_psum_dtype=getattr(args, "gamma_psum_dtype", "f32"),
        seed=args.seed, label=args.label,
        init=getattr(args, "init_mode", "random"),
    )


def _fit_multiprocess(args):
    """Per-process body of a multi-host `fit` (SPMD — same on every host).

    Each process ingests only its byte columns of the .bed
    (multihost.load_bed_shard); the lead process writes the run dir with
    gamma/theta text exports and result.json. Full per-SNP lambda/beta
    come from the compute-beta post-pass.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from terastructure_tpu.data.bed import read_bim, read_fam
    from terastructure_tpu.io.export import _write_matrix
    from terastructure_tpu.parallel import mesh as meshlib
    from terastructure_tpu.parallel import multihost
    from terastructure_tpu.parallel.fit import fit_sharded

    if not args.bed:
        raise SystemExit("multi-process fit requires --bed")
    stem = os.path.splitext(args.bed)[0]
    ind_ids = read_fam(stem + ".fam")
    snp_ids = read_bim(stem + ".bim")
    cfg = _cfg_from_args(args, len(ind_ids), len(snp_ids))
    lead = jax.process_index() == 0
    spec = meshlib.choose_mesh_shape(
        len(jax.devices()),
        cfg.ind_shards or jax.process_count(), cfg.snp_shards)
    mesh = meshlib.make_mesh(spec)
    data = multihost.load_bed_shard(
        args.bed, cfg, mesh,
        validation_frac=cfg.validation_frac,
        heldout_frac=cfg.heldout_frac,
        eval_snp_pool=args.eval_snp_pool or 2048)
    run_dir = _setup_run_dir(cfg, args.out_base) if lead else None
    log = logging.getLogger("terastructure_tpu")
    res = fit_sharded(
        cfg, data, mesh=mesh,
        metrics_path=os.path.join(run_dir, "metrics.jsonl") if lead else None,
        trace_path=os.path.join(run_dir, "validation.txt") if lead else None,
    )
    rep = jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))
    gamma = np.asarray(rep(res.state.gamma).addressable_data(0))[: cfg.n]
    if lead:
        theta = gamma / gamma.sum(axis=1, keepdims=True)
        _write_matrix(os.path.join(run_dir, "gamma.txt"), gamma, ind_ids)
        _write_matrix(os.path.join(run_dir, "theta.txt"), theta, ind_ids)
        with open(os.path.join(run_dir, "result.json"), "w") as f:
            json.dump(
                dict(seed=cfg.seed, converged=res.converged, steps=res.steps,
                     validation_ll=res.validation_ll,
                     heldout_ll=res.heldout_ll, wall_s=res.wall_s,
                     processes=jax.process_count(),
                     mesh=dict(ind=spec.ind, snp=spec.snp)),
                f, indent=2)
        log.info("multi-process fit done: %s", run_dir)
        print(run_dir)


def cmd_fit(args):
    if args.force_cpu:
        _force_cpu()
    from terastructure_tpu.config import SVIConfig
    from terastructure_tpu.io.checkpoint import save_checkpoint
    from terastructure_tpu.io.export import save_model
    from terastructure_tpu.svi import fit

    distributed = args.distributed or args.coordinator is not None
    if distributed:
        from terastructure_tpu.parallel import multihost

        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id)
        import jax

        if jax.process_count() > 1:
            return _fit_multiprocess(args)

    data0 = _load_data(args, seed=args.seed)
    cfg0 = _cfg_from_args(args, data0.n, data0.l)
    run_dir = _setup_run_dir(cfg0, args.out_base)
    log = logging.getLogger("terastructure_tpu")

    seeds = [args.seed + i for i in range(max(args.replicates, 1))]

    if len(seeds) > 1 and getattr(args, "batched", False):
        if args.stream or args.ind_shards or args.snp_shards or args.resume:
            raise SystemExit("--batched replicates is a single-device "
                             "resident path (no --stream/--*-shards/"
                             "--resume)")
        from terastructure_tpu.svi.replicates import (
            fit_replicates_batched, unstack_state)

        res_b = fit_replicates_batched(cfg0, data0, seeds)
        for i, rep in enumerate(res_b.replicates):
            sub = os.path.join(run_dir, f"replicate-s{rep.seed}")
            os.makedirs(sub, exist_ok=True)
            with open(os.path.join(sub, "result.json"), "w") as f:
                json.dump(dict(seed=rep.seed, converged=rep.converged,
                               steps=rep.steps,
                               validation_ll=rep.validation_ll,
                               batched=True), f, indent=2)
        bi = res_b.best
        best_rep = res_b.replicates[bi]
        st = unstack_state(res_b.states, bi)
        sub = os.path.join(run_dir, f"replicate-s{best_rep.seed}")
        if cfg0.lambda_mode == "local":
            # materialize the derived lambda for the SELECTED replicate
            # (the serial loop does this per fit; here once)
            from terastructure_tpu.svi.postprocess import compute_lambda

            packed_pad = np.asarray(data0.packed)
            wpad = (-packed_pad.shape[1]) % 128
            if wpad:
                packed_pad = np.pad(packed_pad, ((0, 0), (0, wpad)),
                                    constant_values=0xFF)
            lamb = compute_lambda(cfg0.replace(seed=best_rep.seed),
                                  st.gamma[: cfg0.n], packed_pad)
            st = st._replace(lamb=lamb)
        save_model(sub, st.gamma, st.lamb, n=cfg0.n, l=cfg0.l,
                   ind_ids=data0.ind_ids, snp_ids=data0.snp_ids)
        save_checkpoint(os.path.join(sub, "checkpoint"), st,
                        cfg0.replace(seed=best_rep.seed))
        log.info("batched replicates: best seed=%d validation_ll=%.6f "
                 "(%.1fs for %d lockstep fits)", best_rep.seed,
                 best_rep.validation_ll, res_b.wall_s, len(seeds))
        with open(os.path.join(run_dir, "best.json"), "w") as f:
            json.dump(dict(seed=best_rep.seed,
                           validation_ll=best_rep.validation_ll,
                           heldout_ll=None, batched=True,
                           dir=os.path.basename(sub)), f, indent=2)
        print(run_dir)
        return

    best = None
    for seed in seeds:
        cfg = cfg0.replace(seed=seed)
        # Replicates share one data split (comparable validation lls);
        # the seed varies init + minibatch stream only.
        data = data0
        sub = run_dir if len(seeds) == 1 else os.path.join(
            run_dir, f"replicate-s{seed}")
        os.makedirs(sub, exist_ok=True)
        log.info("fitting seed=%d -> %s", seed, sub)
        import jax

        ckpt_dir = os.path.join(sub, "checkpoint")
        state = None
        if args.resume and os.path.exists(os.path.join(ckpt_dir, "config.json")):
            from terastructure_tpu.io.checkpoint import restore_checkpoint

            state, ck_cfg = restore_checkpoint(ckpt_dir)
            # Model hyperparameters come from the checkpoint (they define
            # the run); runtime controls stay with the flags.
            merged = ck_cfg.replace(
                max_steps=cfg.max_steps, rfreq=cfg.rfreq, label=cfg.label,
                conv_tol=cfg.conv_tol, conv_patience=cfg.conv_patience)
            if merged != cfg:
                log.warning("resume: using checkpointed model hyperparameters")
            cfg = merged
            log.info("resuming from step %d", int(state.t))
        elif args.init_model:
            from terastructure_tpu.io.export import state_from_text_model

            state = state_from_text_model(args.init_model, cfg)
            log.info("initialized from text model %s", args.init_model)
        fit_kw = dict(
            state=state,
            metrics_path=os.path.join(sub, "metrics.jsonl"),
            trace_path=os.path.join(sub, "validation.txt"),
            checkpoint_dir=ckpt_dir,
        )
        if args.stream:
            if args.ind_shards or args.snp_shards:
                raise SystemExit("--stream is a single-device path; "
                                 "drop --ind-shards/--snp-shards")
            res = fit(cfg, data, stream=True, **fit_kw)
        elif args.ind_shards or args.snp_shards or len(jax.devices()) > 1:
            from terastructure_tpu.parallel import fit_sharded

            res = fit_sharded(cfg, data, **fit_kw)
        else:
            res = fit(cfg, data, **fit_kw)
        log.info(
            "seed=%d converged=%s steps=%d validation_ll=%.6f heldout_ll=%s",
            seed, res.converged, res.steps, res.validation_ll,
            f"{res.heldout_ll:.6f}" if res.heldout_ll is not None else "n/a",
        )
        save_model(sub, res.state.gamma, res.state.lamb,
                   n=cfg.n, l=cfg.l,
                   ind_ids=data.ind_ids, snp_ids=data.snp_ids)
        save_checkpoint(os.path.join(sub, "checkpoint"), res.state, cfg)
        with open(os.path.join(sub, "result.json"), "w") as f:
            json.dump(
                dict(seed=seed, converged=res.converged, steps=res.steps,
                     validation_ll=res.validation_ll,
                     heldout_ll=res.heldout_ll, wall_s=res.wall_s),
                f, indent=2)
        if best is None or res.validation_ll > best[1]:
            best = (seed, res.validation_ll, sub, res.heldout_ll)
    if len(seeds) > 1:
        log.info("best replicate: seed=%d validation_ll=%.6f (%s)",
                 best[0], best[1], best[2])
        # Selection is by VALIDATION ll (reference workflow, SURVEY.md
        # §1.2 step 6); the north-star comparison quantity is the CHOSEN
        # replicate's HELDOUT ll — record both.
        with open(os.path.join(run_dir, "best.json"), "w") as f:
            json.dump(dict(seed=best[0], validation_ll=best[1],
                           heldout_ll=best[3],
                           dir=os.path.basename(best[2])), f, indent=2)
    print(run_dir)


def cmd_compute_beta(args):
    if args.force_cpu:
        _force_cpu()
    from terastructure_tpu.io.checkpoint import restore_checkpoint
    from terastructure_tpu.io.export import _write_matrix
    from terastructure_tpu.svi.postprocess import compute_beta

    ckpt = os.path.join(args.run_dir, "checkpoint")
    state, cfg = restore_checkpoint(ckpt)
    if args.distributed or args.coordinator is not None:
        return _compute_beta_multiprocess(args, state, cfg)
    data = _load_data(args, seed=cfg.seed)
    if (data.n, data.l) != (cfg.n, cfg.l):
        raise SystemExit(
            f"data shape {(data.n, data.l)} != run config {(cfg.n, cfg.l)}")
    if getattr(args, "stream", False):
        from terastructure_tpu.svi.stream import compute_beta_stream

        beta = compute_beta_stream(cfg, state.gamma[: cfg.n], data.packed)
    else:
        beta = compute_beta(cfg, state.gamma[: cfg.n], data.packed)
    out = os.path.join(args.run_dir, "beta.txt")
    _write_matrix(out, beta, data.snp_ids)
    print(out)


def _compute_beta_multiprocess(args, state, cfg):
    """Sharded compute-beta post-pass: each host loads only its byte
    columns, lambda solves under shard_map with psum('ind'), the lead
    host writes beta.txt (reference `-compute-beta`, SURVEY.md §3.2)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from terastructure_tpu.io.export import _write_matrix
    from terastructure_tpu.models import psd
    from terastructure_tpu.parallel import mesh as meshlib
    from terastructure_tpu.parallel import multihost
    from terastructure_tpu.parallel import sharded

    if not args.bed:
        raise SystemExit("distributed compute-beta requires --bed")
    multihost.initialize(args.coordinator, args.num_processes,
                         args.process_id)
    spec = meshlib.choose_mesh_shape(
        len(jax.devices()),
        cfg.ind_shards or jax.process_count(), cfg.snp_shards)
    mesh = meshlib.make_mesh(spec)
    data = multihost.load_bed_shard(
        args.bed, cfg, mesh, validation_frac=0, heldout_frac=0)
    plan, packed = sharded.prepare(cfg, data, mesh)
    state = sharded.shard_state(state, plan, mesh)
    fn = sharded.make_sharded_compute_lambda(cfg, plan, mesh)
    lamb = fn(state.gamma, packed)
    rep = jax.jit(lambda x: x,
                  out_shardings=NamedSharding(mesh, P()))
    lamb_host = np.asarray(rep(lamb).addressable_data(0))[: cfg.l]
    if jax.process_index() == 0:
        beta = np.asarray(psd.beta_mean(lamb_host))
        out = os.path.join(args.run_dir, "beta.txt")
        _write_matrix(out, beta)
        print(out)


def cmd_simulate(args):
    from terastructure_tpu.data.bed import write_bed, write_bim, write_fam
    from terastructure_tpu.data.pack import pack2bit
    from terastructure_tpu.data.simulate import simulate_psd
    from terastructure_tpu.io.export import _write_matrix

    theta, beta, x = simulate_psd(
        args.n, args.l, args.k, alpha=args.alpha,
        beta_a=args.beta_a, beta_b=args.beta_b,
        missing_frac=args.missing_frac, seed=args.seed,
        structured=not args.unstructured,
    )
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    packed = pack2bit(np.ascontiguousarray(x.T))
    write_bed(args.out + ".bed", packed, args.n)
    write_fam(args.out + ".fam", [f"ind{i}" for i in range(args.n)])
    write_bim(args.out + ".bim", [f"snp{j}" for j in range(args.l)])
    _write_matrix(args.out + ".theta_true.txt", theta)
    if args.l <= 100_000:
        _write_matrix(args.out + ".beta_true.txt", beta)
    else:  # text export of 1M-row matrices takes minutes; npy is instant
        np.save(args.out + ".beta_true.npy", beta)
    print(args.out + ".bed")


def cmd_pca(args):
    """EIGENSTRAT-style principal components of the genotype matrix
    (Patterson/Price/Reich 2006) — randomized SVD over the packed
    2-bit matrix on-device (svi/init.pca_embedding); a standard
    companion analysis the reference pipeline defers to eigenstrat."""
    if args.force_cpu:
        _force_cpu()
    import jax

    data = _load_data(args, seed=args.seed)
    from terastructure_tpu.svi.init import pca_embedding

    from terastructure_tpu.io.export import _write_matrix

    packed = jax.device_put(np.asarray(data.packed))
    e = np.asarray(pca_embedding(packed, data.n, args.components + 1,
                                 seed=args.seed, l_real=data.l))
    out = args.out or "pcs.txt"
    _write_matrix(out, e, data.ind_ids)
    print(out)


def cmd_validate(args):
    if args.force_cpu:
        _force_cpu()
    from terastructure_tpu.mcmc.validate import compare_svi_mcmc

    data = _load_data(args, seed=args.seed)
    from terastructure_tpu.data.pack import unpack2bit

    x = unpack2bit(data.packed, data.n).T
    if args.sub_n or args.sub_l:
        x = x[: args.sub_n or x.shape[0], : args.sub_l or x.shape[1]]
    kw = {}
    if args.sampler in ("nuts", "hmc", "chees"):
        kw = dict(n_samples=args.n_samples, n_warmup=args.n_warmup,
                  n_chains=args.chains)
    rep = compare_svi_mcmc(x, k=args.k, sampler=args.sampler,
                           seed=args.seed, warm_start=not args.cold_start,
                           **kw)
    out = dict(theta_mae=rep.theta_mae, beta_mae=rep.beta_mae,
               svi_steps=rep.svi_steps,
               sampler=args.sampler)
    conv = rep.sampler_diag.get("convergence")
    if conv:
        out["convergence"] = {k_: {m: round(float(v), 4)
                                   for m, v in d.items()}
                              for k_, d in conv.items()}
    print(json.dumps(out))


def _translate_legacy(argv):
    """Translate reference-binary flags to the fit subcommand.

    The upstream CLI (src/main.cc, SURVEY.md §2) looks like
        terastructure -file g.bed -n 1000 -l 10000 -k 3 -label x \\
                      -rfreq 100 -seed 7 [-force] [-compute-beta]
    Detected when the first token is a reference-style flag.
    """
    known = {"-file", "-n", "-l", "-k", "-label", "-rfreq", "-seed",
             "-force", "-compute-beta", "-nthreads", "-idfile"}
    if not argv or argv[0] not in known:
        return None
    flags = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in ("-force", "-compute-beta"):
            flags[tok] = True
            i += 1
        elif tok in known:
            flags[tok] = argv[i + 1]
            i += 2
        else:
            i += 1
    if "-file" not in flags or "-k" not in flags:
        raise SystemExit("legacy mode needs at least -file and -k")
    out = ["fit", "--bed", flags["-file"], "-k", str(flags["-k"])]
    if flags.get("-compute-beta"):
        raise SystemExit(
            "legacy -compute-beta: use `compute-beta --run-dir ... --bed ...`")
    if "-label" in flags:
        out += ["--label", flags["-label"]]
    if "-rfreq" in flags:
        out += ["--rfreq", str(flags["-rfreq"])]
    if "-seed" in flags:
        out += ["--seed", str(flags["-seed"])]
    if "-idfile" in flags:
        out += ["--idfile", flags["-idfile"]]
    # -n/-l are read from .fam/.bim; -nthreads has no meaning here.
    return out


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    legacy = _translate_legacy(list(argv))
    if legacy is not None:
        print(f"[legacy flags] -> {' '.join(legacy)}", file=sys.stderr)
        argv = legacy
    ap = argparse.ArgumentParser(
        prog="terastructure_tpu",
        description="Accelerator SVI for the PSD/admixture model",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("fit", help="fit the model with SVI")
    _add_data_args(p)
    _add_model_args(p)
    _add_svi_args(p)
    p.add_argument("--replicates", type=int, default=1,
                   help="multi-seed replicates; keep best validation ll")
    p.add_argument("--batched", action="store_true",
                   help="run all replicates in lockstep under ONE "
                        "vmapped compile (svi/replicates.py): shares "
                        "the packed matrix, amortizes dispatch + eval "
                        "R-fold; single-device resident path only")
    p.add_argument("--resume", action="store_true",
                   help="resume from the run dir's checkpoint")
    p.add_argument("--init-model", default=None,
                   help="continue from a TEXT model dir (gamma.txt [+ "
                        "lambda.txt]) — the reference's resume format")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("compute-beta",
                       help="refit per-SNP beta with theta frozen")
    p.add_argument("--run-dir", required=True)
    _add_data_args(p)
    p.add_argument("-k", type=int, required=False, help="(ignored; from run)")
    p.add_argument("--force-cpu", action="store_true")
    p.add_argument("--stream", action="store_true",
                   help="out-of-core post-pass over a host-side matrix")
    p.add_argument("--stream-cache", default=None)
    _add_dist_args(p)
    p.set_defaults(fn=cmd_compute_beta)

    p = sub.add_parser("simulate", help="draw a PSD dataset, write PLINK files")
    p.add_argument("-n", type=int, required=True)
    p.add_argument("-l", type=int, required=True)
    _add_model_args(p)
    p.add_argument("--missing-frac", type=float, default=0.0)
    p.add_argument("--unstructured", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--out", required=True, help="output path stem")
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("pca", help="top principal components of the "
                       "genotype matrix (randomized SVD on-device)")
    _add_data_args(p)
    p.add_argument("--components", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--force-cpu", action="store_true")
    p.add_argument("-o", "--out", default=None, help="output text path")
    p.set_defaults(fn=cmd_pca)

    p = sub.add_parser("plot", help="STRUCTURE-style admixture bar plot")
    p.add_argument("source", help="run dir (with theta.txt) or a theta.txt")
    p.add_argument("-o", "--out", default="admixture.png")
    p.add_argument("--no-sort", action="store_true")
    p.set_defaults(fn=lambda a: __import__(
        "terastructure_tpu.viz", fromlist=["main"]).main(
            [a.source, "-o", a.out] + (["--no-sort"] if a.no_sort else [])))

    p = sub.add_parser("validate", help="SVI vs NUTS/HMC/SMC moments")
    _add_data_args(p)
    _add_model_args(p)
    _add_svi_args(p)
    p.add_argument("--sampler", default="nuts",
                   choices=["nuts", "hmc", "chees", "smc"])
    p.add_argument("--sub-n", type=int, default=0, help="subsample individuals")
    p.add_argument("--sub-l", type=int, default=0, help="subsample SNPs")
    p.add_argument("--n-samples", type=int, default=500)
    p.add_argument("--n-warmup", type=int, default=400)
    p.add_argument("--chains", type=int, default=4,
                   help="NUTS/HMC chains (label-aligned R-hat/ESS "
                        "reported when > 1)")
    p.add_argument("--cold-start", action="store_true",
                   help="disable the SVI warm-start/mass preconditioner")
    p.set_defaults(fn=cmd_validate)

    args = ap.parse_args(argv)
    from terastructure_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    main()
