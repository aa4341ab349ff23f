"""Multi-host initialization + per-process data ingest.

The reference is single-process and loads the whole N x L matrix in RAM
(src/snp.cc, SURVEY.md §2); multi-host here means `jax.distributed` + the
same SPMD program on every host. Individuals shard across hosts (gamma
rows live on the host that owns them — local natural-gradient updates
need no cross-host traffic beyond the small (B, K) lambda-stat psums),
SNPs across the cards within each host (NVLink).

Data plumbing (the part that makes 1M x 1M = 250 GB packed actually
runnable): each host reads ONLY its individuals' byte columns of the
.bed (`local_byte_cols` -> `data.bed.read_bed(byte_cols=...)`), plus the
full-width rows of the (small, deterministic) eval-SNP pool so heldout /
validation scoring works host-side. `sharded.prepare` then assembles the
global sharded array from these process-local buffers
(jax.make_array_from_single_device_arrays) — no host ever materializes
the full matrix.

Usage (same on every host):

    from terastructure_tpu.parallel import multihost
    multihost.initialize("host0:1234", num_processes=2, process_id=i)
    mesh = meshlib.make_mesh(meshlib.choose_mesh_shape(
        len(jax.devices()), ind=multihost.process_count()))
    data = multihost.load_bed_shard(path, cfg, mesh)
    res = fit_sharded(cfg, data, mesh=mesh)
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import NamedSharding

from terastructure_tpu.parallel import mesh as meshlib


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               local_device_ids=None):
    """jax.distributed.initialize. GPU hosts have no cluster
    auto-detection: pass the coordinator address (host:port), the number
    of processes and this process's id (the CLI's --coordinator,
    --num-processes and --process-id)."""
    kw = {}
    if coordinator_address is not None:
        kw.update(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    if local_device_ids is not None:
        kw.update(local_device_ids=local_device_ids)
    jax.distributed.initialize(**kw)


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def host_byte_slice(n: int, ind_shards: int, shard: int) -> tuple[int, int]:
    """[lo, hi) byte columns of the packed matrix owned by `shard`.

    Requires n padded to a multiple of 4*ind_shards (sharded.make_plan).
    """
    w = (n + 3) // 4
    if w % ind_shards:
        raise ValueError(
            f"packed width {w} not divisible by {ind_shards} shards; "
            "pad individuals first (sharded.prepare does this)")
    per = w // ind_shards
    return shard * per, (shard + 1) * per


def local_byte_cols(mesh, l_padded: int, w_padded: int) -> tuple[int, int]:
    """[lo, hi) byte columns of the global (l_padded, w_padded) packed
    matrix covered by THIS process's addressable devices under the
    canonical PACKED sharding. What each host must load from disk."""
    sh = NamedSharding(mesh, meshlib.PACKED_SPEC)
    cols = [idx[1]
            for idx in sh.addressable_devices_indices_map(
                (l_padded, w_padded)).values()]
    lo = min((c.start or 0) for c in cols)
    hi = max((c.stop if c.stop is not None else w_padded) for c in cols)
    return lo, hi


def load_bed_shard(
    path: str,
    cfg,
    mesh,
    *,
    validation_frac: float = 0.005,
    heldout_frac: float = 0.005,
    eval_snp_pool: int = 2048,
    max_eval_entries: Optional[int] = None,
    seed: Optional[int] = None,
):
    """Per-process ingest for a multi-host fit (deterministic across hosts).

    Every host computes the SAME eval carve (same seed -> same pool,
    same entries) but reads only its own byte columns of the training
    matrix. Peak host RSS is O(l * local_width + pool * full_width).
    """
    from terastructure_tpu.data.bed import read_bed, read_bed_rows
    from terastructure_tpu.data.dataset import GenotypeData, _carve_entries
    from terastructure_tpu.data.pack import packed_width
    from terastructure_tpu.parallel import sharded

    n, l = cfg.n, cfg.l
    seed = cfg.seed if seed is None else seed
    plan = sharded.make_plan(cfg, mesh)
    w_real = packed_width(n)
    lo, hi = local_byte_cols(mesh, plan.l_padded, packed_width(plan.n_padded))
    hi_real = min(hi, w_real)
    packed_local, _, _ = read_bed(path, n, l, byte_cols=(lo, hi_real))

    if validation_frac == 0 and heldout_frac == 0:
        # No eval carve requested (e.g. the compute-beta post-pass).
        return GenotypeData(n=n, l=l, packed=packed_local,
                            byte_col_offset=lo)

    # Deterministic eval carve on the pool rows (identical on all hosts).
    rng = np.random.default_rng(seed + 1_000_003)
    cap = (GenotypeData.MAX_EVAL_ENTRIES if max_eval_entries is None
           else max_eval_entries)
    pool_size = min(eval_snp_pool or l, l)
    pool = np.sort(rng.choice(l, size=pool_size, replace=False)).astype(
        np.int32)
    rows_full = read_bed_rows(path, n, l, pool)
    from terastructure_tpu.models.psd import MISSING

    # Entry counts target the FULL matrix's nnz (fraction semantics match
    # from_packed); the missing rate is estimated from the pool rows
    # (cheap, representative). The pool restriction only concentrates
    # which SNPs carry eval entries.
    probe_i = rng.integers(0, n, size=min(1 << 20, n * pool_size))
    probe_r = rng.integers(0, pool_size, size=probe_i.size)
    byte = rows_full[probe_r, probe_i >> 2]
    miss_rate = float((((byte >> (2 * (probe_i & 3)).astype(np.uint8)) & 3)
                       == MISSING).mean())
    nnz = int(n * l * (1.0 - miss_rate))
    n_val = min(int(round(validation_frac * nnz)), cap)
    n_held = min(int(round(heldout_frac * nnz)), cap)
    validation, heldout = _carve_entries(
        rows_full, n, pool_size, n_val, n_held, rng)
    # Remap pool-relative SNP indices to global; mirror the MISSING
    # recode into this host's byte-column slice of the training matrix.
    for es in (validation, heldout):
        if es is None:
            continue
        es.snp_idx = pool[es.snp_idx]
        col = es.ind_idx >> 2
        sel = (col >= lo) & (col < hi_real)
        if sel.any():
            i, j = es.ind_idx[sel], es.snp_idx[sel]
            shift = (2 * (i & 3)).astype(np.uint8)
            np.bitwise_or.at(packed_local, (j, (i >> 2) - lo),
                             np.uint8(3) << shift)
    return GenotypeData(
        n=n, l=l, packed=packed_local,
        validation=validation, heldout=heldout,
        byte_col_offset=lo,
        eval_rows_full=rows_full, eval_row_snps=pool,
    )
