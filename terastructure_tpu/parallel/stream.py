"""Out-of-core SVI over the 2-D device mesh: streaming x sharding.

The single-device streamer (svi/stream.py) device_puts a batch with no
mesh sharding, and literal config #5 (1M x 1M, 250 GB packed —
BASELINE.json:10) needs ~250 GB of aggregate device memory to run
resident. This module composes streaming and sharding: the host samples
each step's minibatch with the SAME threefry schedule the resident
sharded step uses on device, assembles the (B, W_padded) rows buffer,
and device_puts it with the canonical P('snp', 'ind') sharding feeding
sharded.make_sharded_step(streaming=True). Streaming therefore equals
the resident sharded fit BIT-FOR-BIT (tests/test_stream.py) while
holding only O(B x W) bytes on each device per step.

Reference contrast: SNP::read_bed materializes the whole N x L matrix in
host RAM (upstream src/snp.cc, SURVEY.md §3.1 "memory hot spot"); here
the matrix lives in a host memmap and each host only ever touches its
own byte columns (multihost.local_byte_cols) of the sampled rows.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data.pack import packed_width
from terastructure_tpu.parallel import mesh as meshlib
from terastructure_tpu.parallel import sharded


class ShardedBatchStream:
    """Host-side minibatch sampler reproducing the sharded device step's
    sample, laid out for the P('snp', 'ind') rows sharding.

    packed_host: (l, w) uint8 ndarray/np.memmap — the full matrix, or
    this process's byte-column slice starting at `byte_col_offset`
    (multihost.load_bed_shard). Batches come back as global device
    arrays (B, W_padded); rows [s*b_local:(s+1)*b_local] hold SNP shard
    s's sample, exactly the rows the resident step would have gathered.
    """

    def __init__(self, cfg: SVIConfig, plan: sharded.ShardPlan, mesh,
                 packed_host, byte_col_offset: int = 0):
        self.cfg = cfg
        self.plan = plan
        self.b_local = plan.batch_per_shard
        self.l_local = plan.l_padded // plan.snp
        self.snp = plan.snp
        self.packed = packed_host
        self.col0 = byte_col_offset
        self.w_padded = packed_width(plan.n_padded)
        self.gshape = (cfg.batch_size, self.w_padded)
        self.sh = NamedSharding(mesh, meshlib.PACKED_SPEC)
        self._cpu = jax.local_devices(backend="cpu")[0]
        self._multiproc = jax.process_count() > 1
        # Ping-pong buffers as in svi.stream.BatchStream: padding bytes
        # (0xFF = MISSING) are written once; reuse engages only when
        # device_put genuinely copies (not the CPU backend).
        self._reuse = (jax.default_backend() != "cpu"
                       and not self._multiproc)
        self._bufs = ([np.full(self.gshape, 0xFF, np.uint8)
                       for _ in range(2)] if self._reuse else None)
        # Threaded memcpy core for the host gather (native/bedops.cpp —
        # the reference-style C++ runtime component).
        self._native = None
        if (byte_col_offset == 0
                and getattr(packed_host, "flags", None) is not None
                and packed_host.flags.c_contiguous):
            try:
                from terastructure_tpu import native

                self._native = native.gather_groups
            except ImportError:
                pass

        b_local, l_local, nsnp = self.b_local, self.l_local, self.snp

        @jax.jit
        def _indices(key, t):
            """Per-shard local row indices for step t — the exact
            threefry draws sharded.make_sharded_step makes on device
            (fold_in(fold_in(key, t), s_idx) then randint)."""
            def per_shard(s):
                kb = jax.random.fold_in(jax.random.fold_in(key, t), s)
                return jax.random.randint(kb, (b_local,), 0, l_local,
                                          jnp.int32)

            return jax.vmap(per_shard)(jnp.arange(nsnp, dtype=jnp.int32))

        self._idx_fn = _indices

    def indices(self, key_np, t: int) -> np.ndarray:
        """(snp, b_local) local row indices, computed on the host CPU
        backend (threefry is backend-invariant, so they match the
        resident device draw bit-for-bit)."""
        with jax.default_device(self._cpu):
            idx = self._idx_fn(jnp.asarray(key_np), jnp.int32(t))
        return np.asarray(idx)

    def _fill(self, buf, idx):
        """Gather sampled rows into a (B, w_padded) host buffer. Rows
        beyond the real matrix (SNP padding) and byte columns another
        host owns stay 0xFF (MISSING)."""
        l_data, w_host = self.packed.shape
        c0, c1 = self.col0, self.col0 + w_host
        for s in range(self.snp):
            rows_g = s * self.l_local + idx[s]
            valid = rows_g < l_data
            blk = buf[s * self.b_local:(s + 1) * self.b_local]
            if self._native is not None and valid.all():
                # threaded per-row memcpy (the row block of buf is
                # contiguous and full-width; native writes cols
                # [0, w_host))
                self._native(self.packed, rows_g.astype(np.int64), 1, blk)
                continue
            dst = blk[:, c0:c1]
            if valid.all():
                dst[:] = self.packed[rows_g]
            else:
                dst[valid] = self.packed[rows_g[valid]]
                dst[~valid] = 0xFF

    def batch(self, key_np, t: int):
        idx = self.indices(key_np, t)
        if not self._multiproc:
            buf = (self._bufs[t % 2] if self._reuse
                   else np.full(self.gshape, 0xFF, np.uint8))
            self._fill(buf, idx)
            out = jax.device_put(buf, self.sh)
            if self._reuse:
                # the transfer must finish before this buffer is reused
                out.block_until_ready()
            return out

        # Multi-process: every process contributes only its addressable
        # (rows, cols) blocks, mirroring sharded.prepare's assembly.
        l_data, w_host = self.packed.shape
        arrs = []
        for dev, (rs, cs) in self.sh.addressable_devices_indices_map(
                self.gshape).items():
            r0 = rs.start or 0
            r1 = rs.stop if rs.stop is not None else self.gshape[0]
            c0 = cs.start or 0
            c1 = cs.stop if cs.stop is not None else self.w_padded
            blk = np.full((r1 - r0, c1 - c0), 0xFF, np.uint8)
            s = r0 // self.b_local
            rows_g = s * self.l_local + idx[s]
            cc0 = max(c0, self.col0)
            cc1 = min(c1, self.col0 + w_host)
            if cc1 > cc0:
                valid = rows_g < l_data
                sub = self.packed[rows_g[valid], cc0 - self.col0:
                                  cc1 - self.col0]
                blk[np.where(valid)[0], cc0 - c0:cc1 - c0] = sub
            arrs.append(jax.device_put(blk, dev))
        return jax.make_array_from_single_device_arrays(
            self.gshape, self.sh, arrs)


def make_sharded_stream_chunk(cfg: SVIConfig, plan, mesh, nsteps: int,
                              byte_col_offset: int = 0, *,
                              interpret: bool = False):
    """Driver-compatible chunk runner over a HOST matrix and the mesh.

    Double-buffered like svi.stream.make_stream_chunk: while step t
    computes on the mesh, a worker thread assembles + device_puts the
    sharded batch for t+1.
    """
    step = jax.jit(
        sharded.make_sharded_step(cfg, plan, mesh, streaming=True,
                                  interpret=interpret),
        donate_argnums=(0,))
    ex = ThreadPoolExecutor(max_workers=1)
    streams: dict[int, ShardedBatchStream] = {}

    def run(state, packed_host):
        bs = streams.get(id(packed_host))
        if bs is None:
            streams.clear()
            bs = streams[id(packed_host)] = ShardedBatchStream(
                cfg, plan, mesh, packed_host,
                byte_col_offset=byte_col_offset)
        t0 = int(jax.device_get(state.t))
        key_np = np.asarray(jax.device_get(state.key))
        fut = ex.submit(bs.batch, key_np, t0)
        for s in range(nsteps):
            rows = fut.result()
            if s + 1 < nsteps:
                fut = ex.submit(bs.batch, key_np, t0 + s + 1)
            state = step(state, rows)
        return state

    return run
