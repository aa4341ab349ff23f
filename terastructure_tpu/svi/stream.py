"""Out-of-core SVI: fit datasets larger than device HBM (or host RAM).

The packed genotype matrix stays host-side — a RAM array or an on-disk
np.memmap (data/bed.bed_to_packed_cache) — instead of resident in HBM.
Each rfreq chunk runs a host loop: a background thread samples the next
minibatch's rows from the host matrix and device_puts them while the
current jitted step computes on-chip (double-buffered host->HBM
streaming). At B=4096 and N=1M a batch is ~1 GB; with grouped sampling
(cfg.snp_group) the host read is B/G contiguous row blocks.

This removes the reference's whole-matrix-in-RAM requirement
(SNP::read_bed materializes N x L uint8 host-side, src/snp.cc,
SURVEY.md §3.1 "memory hot spot") AND our own packed-in-device-memory
requirement: config #5 (1M x 1M, 250 GB packed) streams through one
card.

Determinism: the minibatch for step t is a pure function of
(cfg.seed, t) via np.random.default_rng(SeedSequence((seed, t))) — the
prefetch schedule cannot change results, and a resumed run replays the
exact sample sequence. Device-side RNG (the big-N inner-loop subsample
key) still folds the state key exactly like the resident engine.

Only lambda_mode='local' is supported: lambda stays derived state, so
nothing SNP-indexed needs scattering back against a non-resident
matrix.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.ops import local_step
from terastructure_tpu.ops.lambda_pass import resolve_kernel
from terastructure_tpu.svi import engine


class BatchStream:
    """Deterministic host-side minibatch sampler over a host matrix.

    packed_host: (L, W) uint8 ndarray or np.memmap. Batches come back
    width-padded to a 128-byte multiple (padding bytes 0xFF = MISSING)
    and already on device.
    """

    def __init__(self, cfg: SVIConfig, packed_host):
        self.packed = packed_host
        self.seed = cfg.seed
        self.b = cfg.batch_size
        self.l, self.w = packed_host.shape
        self.wp = self.w + (-self.w) % 128
        g = cfg.snp_group
        self.g = g if (g > 1 and self.b % g == 0) else 1
        # Block copies release the GIL; at biobank W a batch is ~1 GB of
        # host memcpy, so fan the group copies over a few threads — the
        # native threaded memcpy core when built (reference-style C++
        # runtime component, native/bedops.cpp gather_groups), a numpy
        # thread pool otherwise.
        self._native = None
        if self.g > 1 and getattr(packed_host, "flags", None) is not None \
                and packed_host.flags.c_contiguous:
            try:
                from terastructure_tpu import native

                self._native = native.gather_groups
            except ImportError:
                pass
        self._pool = (ThreadPoolExecutor(max_workers=4)
                      if self._native is None and self.g >= 8
                      and self.b * self.wp >= (64 << 20)
                      else None)
        # Ping-pong batch buffers (double-buffered prefetch => at most
        # two live batches): the 0xFF padding columns are written once.
        # Safe only when device_put genuinely copies (we block on the
        # transfer below); the CPU backend may alias numpy memory, so
        # reuse engages off-CPU only.
        self._reuse = jax.default_backend() != "cpu"
        self._bufs = ([np.full((self.b, self.wp), 0xFF, dtype=np.uint8)
                       for _ in range(2)] if self._reuse else None)

    def _fill_groups(self, buf, starts, lo, hi):
        g, l, w = self.g, self.l, self.w
        for i in range(lo, hi):
            s = starts[i]
            e = s + g
            if e <= l:
                buf[i * g:(i + 1) * g, :w] = self.packed[s:e]
            else:
                k1 = l - s
                buf[i * g:i * g + k1, :w] = self.packed[s:l]
                buf[i * g + k1:(i + 1) * g, :w] = self.packed[:e - l]

    def batch(self, t: int):
        """Sampled rows for step t -> device uint8 (B, Wp)."""
        rng = np.random.default_rng(np.random.SeedSequence((self.seed, t)))
        buf = (self._bufs[t % 2] if self._reuse
               else np.full((self.b, self.wp), 0xFF, dtype=np.uint8))
        g, l, w = self.g, self.l, self.w
        starts = rng.integers(0, l, size=self.b // g)
        if g == 1:
            # single fancy-index gather (memmap reads only touched rows)
            buf[:, :w] = self.packed[starts]
        elif self._native is not None:
            self._native(self.packed, starts.astype(np.int64), g, buf)
        elif self._pool is None:
            # contiguous groups with wraparound — uniform per-SNP marginal
            self._fill_groups(buf, starts, 0, len(starts))
        else:
            ng = len(starts)
            step = (ng + 3) // 4
            futs = [self._pool.submit(self._fill_groups, buf, starts,
                                      lo, min(lo + step, ng))
                    for lo in range(0, ng, step)]
            for f in futs:
                f.result()
        # device_put's host-buffer semantics require the source to stay
        # unmodified until the transfer completes; we reuse this buffer
        # two batches from now, so wait for the transfer (in the
        # prefetch thread) before handing the array over.
        out = jax.device_put(buf)
        if self._reuse:
            out.block_until_ready()
        return out


def make_stream_step(cfg: SVIConfig, l_sample: int, *,
                     interpret: bool = False):
    """Jitted SVI step consuming a pre-gathered device batch.

    Same math as engine.make_step's local-mode branch, with the
    minibatch gather lifted out to the host.
    """
    if cfg.lambda_mode != "local":
        raise ValueError("streaming SVI requires lambda_mode='local'")
    kernel = resolve_kernel(cfg.kernel, cfg.compute_dtype, cfg.k,
                            interpret=interpret)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state: engine.SVIState, rows) -> engine.SVIState:
        gamma, lamb, t, key = state
        kb = jax.random.fold_in(key, t)
        _, gamma_stat = engine.step_core(
            cfg, kernel, gamma, rows,
            local_step.prior_lambda(cfg, cfg.batch_size),
            key=jax.random.fold_in(kb, 0x5B), interpret=interpret)
        gamma = engine._global_update(cfg, gamma, gamma_stat, t, l_sample)
        return engine.SVIState(gamma=gamma, lamb=lamb, t=t + 1, key=key)

    return step


def make_stream_chunk(cfg: SVIConfig, nsteps: int,
                      l_sample: int | None = None):
    """Driver-compatible chunk runner: (state, packed_host) -> state.

    Drop-in for engine.make_run_chunk via svi.fit(..., stream=True)
    except `packed` stays a HOST array. Double-buffers: while step t
    computes, a worker thread assembles + device_puts batch t+1.
    """
    step = make_stream_step(cfg, l_sample or cfg.l)
    ex = ThreadPoolExecutor(max_workers=1)
    streams: dict[int, BatchStream] = {}

    def run(state: engine.SVIState, packed_host) -> engine.SVIState:
        bs = streams.get(id(packed_host))
        if bs is None:
            streams.clear()
            bs = streams[id(packed_host)] = BatchStream(cfg, packed_host)
        t0 = int(jax.device_get(state.t))
        fut = ex.submit(bs.batch, t0)
        for s in range(nsteps):
            rows = fut.result()
            if s + 1 < nsteps:
                fut = ex.submit(bs.batch, t0 + s + 1)
            state = step(state, rows)
        return state

    return run


def compute_lambda_stream(cfg: SVIConfig, gamma, packed_host, *,
                          block: int = 1024,
                          chunk_bytes: int = 1 << 30) -> np.ndarray:
    """Streaming equivalent of postprocess.compute_lambda.

    Materializes the full converged lambda (L, K, 2) f32 host-side by
    device_put-ing SNP-row chunks of the host matrix (~chunk_bytes each)
    and solving each with theta frozen. Powers export / compute-beta
    after a streamed fit.
    """
    from terastructure_tpu.ops import stats_dense as ops
    from terastructure_tpu.svi.postprocess import solve_lambda_blocks

    l, w = packed_host.shape
    wp = w + (-w) % 128
    u = local_step.pad_u(ops.exp_elog_theta(jnp.asarray(gamma)), wp)
    rows_per = max(block, (chunk_bytes // max(wp, 1)) // block * block)
    out = np.empty((l, cfg.k, 2), dtype=np.float32)
    for lo in range(0, l, rows_per):
        hi = min(lo + rows_per, l)
        buf = np.full((hi - lo, wp), 0xFF, dtype=np.uint8)
        buf[:, :w] = packed_host[lo:hi]
        lam = solve_lambda_blocks(cfg, u, jax.device_put(buf), block=block)
        out[lo:hi] = np.asarray(lam)
    return out[: cfg.l]


def compute_beta_stream(cfg: SVIConfig, gamma, packed_host, *,
                        block: int = 1024) -> np.ndarray:
    """Streaming compute-beta post-pass (reference -compute-beta parity
    for out-of-core runs)."""
    from terastructure_tpu.models import psd

    lam = compute_lambda_stream(cfg, gamma, packed_host, block=block)
    return np.asarray(psd.beta_mean(jnp.asarray(lam)))
