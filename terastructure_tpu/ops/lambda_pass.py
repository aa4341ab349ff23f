"""One coordinate-ascent pass of the local solve, fused into a GPU kernel.

The pass (ops/stats_dense.lambda_stats) maps packed genotype rows and
the current t-factors to the lambda statistics:

  D1 = T1 @ U^T,  R1 = A1 / D1,  L0 = t1 * (R1 @ U)     (and 0 for 1)

Written in jax.numpy, XLA materialises A, D and R as (B, N) float32
arrays in device memory on every pass (41 MB each at B=4096, N=2504).
This Pallas kernel (Triton route) decodes the 2-bit rows in registers
and keeps D and R on chip, so a pass reads only the packed rows
(B * N/4 bytes) and u.

Planar layout: byte w of a packed row holds individuals 4w..4w+3, so bit
plane s, `(byte >> 2s) & 3`, is the strided set {4w+s}. u is passed as
planes (4, W, K) with planes[s, w] = u[4w+s]; each plane of a byte
chunk is then one contiguous (TW, K) tile.

Grid (B/TB, S): program (i, s) owns SNP rows [i*TB, (i+1)*TB) and the
s-th of S equal runs of TW-byte column chunks, looping over its chunks;
the S partial sums are added outside the kernel. S > 1 only when the
row tiles alone would leave the card's SMs idle (B=4096 gives 32 row
tiles for an H100's 132 SMs). The sums over individuals are per-call:
under an 'ind' sharded mesh the caller psums the returned statistics.

Dots run at `lax.Precision.DEFAULT` on float32 operands, which Triton
lowers to TF32 tensor-core products; the dense path's float32 dots at
the same default precision run as TF32 in cuBLAS on Hopper. K is padded
to 16, the narrowest operand Triton's dot takes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

KERNELS = ("auto", "dense", "triton")

_EPS = 1e-30
_KP = 16                  # K padded to Triton's minimum dot width
_H100_SMS = 132           # SM count when the device does not report one


class Tiles(NamedTuple):
    """Launch shape of the kernel. The defaults won the per-pass sweep of
    benchmarks/lambda_pass_sweep.py on an H100 (PERF.md): byte chunks
    wider than 32 spill registers; 128-row tiles amortise u's loads."""
    rows: int = 128       # SNP rows per program
    cols: int = 32        # packed bytes (4 * cols individuals) per chunk
    warps: int = 4
    stages: int = 2
    per_sm: int = 4       # programs in flight per SM the grid aims for


def resolve_kernel(kernel: str, compute_dtype: str, k: int, *,
                   interpret: bool = False) -> str:
    """The one place that picks the lambda-pass implementation.

    'auto' is the Triton kernel on a GPU at float32 with K <= 16, else
    'dense'. Asking for 'triton' where it cannot run is an error: off a
    GPU unless `interpret` (tests run the kernel through the Pallas
    interpreter on the CPU), at another compute dtype, or at K > 16."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    on_gpu = jax.default_backend() == "gpu"
    if kernel == "auto":
        fits = compute_dtype == "float32" and k <= _KP
        return "triton" if on_gpu and fits else "dense"
    if kernel == "triton":
        if not (on_gpu or interpret):
            raise ValueError("kernel='triton' needs a GPU backend, found "
                             f"{jax.default_backend()!r}")
        if compute_dtype != "float32":
            raise ValueError("kernel='triton' computes in float32; use "
                             "kernel='dense' for compute_dtype="
                             f"{compute_dtype!r}")
        if k > _KP:
            raise ValueError(f"kernel='triton' supports K <= {_KP}, got "
                             f"K={k}; use kernel='dense'")
    return kernel


def u_to_planes(u: jnp.ndarray) -> jnp.ndarray:
    """(4W, K) -> (4, W, K) planar layout (planes[s, w] = u[4w + s])."""
    n, k = u.shape
    return u.reshape(n // 4, 4, k).transpose(1, 0, 2)


def _kernel(rows_ref, u_ref, t1_ref, t0_ref, r1_ref, r0_ref, *, tw,
            chunks):
    split = pl.program_id(1)
    t1 = t1_ref[...]
    t0 = t0_ref[...]
    prec = lax.Precision.DEFAULT

    def body(c, carry):
        acc1, acc0 = carry
        cols = pl.ds((split * chunks + c) * tw, tw)
        x8 = rows_ref[:, cols].astype(jnp.int32)          # (TB, TW)
        for s in range(4):
            x = (x8 >> (2 * s)) & 3
            xf = x.astype(jnp.float32)
            missing = x == 3
            a1 = jnp.where(missing, 0.0, xf)
            a0 = jnp.where(missing, 0.0, 2.0 - xf)
            us = u_ref[s, cols, :]                         # (TW, KP)
            d1 = pl.dot(t1, us, trans_b=True, precision=prec)
            d0 = pl.dot(t0, us, trans_b=True, precision=prec)
            acc1 = acc1 + pl.dot(a1 / (d1 + _EPS), us, precision=prec)
            acc0 = acc0 + pl.dot(a0 / (d0 + _EPS), us, precision=prec)
        return acc1, acc0

    zero = jnp.zeros(t1.shape, jnp.float32)
    acc1, acc0 = lax.fori_loop(0, chunks, body, (zero, zero))
    r1_ref[...] = acc1
    r0_ref[...] = acc0


def sm_count() -> int:
    """Streaming multiprocessors of the default device, as the CUDA
    client reports them (`core_count`); an H100's 132 elsewhere."""
    return int(getattr(jax.devices()[0], "core_count", 0) or _H100_SMS)


def grid_shape(b: int, w: int, tiles: Tiles = Tiles(),
               sms: int = _H100_SMS) -> tuple[int, int, int]:
    """(row tiles, column splits, chunks per split) for a (B, W) call:
    enough splits to put `tiles.per_sm * sms` programs in flight where
    the width allows, and no split made of padding only."""
    nb = -(-b // tiles.rows)
    nchunks = -(-w // tiles.cols)
    want = -(-tiles.per_sm * sms // nb)
    chunks = -(-nchunks // max(1, min(nchunks, want)))
    return nb, -(-nchunks // chunks), chunks


@functools.partial(jax.jit, static_argnames=("tiles", "interpret"))
def lambda_pass(rows, u_planes, t1, t0, stat_scale=1.0, *, tiles=Tiles(),
                interpret=False):
    """Lambda statistics of one pass from packed rows.

    rows (B, W) uint8, u_planes (4, W, K), t1/t0 (B, K) float32.
    Returns (L0, L1), each (B, K): `stat_scale` times
    ops.stats_dense.lambda_stats on the decoded rows. Any B, W and
    K <= 16; padding decodes as MISSING and contributes nothing.
    """
    b, w = rows.shape
    k = t1.shape[1]
    if k > _KP:
        raise ValueError(f"lambda_pass supports K <= {_KP}, got {k}")
    tb, tw = tiles.rows, tiles.cols
    nb, splits, chunks = grid_shape(b, w, tiles, sm_count())
    bp, wp = nb * tb, splits * chunks * tw
    rows = jnp.pad(rows, ((0, bp - b), (0, wp - w)), constant_values=0xFF)
    up = jnp.pad(u_planes.astype(jnp.float32),
                 ((0, 0), (0, wp - w), (0, _KP - k)))
    t1p = jnp.pad(t1, ((0, bp - b), (0, _KP - k)))
    t0p = jnp.pad(t0, ((0, bp - b), (0, _KP - k)))
    row_tile = pl.BlockSpec((tb, _KP), lambda i, s: (i, 0))
    part = pl.BlockSpec((None, tb, _KP), lambda i, s: (s, i, 0))
    r1, r0 = pl.pallas_call(
        functools.partial(_kernel, tw=tw, chunks=chunks),
        grid=(nb, splits),
        in_specs=[pl.BlockSpec((tb, wp), lambda i, s: (i, 0)),
                  pl.BlockSpec((4, wp, _KP), lambda i, s: (0, 0, 0)),
                  row_tile, row_tile],
        out_specs=[part, part],
        out_shape=[jax.ShapeDtypeStruct((splits, bp, _KP), jnp.float32)] * 2,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=tiles.warps,
                                             num_stages=tiles.stages),
        interpret=interpret,
        name="lambda_pass",
    )(rows, up, t1p, t0p)
    r1 = r1.sum(axis=0)[:b, :k]
    r0 = r0.sum(axis=0)[:b, :k]
    return stat_scale * t1 * r1, stat_scale * t0 * r0
