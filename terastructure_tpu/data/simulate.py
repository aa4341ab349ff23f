"""PSD-model genotype simulator.

Reference parity: `scripts/` in the upstream repo simulate from the PSD
model in R (SURVEY.md §3.4) — draw theta ~ Dir(alpha), beta ~ Beta(a,b),
x ~ Binomial(2, theta^T beta) — to validate recovery of theta. We provide
the same generative draw in numpy (host-side; datasets are built once then
packed to device) plus an option for "structured" theta that concentrates
individuals on populations, which makes recovery tests sharp.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from terastructure_tpu.data.pack import pack2bit
from terastructure_tpu.models.psd import MISSING


def simulate_psd(
    n: int,
    l: int,
    k: int,
    *,
    alpha: Optional[float] = None,
    beta_a: float = 1.0,
    beta_b: float = 1.0,
    missing_frac: float = 0.0,
    structured: bool = True,
    seed: int = 0,
):
    """Draw (theta, beta, x) from the PSD model.

    Returns:
      theta: (n, k) float64 rows on the simplex
      beta:  (l, k) float64 in (0,1)   — note (L, K) layout, SNP-major
      x:     (n, l) int8 in {0,1,2} with MISSING=3 where masked
    """
    rng = np.random.default_rng(seed)
    if structured:
        # Concentrated Dirichlet per individual around a random dominant
        # population — mimics real admixture structure and makes theta
        # identifiable at small L (used by recovery tests).
        dominant = rng.integers(0, k, size=n)
        conc = np.full((n, k), 0.2)
        conc[np.arange(n), dominant] = 5.0
        theta = rng.dirichlet(np.ones(k), size=n) * 0  # placeholder shape
        for i in range(0, n, 4096):  # chunked to bound gamma-draw memory
            sl = slice(i, min(i + 4096, n))
            g = rng.gamma(conc[sl], 1.0)
            theta[sl] = g / g.sum(axis=1, keepdims=True)
    else:
        a = (1.0 / k) if alpha is None else alpha
        g = rng.gamma(a, 1.0, size=(n, k))
        theta = g / np.maximum(g.sum(axis=1, keepdims=True), 1e-300)

    beta = rng.beta(beta_a, beta_b, size=(l, k))
    # Keep allele frequencies away from the exact boundary for stable logs.
    beta = np.clip(beta, 1e-4, 1.0 - 1e-4)

    # Binomial(2, p) as two uniform-threshold draws, SNP-chunked —
    # np.random.binomial on an (n, l) matrix is ~10x slower and peaks
    # at 3x the memory at biobank shapes.
    x = np.empty((n, l), np.int8)
    jchunk = max(1024, min(l, (1 << 28) // max(n, 1)))
    for j0 in range(0, l, jchunk):
        j1 = min(j0 + jchunk, l)
        p = np.clip(theta @ beta[j0:j1].T, 0.0, 1.0).astype(np.float32)
        x[:, j0:j1] = (
            (rng.random(p.shape, np.float32) < p).astype(np.int8)
            + (rng.random(p.shape, np.float32) < p).astype(np.int8)
        )

    if missing_frac > 0:
        mask = rng.random((n, l)) < missing_frac
        x[mask] = MISSING
    return theta, beta, x


def simulate_packed(n, l, k, **kw):
    """Simulate and return (theta, beta, packed) with packed SNP-major.

    packed: uint8 (l, ceil(n/4)) — the layout the engine consumes.
    """
    theta, beta, x = simulate_psd(n, l, k, **kw)
    return theta, beta, pack2bit(np.ascontiguousarray(x.T))


def simulate_packed_device(n, l, k, *, seed: int = 0,
                           missing_frac: float = 0.0, chunk: int = 0,
                           progress=None):
    """Device-side PSD draw -> (packed (l, ceil(n/4)) uint8 HOST, theta).

    The host simulator costs hours at biobank shapes; this one draws the
    Binomial(2, theta.beta) genotypes and packs them to 2-bit ON DEVICE
    in SNP chunks (a matmul + threefry uniforms), pulling back
    ~n/4-byte rows per chunk. Requires
    n % 4 == 0. theta matches simulate_psd(structured=True)'s
    dominant-component shape (drawn host-side, same generator family but
    NOT bit-identical to simulate_psd). beta ~ U(0,1) per SNP is drawn
    host-side per chunk and not returned (regenerate from seed if
    needed).
    """
    import jax
    import jax.numpy as jnp

    if n % 4:
        raise ValueError("simulate_packed_device requires n % 4 == 0")
    if chunk <= 0:
        # Adaptive: the chunk materializes a handful of (C, N) f32/u32
        # temps on device, so bound C*N*4 to ~256 MB each.
        chunk = int(max(8, min(256, (1 << 28) // (4 * n))))
    rng = np.random.default_rng(seed)
    dominant = rng.integers(0, k, size=n)
    conc = np.full((n, k), 0.2)
    conc[np.arange(n), dominant] = 5.0
    theta = np.empty((n, k), np.float32)
    for i in range(0, n, 1 << 16):
        sl = slice(i, min(i + (1 << 16), n))
        g = rng.gamma(conc[sl], 1.0)
        theta[sl] = (g / g.sum(1, keepdims=True)).astype(np.float32)
    theta_d = jax.device_put(theta)
    w = n // 4

    @jax.jit
    def sim_chunk(theta_d, beta, key):
        p = jnp.clip(beta @ theta_d.T, 0.0, 1.0)          # (C, N)
        k1, k3 = jax.random.split(key)
        # Binomial(2, p) by inverse CDF from ONE uniform (halves the
        # (C, N) u32 bit temps vs two Bernoulli draws — the temps are
        # what bounds the chunk size): x = [u >= (1-p)^2] + [u >= 1-p^2].
        u = jax.random.uniform(k1, p.shape, jnp.float32)
        q0 = (1.0 - p) * (1.0 - p)
        x = ((u >= q0).astype(jnp.int32)
             + (u >= 1.0 - p * p).astype(jnp.int32))
        if missing_frac > 0:
            u3 = jax.random.uniform(k3, p.shape, jnp.float32)
            x = jnp.where(u3 < missing_frac, 3, x)
        q = x.reshape(-1, w, 4)     # byte b holds individuals 4b..4b+3
        packed = (q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4)
                  | (q[..., 3] << 6))
        return packed.astype(jnp.uint8)

    packed = np.empty((l, w), np.uint8)
    key = jax.random.PRNGKey(seed)
    for j0 in range(0, l, chunk):
        j1 = min(j0 + chunk, l)
        beta = np.clip(rng.beta(1, 1, size=(chunk, k)), 1e-4,
                       1 - 1e-4).astype(np.float32)
        out = sim_chunk(theta_d, jax.device_put(beta),
                        jax.random.fold_in(key, j0))
        packed[j0:j1] = np.asarray(out)[: j1 - j0]
        if progress is not None:
            progress(j1, l)
    return packed, theta


def simulate_packed_device_resident(n, l, k, *, seed: int = 0,
                                    missing_frac: float = 0.0, chunk: int = 0,
                                    progress=None):
    """Device-side PSD draw whose packed matrix STAYS ON DEVICE.

    Same generative draw as simulate_packed_device (identical stream for
    the same seed/chunk), but each chunk is written into a preallocated
    device (l, n//4) uint8 buffer with a donated dynamic_update_slice —
    no host round trip: returns (packed jax.Array (l, w) uint8, theta
    (n, k) f32 host).
    """
    import functools

    import jax
    import jax.numpy as jnp

    if n % 4:
        raise ValueError("simulate_packed_device requires n % 4 == 0")
    if chunk <= 0:
        chunk = int(max(8, min(256, (1 << 28) // (4 * n))))
    chunk = min(chunk, l)
    rng = np.random.default_rng(seed)
    dominant = rng.integers(0, k, size=n)
    conc = np.full((n, k), 0.2)
    conc[np.arange(n), dominant] = 5.0
    theta = np.empty((n, k), np.float32)
    for i in range(0, n, 1 << 16):
        sl = slice(i, min(i + (1 << 16), n))
        g = rng.gamma(conc[sl], 1.0)
        theta[sl] = (g / g.sum(1, keepdims=True)).astype(np.float32)
    theta_d = jax.device_put(theta)
    w = n // 4

    @functools.partial(jax.jit, donate_argnums=(0,))
    def sim_chunk_into(packed, theta_d, beta, key, j0):
        p = jnp.clip(beta @ theta_d.T, 0.0, 1.0)          # (C, N)
        k1, k3 = jax.random.split(key)
        u = jax.random.uniform(k1, p.shape, jnp.float32)
        q0 = (1.0 - p) * (1.0 - p)
        x = ((u >= q0).astype(jnp.int32)
             + (u >= 1.0 - p * p).astype(jnp.int32))
        if missing_frac > 0:
            u3 = jax.random.uniform(k3, p.shape, jnp.float32)
            x = jnp.where(u3 < missing_frac, 3, x)
        q = x.reshape(-1, w, 4)
        rows = (q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4)
                | (q[..., 3] << 6)).astype(jnp.uint8)
        return jax.lax.dynamic_update_slice(packed, rows, (j0, 0))

    packed = jnp.full((l, w), 0xFF, jnp.uint8)   # padding rows = MISSING
    key = jax.random.PRNGKey(seed)
    for j0 in range(0, l, chunk):
        j1 = min(j0 + chunk, l)
        beta = np.clip(rng.beta(1, 1, size=(chunk, k)), 1e-4,
                       1 - 1e-4).astype(np.float32)
        # Tail chunk: clamp the write origin so the full-chunk rows stay
        # in range; overlapping rows are simply overwritten with the tail
        # chunk's draw (valid PSD rows either way).
        packed = sim_chunk_into(
            packed, theta_d, jax.device_put(beta),
            jax.random.fold_in(key, j0),
            jnp.int32(min(j0, l - chunk)))
        if progress is not None:
            progress(j1, l)
    return packed, theta
