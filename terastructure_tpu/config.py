"""Run configuration — the equivalent of the reference's `Env`.

The reference (src/env.{hh,cc}, per SURVEY.md §2) holds every CLI option as a
field on an `Env` struct and derives an output directory named
``n{N}-k{K}-l{L}-{label}``. We keep that run-dir convention for tooling
parity but replace the hand-rolled argv parsing with a frozen dataclass that
is hashable (so it can be a static argument to ``jax.jit``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SVIConfig:
    """Hyperparameters and run options for SVI on the PSD model.

    Defaults follow the reference semantics reconstructed in SURVEY.md §1.2:
    symmetric Dirichlet prior ``alpha = 1/K``, uniform Beta(1,1) prior on
    allele frequencies, Robbins–Monro step size ``rho_t = (tau0 + t)^-kappa``.
    """

    n: int = 0                  # individuals
    l: int = 0                  # SNPs (loci)
    k: int = 3                  # ancestral populations

    # Priors.
    alpha: Optional[float] = None   # None -> 1/K (reference default [MED])
    beta_a: float = 1.0             # Beta prior on allele freqs
    beta_b: float = 1.0

    # Robbins–Monro step-size schedule.
    tau0: float = 1.0
    kappa: float = 0.5

    # Minibatch of SNPs per iteration. The reference subsamples loci
    # (SURVEY.md §1.2); we batch many per step to fill the device.
    batch_size: int = 64

    # SNP-group sampling granularity: the minibatch is drawn as
    # batch_size/snp_group uniform groups of snp_group consecutive SNPs.
    # Group draws keep the gamma natural-gradient estimate unbiased
    # (every SNP equally likely; scale L/B unchanged) while turning the
    # per-step gathers/scatters into few large contiguous reads. Set 1
    # (default) for fully independent draws (reference behavior); groups
    # only engage at biobank L (engine falls back to 1 when L <= 65536).
    snp_group: int = 1

    # Local coordinate-ascent (phi <-> lambda) iterations per minibatch.
    # Default 7 pairs with local_accel below (5 loop passes + 2 unrolled
    # feeding the extrapolation); set 16 with local_accel=False for the
    # reference's plain schedule (SURVEY.md §1.2 "until local
    # convergence").
    local_iters: int = 7
    local_tol: float = 1e-4     # mean |delta lambda| early-exit threshold

    # Aitken-accelerated local solve: apply one per-coordinate Aitken
    # delta^2 extrapolation at the LAST coordinate-ascent iteration
    # (ops/stats_dense.aitken_final). The plain fixed point contracts
    # slowly; 5 passes + two tail passes + one clamped extrapolation
    # replace the reference's 16 plain passes at equal end-to-end
    # quality (heldout and theta MAE within Monte-Carlo error at the
    # TGP shape).
    local_accel: bool = True

    # Big-N inner-loop subsampling: run the lambda coordinate-ascent
    # ITERATIONS on a per-step random subsample of this many individuals
    # (N/Ns-scaled statistics), then take ONE exact full-N pass for the
    # final lambda + gamma statistics. The solve runs ~8 passes;
    # subsampling cuts that to ~1 full-pass equivalent with per-step
    # lambda noise ~1/sqrt(Ns) that the exact final pass reduces to one
    # coordinate-ascent step's worth. 0 disables; active only when
    # padded N >= 4x this value (ops/local_step.sub_columns).
    local_sub_n: int = 8192

    # With local_sub_n active: run one exact full-N refinement sweep
    # between the subsampled solve and the final stats pass. The stats
    # pass is itself a full-N lambda iteration (new lambda = prior +
    # exact stats), so the extra sweep only contracts the subsample
    # perturbation in the t-factors the GAMMA statistic sees. Off by
    # default: its quality effect was within run noise, and the eval
    # scorer's lambda re-solve (svi/postprocess.solve_lambda_blocks)
    # never refines.
    local_refine_full: bool = False

    # Heldout/validation entry fractions (SURVEY.md §1.2 step 5).
    validation_frac: float = 0.005
    heldout_frac: float = 0.005

    # Heldout predictive form (SURVEY.md §3.3 [LOW] — which one the
    # reference uses is unverified while the mount is empty):
    # "plugin" = Binom(2, E[theta]^T E[beta]); "variational" = the
    # proper E_q[Binom(2, s)] in closed form (models/psd.py). Both are
    # implemented; config.json records the one in use for every run.
    predictive: str = "plugin"

    # Convergence assessment.
    rfreq: int = 100            # validation log-lik every rfreq iterations
    max_steps: int = 10_000
    conv_tol: float = 1e-5      # relative validation-ll improvement floor
    conv_patience: int = 3      # consecutive non-improving checks to stop

    # Numerics: dtype for the hot matmuls' operands (float32 or
    # bfloat16); accumulation is always float32.
    compute_dtype: str = "float32"

    # Per-pass lambda statistic of the local solve: "dense" (jnp
    # matmuls over (B, N) allele counts), "triton" (the fused GPU
    # kernel of ops/lambda_pass.py, float32 and K <= 16 only), or
    # "auto" (triton on a GPU where it can run, dense elsewhere). Chosen
    # in one place, ops/lambda_pass.resolve_kernel.
    kernel: str = "auto"

    # Lambda handling. "local" (default): lambda is treated as the
    # local variable it is (SURVEY.md §1.2) — each minibatch's
    # coordinate ascent cold-starts from the Beta prior, nothing is
    # gathered/scattered from the (L, K, 2) array during stepping, and
    # validation/export lambdas are recomputed from the current gamma on
    # demand (always-converged — slightly better-calibrated heldout
    # scores). "stored": reference-style — warm-start from and scatter
    # back into the stored lambda array every step.
    lambda_mode: str = "local"

    # Init scale for gamma (reference inits gamma from a gsl rng [MED]).
    gamma_init_scale: float = 0.1

    # gamma initialization: "random" (reference behavior) or "spectral"
    # (svi/init.py - randomized-PCA + soft k-means warm start; cuts the
    # random-init wander phase without biasing the fixed point).
    init: str = "random"

    seed: int = 0
    label: str = "run"

    # Sharding (parallel/mesh.py): mesh axis sizes; 0 = auto.
    ind_shards: int = 0
    snp_shards: int = 0

    # Software-pipeline the sharded chunk runner: issue step t+1's
    # minibatch gather between step t's gamma all-reduce and the gamma
    # update that consumes it, so the (N/I, K) collective — the
    # collective whose size grows with N — can run asynchronously under
    # XLA's latency-hiding scheduler. EXACT: only
    # instruction order changes (pipelined == per-step bitwise,
    # tests/test_sharded.py). Off = per-step shard_map loop.
    comm_overlap: bool = True

    # Reduction dtype for the gamma natural-gradient statistic's
    # psum('snp') — the one collective whose payload is proportional to
    # N and independent of B. "bf16" halves the wire payload (partials
    # are rounded to bf16 and the reduction accumulates in bf16); the
    # engine path rounds the whole statistic once so single-device fits
    # share the semantics. The rounding (~2^-8 relative) sits far below
    # the 1/sqrt(B) minibatch noise the Robbins-Monro update already
    # averages over (tests/test_sharded.py quality test). Default stays
    # exact f32.
    gamma_psum_dtype: str = "f32"

    def __post_init__(self):
        if self.k <= 0:
            raise ValueError(f"k must be positive, got {self.k}")
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if self.gamma_psum_dtype not in ("f32", "bf16"):
            raise ValueError("gamma_psum_dtype must be 'f32' or 'bf16', "
                             f"got {self.gamma_psum_dtype!r}")

    @property
    def alpha_value(self) -> float:
        return (1.0 / self.k) if self.alpha is None else self.alpha

    def rho(self, t):
        """Robbins–Monro step size at iteration t (works on traced values)."""
        return (self.tau0 + t) ** (-self.kappa)

    # ---- run-dir convention (reference: Env creates n{N}-k{K}-l{L}-{label}/)
    def run_dir_name(self) -> str:
        return f"n{self.n}-k{self.k}-l{self.l}-{self.label}"

    def make_run_dir(self, base: str = ".") -> str:
        path = os.path.join(base, self.run_dir_name())
        os.makedirs(path, exist_ok=True)
        return path

    # ---- (de)serialization for checkpoints / CLI round-trips
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "SVIConfig":
        return cls(**json.loads(s))

    def replace(self, **kw) -> "SVIConfig":
        return dataclasses.replace(self, **kw)
