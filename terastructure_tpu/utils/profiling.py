"""Profiling/tracing utilities (SURVEY.md §5 aux subsystems).

The reference's only instrumentation is wall-clock logging to infer.log.
Here: a step-rate meter driven by the fit callback, and a jax.profiler
trace context for deep dives (view with TensorBoard or xprof).

    from terastructure_tpu.utils.profiling import StepMeter, trace
    meter = StepMeter(batch_size=cfg.batch_size)
    fit(cfg, data, callback=meter)          # meter(rec) per rfreq chunk
    print(meter.summary())

    with trace("/tmp/tera-trace"):          # jax.profiler trace
        run_chunk(state, packed)
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional


class StepMeter:
    """Tracks SNP-updates/s from the fit driver's per-check records."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.t0: Optional[float] = None
        self.last_step = 0
        self.last_time: Optional[float] = None
        self.rates: list[float] = []

    def __call__(self, rec: dict):
        now = time.time()
        if self.t0 is None:
            self.t0 = now - rec.get("wall_s", 0.0)
        if self.last_time is not None and rec["step"] > self.last_step:
            dt = now - self.last_time
            if dt > 0:
                self.rates.append(
                    (rec["step"] - self.last_step) * self.batch_size / dt)
        self.last_step = rec["step"]
        self.last_time = now

    @property
    def snp_updates_per_s(self) -> float:
        """Steady-state rate: median of the observed chunk rates."""
        if not self.rates:
            return float("nan")
        srt = sorted(self.rates)
        return srt[len(srt) // 2]

    def summary(self) -> dict:
        return {
            "snp_updates_per_s": self.snp_updates_per_s,
            "chunks": len(self.rates),
            "steps": self.last_step,
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context; a failure to trace raises."""
    import jax

    with jax.profiler.trace(log_dir):
        yield
