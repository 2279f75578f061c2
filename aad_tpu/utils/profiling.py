"""Profiling & throughput instrumentation.

The reference has no instrumentation at all (SURVEY.md §5); this module is
this framework's equivalent: ``jax.profiler`` trace capture around codec
calls plus a throughput meter whose methodology is robust against async
dispatch (on-device dependency chains, single-element materialisation — see
bench.py for the rationale).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/aad_tpu_trace"):
    """Capture a jax.profiler trace (view with TensorBoard/Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class ThroughputReport:
    samples_per_sec: float
    seconds_per_iter: float
    iters: int
    total_samples: int

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"{self.samples_per_sec / 1e9:.3f} Gsamples/s "
            f"({self.seconds_per_iter * 1e3:.2f} ms/iter, {self.iters} iters)"
        )


def measure_throughput(
    fn: Callable[[jax.Array], jax.Array],
    example: jax.Array,
    samples_per_call: int,
    iters: int = 10,
) -> ThroughputReport:
    """Robustly measure ``fn``'s throughput.

    ``fn`` must map a device array to a device array. Iterations are
    serialised by feeding one element of each output back into the next
    input on device, then a single scalar is materialised to close the
    chain — so asynchronous dispatch can neither overlap iterations away
    nor return before the work is done.
    """
    @jax.jit
    def stepped(x, tok):
        # One fused dispatch per iteration: perturb input by the previous
        # token, run fn, reduce to the next token.
        idx = (0,) * x.ndim
        x = x.at[idx].set((tok & 1).astype(x.dtype) + x[idx])
        out = fn(x)
        return jnp.ravel(out)[0].astype(jnp.int32)

    tok = stepped(example, jnp.int32(0))
    float(tok)  # warm-up + materialise

    t0 = time.time()
    for _ in range(iters):
        tok = stepped(example, tok)
    float(tok)
    dt = (time.time() - t0) / iters
    return ThroughputReport(
        samples_per_sec=samples_per_call / dt,
        seconds_per_iter=dt,
        iters=iters,
        total_samples=samples_per_call * iters,
    )
