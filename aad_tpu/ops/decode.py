"""Block decode engines.

Decode of one block factors into two phases (design: SURVEY.md §7.3):

* **Phase A (parallel)** — the step-index recurrence depends only on the code
  sequence through clipped adds, so all T step indices — and hence all step
  sizes and quantised differences — are computed with an associative scan in
  O(log T) depth, fully parallel across blocks x channels x time.
* **Phase B (sequential, tiny)** — the remaining LMS recurrence
  (predict -> clip -> weight update -> history shift) is ~15 int ops per
  sample with no table lookups, scanned over time and vmapped over the
  block x channel batch. Throughput comes from the batch axis: every block
  decodes independently (reference: src/aad_decoder.c:363-380).

Two interchangeable engines are provided, chosen by :func:`resolve_engine`:
  * ``scan``  — phase A and phase B in plain XLA (the portable reference)
  * ``fused`` — one GPU kernel for both phases (ops.pallas_decode)

Both are bit-exact with the reference decoder (reference:
src/aad_decoder.c:269-318, 321-475).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..constants import (
    FILTER_ORDER,
    FIXEDPOINT_0_5,
    FIXEDPOINT_DIGITS,
    LMSFILTER_SHIFT,
    STEP_INDEX_MAX,
)
from . import cseman as cs
from .transitions import quantized_diff, step_index_prefix, stepsize_from_index

Array = jax.Array


def compute_qdiffs(codes: Array, init_index: Array, bits_per_sample: int) -> Array:
    """Phase A: codes (..., T) + initial index (...) -> qdiff (..., T) int32."""
    idx_used = step_index_prefix(codes, init_index, bits_per_sample)
    stepsize = stepsize_from_index(idx_used)
    return quantized_diff(stepsize, codes, bits_per_sample)


def lms_scan(qdiffs: Array, history0: Array, weight0: Array) -> Array:
    """Phase B: sequential LMS reconstruction.

    Args:
      qdiffs:   (..., T) int32 quantised differences.
      history0: (..., 4) int32 initial history (newest first).
      weight0:  (..., 4) int32 initial weights.
    Returns:
      samples (..., T) int32.
    """

    def step(carry, qdiff):
        history, weight = carry
        pred = cs.asr(
            cs.i32(FIXEDPOINT_0_5) + jnp.sum(history * weight, axis=-1),
            FIXEDPOINT_DIGITS,
        )
        sample = cs.clip16(qdiff + pred)
        weight = weight + cs.asr(
            qdiff[..., None] * history + cs.i32(FIXEDPOINT_0_5),
            FIXEDPOINT_DIGITS + LMSFILTER_SHIFT,
        )
        history = jnp.concatenate(
            [sample[..., None], history[..., : FILTER_ORDER - 1]], axis=-1
        )
        return (history, weight), sample

    # scan over the time axis; batch axes ride along inside the carry.
    qdiffs_t = jnp.moveaxis(qdiffs, -1, 0)  # (T, ...)
    (_, _), samples_t = lax.scan(step, (history0, weight0), qdiffs_t)
    return jnp.moveaxis(samples_t, 0, -1)


def decode_blocks(
    codes: Array,
    step_index: Array,
    weight: Array,
    history: Array,
    *,
    bits_per_sample: int,
    engine: str = "auto",
) -> Array:
    """See :func:`_decode_blocks_impl`; resolves the engine first."""
    return _decode_blocks_impl(
        codes,
        step_index,
        weight,
        history,
        bits_per_sample=bits_per_sample,
        engine=resolve_engine(engine),
    )


@functools.partial(jax.jit, static_argnames=("bits_per_sample", "engine"))
def _decode_blocks_impl(
    codes: Array,
    step_index: Array,
    weight: Array,
    history: Array,
    *,
    bits_per_sample: int,
    engine: str,
) -> Array:
    """Decode a dense batch of independent block tasks.

    Args:
      codes:      (..., T) uint8/int codes (lane shape = blocks x channels ...).
      step_index: (...) int32 initial Q4 step index per lane.
      weight:     (..., 4) int32 initial weights per lane.
      history:    (..., 4) int32 initial history per lane (newest first).
      engine: "fused" (the GPU kernel, ops.pallas_decode),
        "fused_interpret" (the same kernel interpreted, for CPU tests) or
        "scan" (pure XLA; the portable reference engine).
    Returns:
      (..., T + FILTER_ORDER) int32 samples: the four header samples
      (history reversed, reference: src/aad_decoder.c:386-391) followed by the
      T decoded samples.
    """
    # Parse-clamp semantics for the codes-level API: wire indices in
    # (4080, 4095] — reachable only from malformed block headers; UB in
    # the reference — pin to the table maximum, matching every parse
    # point (format/framing.py, ops/wire32.py, native/aadx.cc).
    step_index = cs.clip(step_index, 0, STEP_INDEX_MAX)
    if engine in ("fused", "fused_interpret"):
        from .pallas_decode import decode_codes

        return decode_codes(
            codes, step_index, history, weight,
            bits_per_sample=bits_per_sample,
            interpret=engine == "fused_interpret",
        )
    if engine != "scan":
        raise ValueError(f"unknown decode engine: {engine}")
    qdiffs = compute_qdiffs(codes, step_index, bits_per_sample)
    body = lms_scan(qdiffs, history, weight)
    head = history[..., ::-1]
    return jnp.concatenate([head, body], axis=-1)


def resolve_engine(
    engine: str = "auto", *, direction: str = "decode", native: str = "never"
) -> str:
    """The one place an engine is chosen: (platform, API, engine) -> engine.

    ``direction`` is "decode" (engines "fused", "scan") or "encode"
    ("scan"). ``native`` says when the API may serve "auto" from the
    native host engine (aad_tpu.native) — "never" (JAX pipelines:
    Decoder, Encoder, the sharded APIs), "off_gpu" (the batch and
    parallel-mode APIs: the device on a GPU, the host elsewhere) or
    "always" (the one-shot decode() and sequential encode(), whose
    latency a host engine serves best). APIs that accept
    ``engine="native"`` pass a ``native`` other than "never".

    On a GPU "auto" picks the device engines: the fused kernel for
    decode, the scan engine for encode. Elsewhere it picks the native
    engine where allowed and available, else "scan". The fused kernel
    is refused off the GPU, and its interpreted form
    ("fused_interpret", for CPU tests) on the GPU. Unknown names raise.
    """
    device = {"decode": ("fused", "scan"), "encode": ("scan",)}[direction]
    allowed = set(device)
    if direction == "decode":
        allowed.add("fused_interpret")
    if native != "never":
        allowed.add("native")
    on_gpu = jax.default_backend() == "gpu"
    if engine == "auto":
        if native == "always" or (native == "off_gpu" and not on_gpu):
            from .. import native as _native

            if _native.available():
                return "native"
        return device[0] if on_gpu else "scan"
    if engine not in allowed:
        raise ValueError(
            f"unknown {direction} engine {engine!r}; expected one of "
            f"{sorted(allowed | {'auto'})}"
        )
    if engine == "fused" and not on_gpu:
        raise ValueError("engine='fused' needs a GPU; use 'scan' (or "
                         "'fused_interpret' in tests)")
    if engine == "fused_interpret" and on_gpu:
        raise ValueError("engine='fused_interpret' is for CPU tests; "
                         "use 'fused' on the GPU")
    if engine == "native":
        from .. import native as _native

        if not _native.available():
            raise RuntimeError("native codec unavailable")
    return engine


def ms_to_lr(samples: Array) -> Array:
    """Mid/side -> left/right with int16 clips.

    samples: (..., 2, N) with mid on channel 0, side on channel 1
    (reference: src/aad_decoder.c:458-470).
    """
    mid = samples[..., 0, :]
    side = samples[..., 1, :]
    left = cs.clip16(mid + side)
    right = cs.clip16(mid - side)
    return jnp.stack([left, right], axis=-2)
