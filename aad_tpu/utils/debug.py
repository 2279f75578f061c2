"""Debug-mode invariant checking.

The reference's hot loops are laced with asserts that only compile in under
``-DDEBUG`` (reference: src/aad_internal.h:51-56, e.g. bounds asserts at
src/aad_decoder.c:402-403). The equivalent here: a validation pass over the
dense stream tensors (cheap, vectorised, jit-compatible via checkify-style
host checks) that the codec layer runs when debug mode is enabled.

Enable with ``aad_tpu.utils.debug.enable()`` or the AAD_TPU_DEBUG env var.
"""

from __future__ import annotations

import os

import numpy as np

from ..codec.result import InvalidFormatError
from ..constants import STEP_INDEX_MAX
from ..format.geometry import BlockGeometry

_enabled = bool(int(os.environ.get("AAD_TPU_DEBUG", "0")))


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def check_framed_stream(states, codes, geo: BlockGeometry) -> None:
    """Validate a framed stream's invariants (debug mode only).

    Mirrors the reference's in-loop asserts: codes within bit-depth range is
    structural here (unpack masks), so the checks cover the state snapshot
    ranges loaded from block headers.
    """
    if not _enabled:
        return
    si = np.asarray(states.step_index)
    if si.min(initial=0) < 0 or si.max(initial=0) > STEP_INDEX_MAX:
        raise InvalidFormatError(
            f"block header step index out of range [0, {STEP_INDEX_MAX}]"
        )
    h = np.asarray(states.history)
    if h.min(initial=0) < -32768 or h.max(initial=0) > 32767:
        raise InvalidFormatError("block header history outside int16 range")
    c = np.asarray(codes)
    maxcode = (1 << geo.bits_per_sample) - 1
    if c.max(initial=0) > maxcode:
        raise InvalidFormatError("code exceeds bit depth")  # pragma: no cover


def check_pcm_range(pcm) -> None:
    """Encoder input must be int16-valued (reference asserts this when
    seeding history, src/aad_encoder.c:612)."""
    if not _enabled:
        return
    p = np.asarray(pcm)
    if p.size and (p.min() < -32768 or p.max() > 32767):
        raise InvalidFormatError("encoder input exceeds int16 range")
