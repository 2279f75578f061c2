"""Fused decode kernel for the GPU: code words -> samples in one launch.

Pallas through Triton (``backend="triton"``). The whole per-sample decode
recurrence (reference: src/aad_decoder.c:269-318) — step-index
adaptation, step-size lookup, quantised-difference reconstruction and the
LMS filter — runs in one kernel:

* one program owns ``LANE_BLOCK`` independent (block, channel) lanes, one
  lane per thread, and keeps each lane's decoder state in registers;
* time is a ``fori_loop`` over the lane's packed code words inside the
  program (8 LSB-first 4-bit code slots per u32 word, the layout
  ``ops.wire32.data_to_kernel_words`` produces time-major, so every word
  load coalesces across the lane block). The next word is loaded before
  the current one decodes, so the load latency hides behind the chain;
* the 256-entry step-size table is read from memory (it stays in L1);
  the <= 16-entry index-delta table is a short select chain;
* the four header samples are emitted inline ahead of the code samples,
  so each lane's output is exactly its block's ``nspb`` samples, stored
  two int16 per u32 word (LSB first), time-major so stores coalesce; one
  XLA transpose turns them into lane-major int16 rows.

The work is integer only; all arithmetic is int32 with C wraparound.
Interpret mode (``interpret=True``) runs the same kernel on the CPU for
the tests; it is never chosen implicitly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..constants import (
    FIXEDPOINT_0_5,
    FIXEDPOINT_DIGITS,
    INT16_MAX,
    INT16_MIN,
    LMSFILTER_SHIFT,
    STEP_INDEX_MAX,
    TABLES_FLOAT_0_5,
    TABLES_FLOAT_DIGITS,
)
from ..tables import INDEX_TABLES, STEPSIZE_TABLE
from .wire32 import pack_code_words

# Lanes per program (one per thread) and warps per program.
LANE_BLOCK = 128
NUM_WARPS = 4


def check_platform(interpret: bool) -> None:
    """The compiled kernel needs a GPU; interpret mode needs anything else."""
    platform = jax.default_backend()
    if interpret and platform == "gpu":
        raise ValueError("the fused decode kernel is compiled on the GPU; "
                         "interpret mode is for CPU tests only")
    if not interpret and platform != "gpu":
        raise ValueError(f"the fused decode kernel needs a GPU, found "
                         f"{platform!r}; use engine='scan' or, in tests, "
                         "engine='fused_interpret'")


def _delta_select(mag: jax.Array, bits_per_sample: int) -> jax.Array:
    """Index-delta lookup as a select chain on the magnitude bits.

    ``mag`` is code & absmask (sign bit stripped; the tables mirror, so the
    delta ignores it — reference: src/aad_tables.c:8-45).
    """
    tab = [int(v) for v in INDEX_TABLES[bits_per_sample][: 2 ** (bits_per_sample - 1)]]
    if bits_per_sample == 4:
        # [-18, -17, -14, 16, 32, 64, 128, 256]: entries 3.. are
        # 16 << (mag - 3), and mag - 18 + (mag & 2) gives the low three.
        assert tab[:3] == [-18, -17, -14]
        low = mag - 18 + (mag & 2)
        high = jnp.left_shift(jnp.int32(16), jnp.maximum(mag - 3, 0))
        return jnp.where(mag < 3, low, high)
    out = jnp.full_like(mag, tab[-1])
    for m in range(len(tab) - 2, -1, -1):
        out = jnp.where(mag == m, jnp.int32(tab[m]), out)
    return out


def _decode_word(word, state, table_ref, bits_per_sample: int):
    """Decode the 8 code slots of one word; returns (8 samples, state)."""
    signbit = 1 << (bits_per_sample - 1)
    absmask = signbit - 1
    wshift = FIXEDPOINT_DIGITS + LMSFILTER_SHIFT
    half = jnp.int32(FIXEDPOINT_0_5)

    h0, h1, h2, h3, w0, w1, w2, w3, idx = state
    outs = []
    for k in range(8):
        code = (word >> (4 * k)) & 0xF
        mag = code & absmask

        # idx stays in [0, 4080]: every header parse clamps the 12-bit wire
        # field before the kernel, so the slot is always inside the table.
        stepsize = table_ref[(idx + TABLES_FLOAT_0_5) >> TABLES_FLOAT_DIGITS]

        # quantised difference (reference: src/aad_decoder.c:284-288)
        qmag = (stepsize * ((mag << 1) + 1)) >> (bits_per_sample - 1)
        qdiff = jnp.where((code & signbit) != 0, -qmag, qmag)

        # index adaptation (reference: src/aad_tables.h:31-43)
        idx = jnp.clip(idx + _delta_select(mag, bits_per_sample), 0, STEP_INDEX_MAX)

        # LMS reconstruction (reference: src/aad_decoder.c:291-315)
        pred = (half + h0 * w0 + h1 * w1 + h2 * w2 + h3 * w3) >> FIXEDPOINT_DIGITS
        s = jnp.clip(qdiff + pred, INT16_MIN, INT16_MAX)
        w0 = w0 + ((qdiff * h0 + half) >> wshift)
        w1 = w1 + ((qdiff * h1 + half) >> wshift)
        w2 = w2 + ((qdiff * h2 + half) >> wshift)
        w3 = w3 + ((qdiff * h3 + half) >> wshift)
        h3, h2, h1, h0 = h2, h1, h0, s
        outs.append(s)
    return outs, (h0, h1, h2, h3, w0, w1, w2, w3, idx)


def _pack_pair(lo_s, hi_s):
    """Two int16-valued samples -> one u32 output word (LSB-first)."""
    return ((hi_s << 16) | (lo_s & 0xFFFF)).astype(jnp.uint32)


def _make_kernel(bits_per_sample: int, n_words: int):
    """Kernel over one lane block: time-major (n_words, LB) words in,
    time-major (4 * n_words, LB) sample-pair words out."""

    def kernel(words_ref, idx_ref, hist_ref, wgt_ref, table_ref, out_ref):
        h = [hist_ref[k, :] for k in range(4)]
        w = [wgt_ref[k, :] for k in range(4)]
        state = (*h, *w, idx_ref[:])
        # header samples, oldest first (reference: src/aad_decoder.c:386-391)
        out_ref[0, :] = _pack_pair(h[3], h[2])
        out_ref[1, :] = _pack_pair(h[1], h[0])

        def step(i, carry):
            word, state = carry
            nxt = words_ref[jnp.minimum(i + 1, n_words - 1), :]
            outs, state = _decode_word(word, state, table_ref, bits_per_sample)
            for j in range(4):
                out_ref[4 * i + 2 + j, :] = _pack_pair(outs[2 * j], outs[2 * j + 1])
            return nxt, state

        word, state = lax.fori_loop(
            0, n_words - 1, step, (words_ref[0, :], state)
        )
        # The head shifts the output two rows: the last word's final four
        # slots fall past the buffer and are pad by construction.
        outs, _ = _decode_word(word, state, table_ref, bits_per_sample)
        out_ref[4 * n_words - 2, :] = _pack_pair(outs[0], outs[1])
        out_ref[4 * n_words - 1, :] = _pack_pair(outs[2], outs[3])

    return kernel


@functools.partial(
    jax.jit, static_argnames=("num_out", "bits_per_sample", "interpret")
)
def decode_words(
    words_tm: jax.Array,
    step_index: jax.Array,
    history: jax.Array,
    weight: jax.Array,
    *,
    num_out: int,
    bits_per_sample: int,
    interpret: bool = False,
) -> jax.Array:
    """Time-major code words + per-lane state -> packed sample words.

    Args:
      words_tm: (W, L) uint32, 8 LSB-first 4-bit code slots per word,
        lane l's codes in column l. ``8 * W >= num_out`` (room for the
        four inline header samples).
      step_index: (L,) int32 in [0, 4080]; history/weight: (L, 4) int32.
      num_out: samples kept per lane (``nspb``, even).
    Returns:
      (L, num_out) int16: lane l's header samples then its decoded codes.
    """
    check_platform(interpret)
    W, L = words_tm.shape
    if num_out % 2 or 8 * W < num_out:
        raise ValueError(f"{W} code words cannot hold {num_out} samples")
    Lp = -(-L // LANE_BLOCK) * LANE_BLOCK
    pad = Lp - L

    def lanes_last(x):  # (L[, 4]) -> ([4,] Lp), lane axis minor and padded
        x = x.astype(jnp.int32).reshape(L, -1).T
        return jnp.pad(x, ((0, 0), (0, pad)))

    words = jnp.pad(words_tm.astype(jnp.uint32), ((0, 0), (0, pad)))
    idx = lanes_last(step_index)[0]
    table = jnp.asarray(STEPSIZE_TABLE, jnp.int32)
    lane = lambda i: (0, i)
    out = pl.pallas_call(
        _make_kernel(bits_per_sample, W),
        grid=(Lp // LANE_BLOCK,),
        in_specs=[
            pl.BlockSpec((W, LANE_BLOCK), lane),
            pl.BlockSpec((LANE_BLOCK,), lambda i: (i,)),
            pl.BlockSpec((4, LANE_BLOCK), lane),
            pl.BlockSpec((4, LANE_BLOCK), lane),
            pl.BlockSpec((table.shape[0],), lambda i: (0,)),
        ],
        out_specs=pl.BlockSpec((4 * W, LANE_BLOCK), lane),
        out_shape=jax.ShapeDtypeStruct((4 * W, Lp), jnp.uint32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="aad_decode",
    )(words, idx, lanes_last(history), lanes_last(weight), table)
    # Each word holds two little-endian int16 samples, so the bitcast of
    # the lane-major words is the int16 sample rows.
    pairs = lax.bitcast_convert_type(out[: num_out // 2, :L].T, jnp.int16)
    return pairs.reshape(L, num_out)


def decode_codes(
    codes: jax.Array,
    step_index: jax.Array,
    history: jax.Array,
    weight: jax.Array,
    *,
    bits_per_sample: int,
    interpret: bool = False,
) -> jax.Array:
    """codes (..., T) + per-lane state -> (..., T + 4) int32 samples.

    The codes-level entry (ops.decode.decode_blocks): header samples first,
    as the scan engine returns them.
    """
    lane_shape, T = codes.shape[:-1], codes.shape[-1]
    L = 1
    for d in lane_shape:
        L *= d
    n_out = T + 4 + (T % 2)
    words = pack_code_words(codes.reshape(L, T), -(-n_out // 8))
    samples = decode_words(
        words.T, step_index.reshape(L), history.reshape(L, 4),
        weight.reshape(L, 4), num_out=n_out,
        bits_per_sample=bits_per_sample, interpret=interpret,
    )
    return samples[:, : T + 4].astype(jnp.int32).reshape(*lane_shape, T + 4)
