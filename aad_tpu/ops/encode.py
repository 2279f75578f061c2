"""Block encode engine: sequential block chain with trial search.

Encode cannot block-parallelise bit-exactly — processor state chains across
blocks and the trial search re-reads the previous block (reference:
src/aad_encoder.c:870, 502-512). The design therefore:

* scans over blocks sequentially (``lax.scan`` carrying the per-channel
  :class:`CodecState`),
* vectorises everything *inside* a block over channels (and, at the API
  layer, over independent streams via ``vmap`` — see parallel/),
* selects trial-search winners by exact integer comparison of summed
  *wrapped* squared quantisation errors, which provably reproduces the
  reference's double-precision RMSE comparison (see note below).

RMSE-comparison exactness: the reference compares
``sqrt(sse_a / n) > sqrt(sse_b / n)`` in IEEE double (reference:
src/aad_encoder.c:465,552) — but each accumulator term is the product of two
**int32** ``quantize_error`` fields (src/aad_encoder.c:459-461), which WRAPS
whenever qdiff**2 >= 2**31 (|qdiff| > 46340, reachable at max step size), so
the double sum is of wrapped signed int32 terms and can go negative (then
sqrt yields NaN and every comparison with it is false). Each wrapped term
has magnitude < 2**31 and n < 2**22, so the double adds are exact; division
by the shared n is monotone and sqrt is monotone & correctly rounded — so
the double comparison decides exactly like signed-integer comparison of the
wrapped sums with the NaN rule (``cseman.sse_better``). We accumulate sse as
two uint32 limbs (a two's-complement i64) to stay in native 32-bit lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..constants import FILTER_ORDER
from . import cseman as cs
from .transitions import CodecState, encode_sample

Array = jax.Array


class BlockHeaderFields(NamedTuple):
    """Per-block header payload produced by the encoder."""

    step_index: Array  # (..., C) int32
    shift: Array       # (..., C) int32 weight shift in [0, 15]
    weight: Array      # (..., C, 4) int32, already rounded (low bits cleared)
    history: Array     # (..., C, 4) int32


def _select_state(pred: Array, a: CodecState, b: CodecState) -> CodecState:
    """Elementwise state select; ``pred`` broadcasts over lane axes."""
    p1 = pred[..., None]
    return CodecState(
        history=jnp.where(p1, a.history, b.history),
        weight=jnp.where(p1, a.weight, b.weight),
        step_index=jnp.where(pred, a.step_index, b.step_index),
    )


def _seed_from_block(state: CodecState, block: Array) -> CodecState:
    """Load a block's first four samples into history (newest last-in).

    ``block`` is (..., C, nspb) already zero-padded, which reproduces the
    reference's memset + bounded copy for short blocks
    (reference: src/aad_encoder.c:588-616, 450-453).
    """
    head = block[..., :FILTER_ORDER].astype(jnp.int32)
    return state._replace(history=head[..., ::-1])


def _encode_span(
    state: CodecState, block: Array, valid: Array, bits_per_sample: int
):
    """Run the encode recurrence over a block's sample slots with lax.scan,
    freezing state/sse at ``valid`` samples.

    Returns (state', codes (..., T), sse limbs).
    """
    lane_shape = state.step_index.shape
    samples_t = jnp.moveaxis(block[..., FILTER_ORDER:], -1, 0)  # (T, ...)
    T = samples_t.shape[0]
    steps = jnp.arange(T, dtype=jnp.int32)

    def step(carry, xs):
        st, sse = carry
        sample, t = xs
        new_st, code, qdiff = encode_sample(st, sample, bits_per_sample)
        active = t < (valid - FILTER_ORDER)
        st2 = _select_state(jnp.broadcast_to(active, lane_shape), new_st, st)
        contrib = jnp.where(active, cs.wrapped_square(qdiff), jnp.int32(0))
        return (st2, cs.s64_add_i32(sse, contrib)), code

    init = (state, cs.u64_zero(lane_shape))
    (final_state, sse), codes_t = lax.scan(step, init, (samples_t, steps))
    return final_state, jnp.moveaxis(codes_t, 0, -1), sse


def measure_block(
    state: CodecState,
    block: Array,
    valid: Array,
    bits_per_sample: int,
) -> tuple[CodecState, tuple[Array, Array]]:
    """Trial-encode a block and accumulate squared quantisation error.

    Mirrors ``AADEncodeProcessor_CalculateRMSError`` (reference:
    src/aad_encoder.c:431-467): seeds history from the first four samples,
    encodes samples [4, valid), accumulates qdiff**2. Blocks with fewer than
    FILTER_ORDER valid samples leave the state untouched and report zero
    error (the reference's early return).

    Args:
      state: (...,) lanes of codec state.
      block: (..., nspb) int32 zero-padded samples.
      valid: scalar or (...) int32 — valid samples in this block.
    Returns:
      (state', (sse_hi, sse_lo)) with sse limbs shaped (...,).
    """
    lane_shape = state.step_index.shape
    seeded = _seed_from_block(state, block)
    final_state, _codes, sse = _encode_span(seeded, block, valid, bits_per_sample)
    skip = jnp.broadcast_to(valid < FILTER_ORDER, lane_shape)
    out_state = _select_state(skip, state, final_state)
    out_sse = cs.u64_select(skip, cs.u64_zero(lane_shape), sse)
    return out_state, out_sse


def search_best_state(
    state: CodecState,
    cur_block: Array,
    prev_block: Array,
    has_prev: Array,
    valid: Array,
    bits_per_sample: int,
    num_trials: int,
    warm_on_prev: bool = True,
) -> CodecState:
    """Trial search for the lowest-RMSE starting state, per channel.

    Re-encoding consecutive blocks warms the adaptive filter; the candidate
    with minimum RMSE on the current block wins, independently per channel
    (reference: src/aad_encoder.c:470-562).

    ``warm_on_prev=False`` statically elides the previous-block warm-up
    measure — the block-independent parallel mode, where every block is
    known to be a stream head (``has_prev`` false everywhere), so the warm
    pass would compute a discarded result. The selection math is unchanged:
    trials then warm on the current block itself, exactly the reference's
    first-block behaviour (src/aad_encoder.c:503).
    """
    # Baseline: the incoming state measured as-is (state change discarded).
    _, min_sse = measure_block(state, cur_block, valid, bits_per_sample)
    best = state
    tmp = state

    for _ in range(num_trials):
        if warm_on_prev:
            # Warm up on the previous block when one exists (full-length).
            nspb_full = jnp.asarray(cur_block.shape[-1], dtype=jnp.int32)
            warmed, _ = measure_block(tmp, prev_block, nspb_full, bits_per_sample)
            tmp = _select_state(
                jnp.broadcast_to(has_prev, tmp.step_index.shape), warmed, tmp
            )
        candidate = tmp
        tmp, sse = measure_block(tmp, cur_block, valid, bits_per_sample)
        better = cs.sse_better(sse, min_sse)
        best = _select_state(better, candidate, best)
        min_sse = cs.u64_select(better, sse, min_sse)

    return best


def round_weights(state: CodecState) -> tuple[CodecState, Array]:
    """Round weights so they serialise into 16 bits; returns (state', shift).

    Finds the smallest right shift putting max|weight| into int16 range,
    clears the shifted-out bits in place (keeping encoder and decoder in
    lockstep), per channel (reference: src/aad_encoder.c:620-646).
    """
    w = state.weight
    absw = jnp.where(w >= 0, w, -w)  # INT32_MIN wraps, matching C's ABS macro
    maxabs = jnp.max(absw, axis=-1)
    bitlen = 32 - lax.clz(maxabs)
    shift = jnp.maximum(bitlen - 15, 0).astype(jnp.int32)
    mask = jnp.bitwise_not(cs.shl(jnp.int32(1), shift) - 1)
    rounded = jnp.bitwise_and(w, mask[..., None])
    return state._replace(weight=rounded), shift


def encode_block_codes(
    state: CodecState, block: Array, bits_per_sample: int
) -> tuple[CodecState, Array]:
    """Encode one (zero-padded) block's data section.

    The reference packs whole interleave units and reads zero-padding past
    the valid count (reference: src/aad_encoder.c:588-594, 661-722); encoding
    the full padded block reproduces every byte that lands on the wire (the
    stream assembler drops the units past the final one).

    Args:
      state: (...,) lanes (history already seeded, weights rounded).
      block: (..., nspb) int32.
    Returns:
      (state', codes (..., T) int32).
    """
    nspb = jnp.asarray(block.shape[-1], dtype=jnp.int32)
    final_state, codes, _sse = _encode_span(state, block, nspb, bits_per_sample)
    return final_state, codes


def encode_stream_blocks(
    blocks: Array,
    valid: Array,
    bits_per_sample: int,
    num_trials: int,
    *,
    carry: tuple[CodecState, Array] | None = None,
    blocks_before: int | Array = 0,
) -> tuple[BlockHeaderFields, Array]:
    """Encode a stream of blocks sequentially.

    Args:
      blocks: (B, C, nspb) int32 zero-padded input (MS already applied).
      valid:  (B,) int32 valid sample counts.
      carry: optional (state, prev_block) from a previous chunk — the
        streaming continuation point. ``prev_block`` is the (C, nspb)
        transformed samples of the block immediately before this chunk.
      blocks_before: number of blocks already encoded (streaming); the trial
        search warms up on the previous block only from the stream's second
        block onward (reference: src/aad_encoder.c:503).
    Returns:
      (header fields (B, ...), codes (B, C, T) int32). Use
      :func:`encode_stream_blocks_carry` to also receive the carry-out.
    """
    headers, codes, _ = encode_stream_blocks_carry(
        blocks,
        valid,
        bits_per_sample,
        num_trials,
        carry=carry,
        blocks_before=blocks_before,
    )
    return headers, codes


def encode_stream_blocks_carry(
    blocks: Array,
    valid: Array,
    bits_per_sample: int,
    num_trials: int,
    *,
    carry: tuple[CodecState, Array] | None = None,
    blocks_before: int | Array = 0,
    warm_on_prev: bool = True,
):
    """As :func:`encode_stream_blocks`, returning (headers, codes, carry').

    ``blocks`` may carry extra leading lane axes, e.g. (B, S, C, nspb) for a
    lockstep stream batch. ``valid`` broadcasts over the lane axes. ``warm_on_prev=False``
    statically removes the trial search's previous-block warm-up passes
    (see :func:`search_best_state`; only correct when every block is a
    stream head, i.e. the parallel block-independent mode).
    """
    B, *lane_axes, nspb = blocks.shape
    if carry is None:
        init_state = CodecState.zeros(tuple(lane_axes))
        prev0 = jnp.zeros_like(blocks[0])
    else:
        init_state, prev0 = carry
    prev_blocks = jnp.concatenate([prev0[None], blocks[:-1]], axis=0)
    has_prev = jnp.arange(B) + jnp.asarray(blocks_before, jnp.int32) >= 1

    def block_step(state: CodecState, xs):
        cur, prev, hp, v = xs
        if num_trials > 0:
            state = search_best_state(
                state, cur, prev, hp, v, bits_per_sample, num_trials,
                warm_on_prev=warm_on_prev,
            )
        state = _seed_from_block(state, cur)
        state, shift = round_weights(state)
        hdr = BlockHeaderFields(
            step_index=state.step_index,
            shift=shift,
            weight=state.weight,
            history=state.history,
        )
        state, codes = encode_block_codes(state, cur, bits_per_sample)
        return state, (hdr, codes)

    final_state, (headers, codes) = lax.scan(
        block_step, init_state, (blocks, prev_blocks, has_prev, valid)
    )
    return headers, codes, (final_state, blocks[-1])


def encode_stream_words(
    blocks: Array,
    valid: Array,
    bits_per_sample: int,
    num_trials: int,
    *,
    carry: tuple[CodecState, Array] | None = None,
    blocks_before: int | Array = 0,
    warm_on_prev: bool = True,
    need_carry: bool = True,
):
    """As :func:`encode_stream_blocks_carry` but returning **packed** codes.

    Returns (headers, kernel words (B, ..., Wk) uint32, carry') where every
    u32 word holds 8 LSB-first 4-bit code slots (the decode kernel's code
    format, ops.wire32.pack_code_words). This is the wire pipeline's
    entry: ops.wire32.kernel_words_to_wire consumes the words directly, so
    the 8x nibble unpack/repack round trip of the int32-codes contract never
    happens.

    ``need_carry=False`` drops the final chain state; the carry slot of the
    return value is then ``None``.
    """
    headers, codes, carry_out = encode_stream_blocks_carry(
        blocks, valid, bits_per_sample, num_trials,
        carry=carry, blocks_before=blocks_before, warm_on_prev=warm_on_prev,
    )
    if not need_carry:
        carry_out = None
    from .wire32 import pack_code_words

    T = codes.shape[-1]
    kw = pack_code_words(codes.reshape(-1, T).astype(jnp.uint32))
    return headers, kw.reshape(*codes.shape[:-1], -1), carry_out


def encode_blocks_parallel(
    blocks: Array,
    valid: Array,
    bits_per_sample: int,
    num_trials: int,
    *,
    chunk_blocks: int = 1,
    warm_passes: int = 0,
):
    """Block-parallel encode: the block axis joins the lane axes.

    The device encode path the format admits but the reference never
    exploits: each block header carries the complete decoder state
    (reference: src/aad_decoder.c:363-380), so an encoder that treats a
    block as a *stream head* — exactly the reference's first-block
    semantics, trial search included (src/aad_encoder.c:503: the warm-up
    on the previous block only happens from block 1 on) — still emits a
    fully valid stream for any conforming decoder.

    Three quality/throughput knobs, all fully block-parallel:

    * ``chunk_blocks=1`` (default): every block is a stream head; output is
      byte-identical to concatenating independent single-block encodes.
      The sequential scan collapses to one step and ``warm_on_prev=False``
      statically removes the trial search's dead previous-block passes.
      Quality cost 1.04-1.7x RMSE vs sequential (content-dependent).
    * ``chunk_blocks=c > 1``: blocks encode sequentially *within* chunks of
      c (true sequential semantics including the previous-block trial
      warm-up) and in parallel *across* chunks — the chunks ride the lane
      axes like streams in a batch. Only the c-th of blocks at chunk heads
      lose their warm start; lanes shrink by c.
    * ``warm_passes=k > 0``: Jacobi refinement — each pass encodes all
      chunks (trials=0) and hands every chunk's final chain state to the
      *next* chunk as its initial state for the following pass. After k
      passes a chunk head starts from a predictor warmed on k*c
      predecessor blocks, converging on the sequential chain's quality
      while every pass stays fully parallel (states consumed are from the
      previous pass, never a same-pass neighbour).

    Args:
      blocks: (B, *lanes, nspb) int32 zero-padded (MS already applied).
      valid:  (B,) int32 valid sample counts (or broadcastable to lanes).
    Returns:
      (headers (B, *lanes), kernel words (B, *lanes, Wk) uint32).
    """
    c = max(int(chunk_blocks), 1)
    B = blocks.shape[0]
    lane_shape = blocks.shape[1:-1]
    Bp = -(-B // c) * c
    va = jnp.asarray(valid, jnp.int32)
    va = jnp.broadcast_to(
        va.reshape(va.shape + (1,) * (blocks.ndim - 1 - va.ndim)),
        (B, *lane_shape),
    )
    if Bp > B:
        # pad with valid=0 blocks (dropped by the caller's payload slice)
        pad = [(0, Bp - B)] + [(0, 0)] * (blocks.ndim - 1)
        blocks = jnp.pad(blocks, pad)
        va = jnp.pad(va, [(0, Bp - B)] + [(0, 0)] * (va.ndim - 1))
    G = Bp // c

    # (Bp, *lanes, X) -> (c, G, *lanes, X): scan step j handles block
    # g*c + j of chunk g.
    def to_chunks(x):
        return jnp.swapaxes(
            x.reshape(G, c, *x.shape[1:]), 0, 1
        )

    def from_chunks(x):  # inverse, then drop the pad blocks
        return jnp.swapaxes(x, 0, 1).reshape(Bp, *x.shape[2:])[:B]

    xs = to_chunks(blocks)
    vs = to_chunks(va)
    warm = c > 1  # chunk-internal previous-block trial warm-up

    carry = None
    for _ in range(warm_passes):
        st = parallel_warm_states(
            xs, vs, bits_per_sample, carry=carry, warm_on_prev=warm,
        )
        carry = (shift_chunk_states(st), jnp.zeros_like(xs[0]))

    headers, kw, _ = encode_stream_words(
        xs, vs, bits_per_sample, num_trials,
        warm_on_prev=warm, need_carry=False, carry=carry,
    )
    return jax.tree.map(from_chunks, headers), from_chunks(kw)


def encode_blocks_parallel_flat(
    blocks: Array,
    valid: Array,
    bits_per_sample: int,
    num_trials: int,
):
    """Folded-lane fast path of :func:`encode_blocks_parallel` (c=1 only).

    ``blocks`` is (L, nspb) int32 with every lane a stream head — the
    channel-major fold of (B, C, nspb) (all of channel 0's blocks first,
    matching the decode pipeline's lane order) — and ``valid`` is (L,).
    Semantically identical to ``encode_blocks_parallel(chunk_blocks=1)``
    on the unfolded array; the fold keeps each channel's blocks
    contiguous, matching the host's natural (C, N) staging.

    Returns (headers with (L,) leaves, (L, Wk) uint32 kernel words).
    """
    headers, kw, _ = encode_stream_words(
        blocks[None], jnp.asarray(valid, jnp.int32)[None],
        bits_per_sample, num_trials,
        warm_on_prev=False, need_carry=False,
    )
    return jax.tree.map(lambda x: x[0], headers), kw[0]


def parallel_warm_states(
    xs: Array,
    vs: Array,
    bits_per_sample: int,
    *,
    carry=None,
    warm_on_prev: bool = False,
) -> CodecState:
    """One Jacobi warm pass: per-chunk final chain states.

    ``xs``/``vs`` are chunked inputs, (c, G, *lanes[, nspb]) — scan step j
    handles block g*c+j of chunk g. Encodes every chunk with trials=0 from
    ``carry`` (or the initial state) and returns the state after each
    chunk's last block, leaves shaped (G, *lanes[, 4]). The sharded layer
    interleaves these passes with a ring handoff collective
    (parallel.sharded.encode_blocks_parallel_sharded).
    """
    _, _, (st, _) = encode_stream_blocks_carry(
        xs, vs, bits_per_sample, 0, carry=carry, warm_on_prev=warm_on_prev,
    )
    return st


def shift_chunk_states(st: CodecState, head: CodecState | None = None) -> CodecState:
    """Chunk g's init <- chunk g-1's final state; chunk 0 <- ``head`` or 0.

    ``head`` (leaves shaped like one chunk's lanes) is the ring-handoff
    slot: the previous *shard*'s last-chunk state in the sharded warm pass.
    """

    def shift(x, h):
        first = jnp.zeros_like(x[:1]) if h is None else h[None]
        return jnp.concatenate([first, x[:-1]], axis=0)

    return CodecState(
        history=shift(st.history, None if head is None else head.history),
        weight=shift(st.weight, None if head is None else head.weight),
        step_index=shift(
            st.step_index, None if head is None else head.step_index
        ),
    )


def lr_to_ms(pcm: Array) -> Array:
    """LR -> mid/side with the halving shift and int16 clips.

    (reference: src/aad_encoder.c:413-428). pcm: (..., 2, N) int32.
    """
    left = pcm[..., 0, :]
    right = pcm[..., 1, :]
    mid = cs.clip16(cs.asr(left + right, 1))
    side = cs.clip16(cs.asr(left - right, 1))
    return jnp.stack([mid, side], axis=-2)
