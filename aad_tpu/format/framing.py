"""Stream framing: .aad payload bytes <-> dense per-block tensors.

This is the boundary the device design revolves around. Every block header
carries the complete decoder state (reference: src/aad_decoder.c:363-380), so
a stream factors into a *dense batch of independent block-decode tasks*:

    payload bytes --split--> blocks[B, block_size] u8
                  --parse--> BlockStates (step_index/weights/history [B, C, ...])
                  +          codes[B, C, T] u8

All parsing is vectorised integer arithmetic (no per-block Python loops) and
works on numpy or jnp arrays, so it can run host-side or on device under jit.
The final (possibly short) block is zero-padded into the dense batch; a
valid-sample count per block masks the tail on assembly.

Layout facts (reference: Appendix B of SURVEY.md; writer
src/aad_encoder.c:618-655, reader src/aad_decoder.c:363-380): per channel the
block header is u16BE ``(step_index << 4) | weight_shift`` then 4 x
{u16BE weight >> shift, u16BE history}; history[0] is the newest sample and
the decoder emits history[3-i] as output samples 0..3.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..codec.result import InsufficientDataError
from ..constants import (
    FILE_HEADER_SIZE,
    FILTER_ORDER,
    STEP_INDEX_MAX,
    TABLES_FLOAT_DIGITS,
)
from ..format.geometry import (
    BlockGeometry,
    encoded_block_bytes,
    encoded_stream_size,
    last_block_valid_samples,
    num_blocks_for,
)
from ..format.header import HeaderInfo
from ..ops.bitpack import pack_codes, unpack_codes


class BlockStates(NamedTuple):
    """Decoder-visible state snapshot carried by each block header."""

    step_index: "np.ndarray"  # (B, C) int32, Q4 in [0, 4080]
    weight: "np.ndarray"      # (B, C, 4) int32 (shift already re-applied)
    history: "np.ndarray"     # (B, C, 4) int32 (int16-valued)


class FramedStream(NamedTuple):
    """A stream exploded into dense device-ready tensors."""

    states: BlockStates
    codes: "np.ndarray"        # (B, C, T) uint8
    num_blocks: int
    valid_last: int            # valid samples in the final block


def _xp(a):
    return np if isinstance(a, np.ndarray) else jnp


def _u16be(b, offset):
    """Vectorised big-endian u16 read at a fixed offset of each block row."""
    xp = _xp(b)
    hi = b[..., offset].astype(xp.int32)
    lo = b[..., offset + 1].astype(xp.int32)
    return (hi << 8) | lo


def _sign16(x):
    xp = _xp(x)
    return xp.where(x >= 0x8000, x - 0x10000, x)


def split_blocks(payload: np.ndarray, header: HeaderInfo, geo: BlockGeometry):
    """Split the post-header payload into a dense (B, block_size) u8 batch.

    The final block is zero-padded to ``block_size``. Returns
    (blocks, num_blocks, valid_last).
    """
    nspb = header.num_samples_per_block
    nblocks = num_blocks_for(header.num_samples, nspb)
    valid_last = last_block_valid_samples(header.num_samples, nspb)
    # Strict: the full wire size declared by the header must be present
    # (trailing garbage beyond it is tolerated — the stream is
    # self-delimiting by num_samples). The reference decoder instead decodes
    # whatever prefix is present and silently returns a zero tail
    # (src/aad_decoder.c:514-534) — a data-loss footgun this framework
    # deliberately rejects, matching the native engine (tests/test_native.py).
    need = encoded_stream_size(geo, header.num_samples)
    if payload.shape[-1] < need:
        raise InsufficientDataError(
            f"payload holds {payload.shape[-1]} bytes; "
            f"{need} required for {nblocks} blocks"
        )
    total = nblocks * geo.block_size
    xp = _xp(payload)
    padded = xp.zeros(total, dtype=xp.uint8)
    n = min(payload.shape[-1], total)
    if xp is np:
        padded[:n] = payload[:n]
    else:
        padded = padded.at[:n].set(payload[:n])
    return padded.reshape(nblocks, geo.block_size), nblocks, valid_last


def parse_block_headers(blocks, geo: BlockGeometry) -> BlockStates:
    """Vectorised block-header state load (reference: src/aad_decoder.c:363-380)."""
    xp = _xp(blocks)
    nch = geo.num_channels
    per_ch = 2 + 4 * FILTER_ORDER  # 18 bytes

    step_index = []
    weights = []
    histories = []
    for ch in range(nch):
        base = ch * per_ch
        tag = _u16be(blocks, base)
        # Parse-clamp: the 12-bit wire field reaches (4080, 4095] only on
        # malformed streams (slot 256, out of the step table — UB in the
        # reference, src/aad_tables.h:28); every engine pins those to
        # 4080 at header parse so adversarial input cannot diverge them.
        step_index.append(xp.minimum(tag >> TABLES_FLOAT_DIGITS,
                                     STEP_INDEX_MAX))
        shift = tag & 0xF
        w_taps, h_taps = [], []
        for k in range(FILTER_ORDER):
            w_raw = _sign16(_u16be(blocks, base + 2 + 4 * k))
            h_raw = _sign16(_u16be(blocks, base + 4 + 4 * k))
            # Weights were stored >> shift; re-apply the shift on load
            # (reference: src/aad_decoder.c:375-376).
            w_taps.append(w_raw << shift)
            h_taps.append(h_raw)
        weights.append(xp.stack(w_taps, axis=-1))
        histories.append(xp.stack(h_taps, axis=-1))

    return BlockStates(
        step_index=xp.stack(step_index, axis=-1).astype(xp.int32),
        weight=xp.stack(weights, axis=-2).astype(xp.int32),
        history=xp.stack(histories, axis=-2).astype(xp.int32),
    )


def frame_stream(payload, header: HeaderInfo, geo: BlockGeometry) -> FramedStream:
    """payload bytes -> (states, codes) dense batch."""
    blocks, nblocks, valid_last = split_blocks(payload, header, geo)
    states = parse_block_headers(blocks, geo)
    data = blocks[:, geo.header_bytes : geo.header_bytes + geo.data_bytes]
    codes = unpack_codes(data, geo)
    return FramedStream(states, codes, nblocks, valid_last)


def build_block_headers(states: BlockStates, shifts, geo: BlockGeometry):
    """Serialise per-block header bytes from states + per-channel weight shifts.

    ``states.weight`` must already be rounded (low ``shift`` bits cleared) by
    the encoder (reference: src/aad_encoder.c:637-641). Returns
    (B, header_bytes) uint8.
    """
    xp = _xp(states.step_index)
    parts = []
    for ch in range(geo.num_channels):
        shift = shifts[..., ch].astype(xp.int32)
        tag = ((states.step_index[..., ch] << TABLES_FLOAT_DIGITS) | (shift & 0xF))
        fields = [tag]
        for k in range(FILTER_ORDER):
            fields.append((states.weight[..., ch, k] >> shift) & 0xFFFF)
            fields.append(states.history[..., ch, k] & 0xFFFF)
        u16s = xp.stack(fields, axis=-1).astype(xp.uint32)  # (B, 1+8)
        b = xp.stack([(u16s >> 8) & 0xFF, u16s & 0xFF], axis=-1)
        parts.append(b.reshape(*b.shape[:-2], -1))
    out = xp.concatenate(parts, axis=-1).astype(xp.uint8)
    return out


def assemble_stream(
    header_bytes_arr,
    codes,
    geo: BlockGeometry,
    num_samples: int,
) -> "np.ndarray":
    """(B, header_bytes) + (B, C, T) codes -> contiguous payload bytes.

    The final block is truncated to whole interleave units covering its valid
    samples (reference: src/aad_encoder.c:661-726 loop bounds + EncodeWhole's
    write_size accounting).
    """
    xp = _xp(header_bytes_arr)
    data = pack_codes(codes, geo)  # (B, data_bytes)
    full = xp.concatenate([header_bytes_arr, data], axis=-1)  # (B, block_size)
    nblocks = full.shape[0]
    valid_last = last_block_valid_samples(num_samples, geo.num_samples_per_block)
    tail_bytes = encoded_block_bytes(geo, valid_last)
    flat = full[: nblocks - 1].reshape(-1)
    tail = full[nblocks - 1, :tail_bytes]
    return xp.concatenate([flat, tail], axis=0)


def block_sample_counts(header: HeaderInfo) -> np.ndarray:
    """Valid sample count per block, shape (B,)."""
    nspb = header.num_samples_per_block
    nblocks = num_blocks_for(header.num_samples, nspb)
    counts = np.full(nblocks, nspb, dtype=np.int32)
    counts[-1] = last_block_valid_samples(header.num_samples, nspb)
    return counts


def payload_offset() -> int:
    return FILE_HEADER_SIZE
