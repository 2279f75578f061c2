"""Word-space (u32) wire pipeline: payload bytes -> kernel code words.

The device pipeline works on u32 words, never on bytes: the host
reinterprets the payload as little-endian u32 words (a free ``numpy``
view), so the device moves four codes' worth of bits per element:

    host:   payload bytes --view--> (B, words_per_block) uint32
    device: headers  = static single-word shift/mask extractions
            code words = one compact u32 transpose (time-major) followed by
            shift/mask permutations whose stride-2/-3 deinterleaves all land
            on the *major* axis (row slices)

The output feeds the fused decode kernel's packed-word format directly
(8 LSB-first 4-bit code slots per u32 — ops.pallas_decode), so no u8 tensor
ever exists on device. The time-major layout makes each kernel word load
coalesce across lanes. Wire layout facts: reference src/aad_decoder.c:394-455
(data region), src/aad_decoder.c:363-380 (block header).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import FILTER_ORDER, STEP_INDEX_MAX, TABLES_FLOAT_DIGITS
from ..format.geometry import BlockGeometry

__all__ = [
    "supports_wire32",
    "words_per_block",
    "payload_to_words",
    "payload_to_words_split",
    "block_rows_to_words_split",
    "header_words",
    "parse_block_headers_u32",
    "wire_to_kernel_words",
    "data_to_kernel_words",
    "kernel_words_to_codes",
    "pack_code_words",
    "kernel_words_to_wire",
    "build_header_words",
    "assemble_wire_words",
    "wire_words_to_payload",
]


def supports_wire32(geo: BlockGeometry) -> bool:
    """Every conforming geometry: 2/3/4-bit x mono/stereo."""
    return geo.bits_per_sample in (2, 3, 4) and geo.num_channels in (1, 2)


def _deinterleave_factor(geo: BlockGeometry) -> int:
    """Row-group size of the wire word pattern (see wire_to_kernel_words)."""
    if geo.bits_per_sample == 3:
        return 3
    if geo.bits_per_sample == 4 and geo.num_channels == 2:
        return 2
    return 1


def data_words_padded(geo: BlockGeometry) -> int:
    """Data-region word count, padded so every downstream shape is aligned.

    Rounded so that (a) the deinterleave reshape divides evenly and (b) the
    per-channel kernel word count is a multiple of a 32-word granule.
    Doing this padding host-side (zero bytes in the row buffer) keeps
    whole-array pad passes out of the device pipeline.
    """
    wd = -(-geo.data_bytes // 4)
    k = _deinterleave_factor(geo)
    # kernel words produced per k-word group of data words:
    nch, bps = geo.num_channels, geo.bits_per_sample
    if bps == 4:
        per_group = 1                              # k=2 -> 1/ch; k=1 -> 1
    elif bps == 2:
        per_group = 2 if nch == 1 else 1          # k=1
    else:  # bps == 3, k=3
        per_group = 2 if nch == 2 else 4
    # Exact fit first: when the per-channel kernel word count can be made
    # exactly nspb/8, the decode kernel's head-integrated output has zero
    # pad rows and needs no final sample slice.
    nspb = geo.num_samples_per_block
    if nspb % 8 == 0:
        wk_exact = nspb // 8  # = (T + 4) / 8: exactly the 4-slot head slack
        if wk_exact % per_group == 0 and wk_exact // per_group * k >= wd:
            return wk_exact // per_group * k
    # Otherwise: align kernel words per channel to a 32-word granule.
    groups = -(-wd // k)
    g_align = -(-32 // per_group)
    groups = -(-groups // g_align) * g_align
    # The fused kernel emits the 4 header samples inline ahead of the code
    # samples (2 packed words), so the padded code capacity must exceed the
    # code count by >= 4 slots or the final samples would be shifted out.
    while 8 * groups * per_group - geo.codes_per_block < 4:
        groups += g_align
    return groups * k


def words_per_block(geo: BlockGeometry) -> int:
    """u32 words per (host-padded) block row.

    Covers the header + the alignment-padded data region, plus a spare word
    guarding the cross-word funnel shift when the header size is not 4-byte
    aligned (mono: 18 bytes).
    """
    base, rem = divmod(geo.header_bytes, 4)
    return base + (1 if rem else 0) + data_words_padded(geo)


def payload_to_words(
    payload: np.ndarray, geo: BlockGeometry, num_blocks: int
) -> np.ndarray:
    """Host: payload bytes -> (num_blocks, words_per_block) uint32 (LE).

    Zero-pads the (possibly short) final block. The reinterpret is a numpy
    view — no byte tensor is ever shipped to the device.
    """
    wpb = words_per_block(geo)
    buf = np.zeros((num_blocks, wpb * 4), dtype=np.uint8)
    src = np.asarray(payload, dtype=np.uint8).reshape(-1)
    n = min(src.shape[0], num_blocks * geo.block_size)
    full, rem = divmod(n, geo.block_size)
    buf[:full, : geo.block_size] = src[: full * geo.block_size].reshape(
        full, geo.block_size
    )
    if rem:
        buf[full, :rem] = src[full * geo.block_size :][:rem]
    return buf.view("<u4").reshape(num_blocks, wpb)


def header_words(geo: BlockGeometry) -> int:
    """u32 words covering one block's headers (ceil(header_bytes / 4))."""
    return -(-geo.header_bytes // 4)


def block_rows_to_words_split(
    rows: np.ndarray, geo: BlockGeometry, num_blocks: int
) -> tuple[np.ndarray, np.ndarray]:
    """Host: (N, block_size) byte rows -> (hdr, data) u32 word arrays.

    ``hdr`` is (num_blocks, header_words(geo)); ``data`` is
    (num_blocks, data_words_padded(geo)) with the data region re-based to
    byte offset 0 — so the device pipeline never pays the misaligned
    minor-axis slice that carving the data out of whole-block rows costs,
    and the mono header (18 B, not 4-byte aligned) needs no cross-word
    funnel shift at all. Rows beyond ``rows``
    are zero (decoded as pad garbage and sliced away by the callers).
    """
    hb = geo.header_bytes
    Hw = header_words(geo)
    Wd = data_words_padded(geo)
    k = _deinterleave_factor(geo)
    n = min(rows.shape[0], num_blocks)
    hbuf = np.zeros((num_blocks, Hw * 4), dtype=np.uint8)
    dbuf = np.zeros((num_blocks, Wd * 4), dtype=np.uint8)
    hbuf[:n, :hb] = rows[:n, :hb]
    dbuf[:n, : geo.block_size - hb] = rows[:n, hb:]
    # Data ships as (B, G, k) — the deinterleave grouping baked into the
    # host view — so the device pipeline starts from the exact shape its
    # 3-D transpose wants.
    return (
        hbuf.view("<u4").reshape(num_blocks, Hw),
        dbuf.view("<u4").reshape(num_blocks, Wd // k, k),
    )


def payload_to_words_split(
    payload: np.ndarray, geo: BlockGeometry, num_blocks: int
) -> tuple[np.ndarray, np.ndarray]:
    """Host: payload bytes -> aligned (hdr, data) u32 word arrays.

    The split counterpart of :func:`payload_to_words` — see
    :func:`block_rows_to_words_split` for the layout rationale.
    """
    src = np.asarray(payload, dtype=np.uint8).reshape(-1)
    n = min(src.shape[0], num_blocks * geo.block_size)
    full, rem = divmod(n, geo.block_size)
    rows = src[: full * geo.block_size].reshape(full, geo.block_size)
    if rem:
        tail = np.zeros((1, geo.block_size), dtype=np.uint8)
        tail[0, :rem] = src[full * geo.block_size :][:rem]
        rows = np.concatenate([rows, tail], axis=0) if full else tail
    return block_rows_to_words_split(rows, geo, num_blocks)


def _u16be_at(words: jax.Array, byte_off: int) -> jax.Array:
    """Big-endian u16 at a static even byte offset, from one u32 column."""
    assert byte_off % 2 == 0
    w = words[:, byte_off >> 2].astype(jnp.int32)
    s = (byte_off & 3) * 8
    return (((w >> s) & 0xFF) << 8) | ((w >> (s + 8)) & 0xFF)


def _sign16(x: jax.Array) -> jax.Array:
    return jnp.where(x >= 0x8000, x - 0x10000, x)


def parse_block_headers_u32(words: jax.Array, geo: BlockGeometry):
    """Block-header state load from u32 wire words.

    Same fields as format.framing.parse_block_headers (reference:
    src/aad_decoder.c:363-380) but every u16BE field is a single-column
    shift/mask — all header byte offsets are even, so no field straddles a
    u32 word. Returns a BlockStates with (B, C[, 4]) int32 leaves.
    """
    from ..format.framing import BlockStates

    nch = geo.num_channels
    per_ch = 2 + 4 * FILTER_ORDER
    # One small contiguous slice up front: the 18-36 header bytes live in the
    # first few words; extracting columns from the full array instead makes
    # XLA stream the whole payload per field.
    words = words[:, : -(-geo.header_bytes // 4)]
    step_index, weights, histories = [], [], []
    for ch in range(nch):
        base = ch * per_ch
        tag = _u16be_at(words, base)
        # Parse-clamp malformed 12-bit indices in (4080, 4095] to the
        # table maximum — the framework-defined semantics for the
        # reference's UB case (see format/framing.py::parse_block_headers)
        step_index.append(jnp.minimum(tag >> TABLES_FLOAT_DIGITS,
                                      STEP_INDEX_MAX))
        shift = tag & 0xF
        w_taps, h_taps = [], []
        for k in range(FILTER_ORDER):
            w_taps.append(_sign16(_u16be_at(words, base + 2 + 4 * k)) << shift)
            h_taps.append(_sign16(_u16be_at(words, base + 4 + 4 * k)))
        weights.append(jnp.stack(w_taps, axis=-1))
        histories.append(jnp.stack(h_taps, axis=-1))
    return BlockStates(
        step_index=jnp.stack(step_index, axis=-1).astype(jnp.int32),
        weight=jnp.stack(weights, axis=-2).astype(jnp.int32),
        history=jnp.stack(histories, axis=-2).astype(jnp.int32),
    )


def _data_words(words: jax.Array, geo: BlockGeometry) -> jax.Array:
    """(B, wpb) row words -> (B, Wdp) realigned data-region words.

    Word i covers data bytes 4i..4i+3 (zero-padded past the block end by the
    host buffer). When the header size is not 4-byte aligned the realignment
    is a two-shift funnel across adjacent words.
    """
    base, rem = divmod(geo.header_bytes, 4)
    Wd = data_words_padded(geo)
    if rem == 0:
        return words[:, base : base + Wd]
    lo = words[:, base : base + Wd]
    hi = words[:, base + 1 : base + 1 + Wd]
    s = 8 * rem
    return ((lo >> s) | (hi << (32 - s))).astype(jnp.uint32)


def _nibble_swap(x: jax.Array) -> jax.Array:
    m = jnp.uint32(0x0F0F0F0F)
    return ((x >> 4) & m) | ((x & m) << 4)


def _expand3(v: jax.Array) -> jax.Array:
    """24-bit MSB-first 3-bit octet -> u32 of 8 LSB-first 4-bit slots."""
    out = jnp.zeros_like(v)
    for k in range(8):
        out = out | (((v >> (21 - 3 * k)) & 0x7) << (4 * k))
    return out


def _expand2_byte(b: jax.Array) -> jax.Array:
    """One byte of 4 MSB-first 2-bit codes -> 16 bits of 4-bit slots."""
    return (
        ((b >> 6) & 0x3)
        | (((b >> 4) & 0x3) << 4)
        | (((b >> 2) & 0x3) << 8)
        | ((b & 0x3) << 12)
    )


def _interleave_rows(parts: list[jax.Array]) -> jax.Array:
    """k arrays (G, B) -> (k*G, B) with rows interleaved (time order)."""
    if len(parts) == 1:
        return parts[0]
    return jnp.stack(parts, axis=1).reshape(-1, parts[0].shape[1])


def kernel_words_padded(geo: BlockGeometry) -> int:
    """Per-channel kernel word count produced by wire_to_kernel_words.

    A multiple of the 32-word granule (guaranteed by data_words_padded)
    or the exact fit; the pad slots decode garbage past codes_per_block
    that the final sample slice drops.
    """
    nch, bps = geo.num_channels, geo.bits_per_sample
    wd = data_words_padded(geo)
    if bps == 4:
        return wd // 2 if nch == 2 else wd
    if bps == 2:
        return wd if nch == 2 else 2 * wd
    return 2 * wd // 3 if nch == 2 else 4 * wd // 3


def wire_to_kernel_words(words: jax.Array, geo: BlockGeometry) -> jax.Array:
    """(B, wpb) wire words -> (Wk, C*B) time-major kernel code words.

    Lane order is channel-major (all blocks of channel 0, then channel 1),
    matching the decode pipeline; Wk = kernel_words_padded(geo) (codes past
    codes_per_block are pad garbage). The single large relayout is one 3-D
    transpose of the data region whose trailing reshape axis makes every
    stride-k row deinterleave a *free major-axis slice*.
    """
    assert supports_wire32(geo)
    return data_to_kernel_words(_data_words(words, geo), geo)


def data_to_kernel_words(dw: jax.Array, geo: BlockGeometry) -> jax.Array:
    """Aligned data-region words -> (Wk, C*B) time-major kernel words.

    The body of :func:`wire_to_kernel_words` for a pre-split data array
    (host: payload_to_words_split) — no misaligned row slice, no funnel
    shift. ``dw`` is (B, G, k) with the deinterleave grouping staged
    host-side (a (B, Wd) 2-D array is accepted for the whole-row
    compatibility path and reshaped here).
    """
    assert supports_wire32(geo)
    nch, bps = geo.num_channels, geo.bits_per_sample
    k = _deinterleave_factor(geo)
    if dw.ndim == 2:
        dw = dw.reshape(dw.shape[0], dw.shape[1] // k, k)
    if k == 1:
        groups = (dw[:, :, 0].T.astype(jnp.uint32),)
    else:
        dT = jnp.transpose(dw, (2, 1, 0)).astype(jnp.uint32)  # (k, G, B)
        groups = tuple(dT[i] for i in range(k))  # free major slices
    ff = jnp.uint32(0xFF)

    if bps == 4:
        if nch == 1:
            chans = [[_nibble_swap(groups[0])]]
        else:
            a, b = groups
            ch0 = (
                (a & ff)
                | (((a >> 16) & ff) << 8)
                | ((b & ff) << 16)
                | (((b >> 16) & ff) << 24)
            )
            ch1 = (
                ((a >> 8) & ff)
                | (((a >> 24) & ff) << 8)
                | (((b >> 8) & ff) << 16)
                | (((b >> 24) & ff) << 24)
            )
            chans = [[_nibble_swap(ch0)], [_nibble_swap(ch1)]]
    elif bps == 2:
        dwT = groups[0]
        if nch == 1:
            lo = _expand2_byte(dwT & ff) | (_expand2_byte((dwT >> 8) & ff) << 16)
            hi = _expand2_byte((dwT >> 16) & ff) | (
                _expand2_byte((dwT >> 24) & ff) << 16
            )
            chans = [[lo, hi]]
        else:
            ch0 = _expand2_byte(dwT & ff) | (
                _expand2_byte((dwT >> 16) & ff) << 16
            )
            ch1 = _expand2_byte((dwT >> 8) & ff) | (
                _expand2_byte((dwT >> 24) & ff) << 16
            )
            chans = [[ch0], [ch1]]
    else:  # bps == 3: 3-byte (24-bit, 8-code) units; 12-byte period = 3 words
        g0, g1, g2 = groups
        vA = ((g0 & ff) << 16) | (((g0 >> 8) & ff) << 8) | ((g0 >> 16) & ff)
        vB = (((g0 >> 24) & ff) << 16) | ((g1 & ff) << 8) | ((g1 >> 8) & ff)
        vC = (((g1 >> 16) & ff) << 16) | (((g1 >> 24) & ff) << 8) | (g2 & ff)
        vD = (((g2 >> 8) & ff) << 16) | (((g2 >> 16) & ff) << 8) | (
            (g2 >> 24) & ff
        )
        if nch == 1:
            chans = [[_expand3(vA), _expand3(vB), _expand3(vC), _expand3(vD)]]
        else:
            chans = [[_expand3(vA), _expand3(vC)], [_expand3(vB), _expand3(vD)]]

    per_ch = [_interleave_rows(parts) for parts in chans]
    return jnp.concatenate(per_ch, axis=1) if len(per_ch) > 1 else per_ch[0]


def pack_code_words(codes: jax.Array, num_words: int | None = None) -> jax.Array:
    """(L, T) codes (<= 4 bits each) -> (L, W) u32 words, LSB-first.

    ``W`` defaults to ceil(T / 8); a larger ``num_words`` zero-pads.
    """
    L, T = codes.shape
    W = -(-T // 8) if num_words is None else num_words
    c = jnp.pad(codes.astype(jnp.uint32), ((0, 0), (0, W * 8 - T)))
    c = c.reshape(L, W, 8)
    word = c[..., 0]
    for k in range(1, 8):  # unrolled or-chain fuses into one pass
        word = word | (c[..., k] << (4 * k))
    return word


def kernel_words_to_codes(kw: jax.Array, num_codes: int) -> jax.Array:
    """(..., Wk) kernel words -> (..., num_codes) uint8 codes (any engine).

    XLA unpack of the packed-slot format; used to feed the scan engine and
    to test the wire permutation without the fused kernel.
    """
    parts = [((kw >> (4 * k)) & 0xF).astype(jnp.uint8) for k in range(8)]
    codes = jnp.stack(parts, axis=-1).reshape(*kw.shape[:-1], -1)
    return codes[..., :num_codes]


# --- encode direction: kernel code words -> wire words -----------------------
# The exact inverses of the decode-direction permutations above, so the whole
# encoder output (block headers + channel-interleaved pack units) is
# assembled as u32 words on device and the host's only job is a free byte
# view plus the final-block truncation. Wire layout facts:
# reference src/aad_encoder.c:618-655 (block header write),
# src/aad_encoder.c:661-722 (per-bit-depth pack loops).


def _compress2_16(x: jax.Array) -> jax.Array:
    """16 bits of 4 LSB-first 4-bit slots -> one MSB-first 2-bit-code byte
    (inverse of _expand2_byte)."""
    return (
        ((x & 0x3) << 6)
        | (((x >> 4) & 0x3) << 4)
        | (((x >> 8) & 0x3) << 2)
        | ((x >> 12) & 0x3)
    )


def _compress3(v: jax.Array) -> jax.Array:
    """u32 of 8 LSB-first 4-bit slots -> 24-bit MSB-first 3-bit octet
    (inverse of _expand3)."""
    out = jnp.zeros_like(v)
    for k in range(8):
        out = out | (((v >> (4 * k)) & 0x7) << (21 - 3 * k))
    return out


def kernel_words_needed(geo: BlockGeometry) -> int:
    """Per-channel kernel words consumed by kernel_words_to_wire."""
    nch, bps = geo.num_channels, geo.bits_per_sample
    wd = data_words_padded(geo)
    k = _deinterleave_factor(geo)
    groups = wd // k
    if bps == 4:
        return groups
    if bps == 2:
        return groups if nch == 2 else 2 * groups
    return 2 * groups if nch == 2 else 4 * groups


def _deinterleave_words(kw: jax.Array, n: int) -> tuple[jax.Array, ...]:
    """(..., n*G) -> n arrays (..., G), row-interleave inverse (time order)."""
    if n == 1:
        return (kw,)
    g = kw.reshape(*kw.shape[:-1], kw.shape[-1] // n, n)
    return tuple(g[..., i] for i in range(n))


def kernel_words_to_wire(
    kw: jax.Array, geo: BlockGeometry, *, channel_axis: int | None = None
) -> jax.Array:
    """(..., C, Wk) kernel code words -> (..., Wd) wire data words.

    Exact inverse of :func:`wire_to_kernel_words` (verified against
    pack_codes by the conformance suite). ``Wk`` is padded/sliced to
    :func:`kernel_words_needed`; code slots past codes_per_block land in
    bytes past ``geo.data_bytes``, which the caller's block-size slice
    drops, so their (garbage) content never reaches the wire.

    ``channel_axis`` selects where the channel axis sits; the default
    ``None`` is the legacy (..., C, Wk) form. The folded-lane pipelines
    pass 0 ((C, ..., Wk), block-parallel) or 1 ((B, C, ..., Wk), batch) —
    any position above the minor dims makes each channel's words a
    contiguous slice.
    """
    assert supports_wire32(geo)
    nch, bps = geo.num_channels, geo.bits_per_sample
    need = kernel_words_needed(geo)
    have = kw.shape[-1]
    if have < need:
        pad = [(0, 0)] * (kw.ndim - 1) + [(0, need - have)]
        kw = jnp.pad(kw, pad)
    elif have > need:
        kw = kw[..., :need]
    kw = kw.astype(jnp.uint32)
    if channel_axis is None:
        chans = [kw[..., c, :] for c in range(nch)]
    else:
        chans = [
            jax.lax.index_in_dim(kw, c, axis=channel_axis, keepdims=False)
            for c in range(nch)
        ]
    ff = jnp.uint32(0xFF)
    k = _deinterleave_factor(geo)

    if bps == 4:
        if nch == 1:
            return _nibble_swap(chans[0])
        c0 = _nibble_swap(chans[0])
        c1 = _nibble_swap(chans[1])
        a = (
            (c0 & ff)
            | ((c1 & ff) << 8)
            | (((c0 >> 8) & ff) << 16)
            | (((c1 >> 8) & ff) << 24)
        )
        b = (
            ((c0 >> 16) & ff)
            | (((c1 >> 16) & ff) << 8)
            | (((c0 >> 24) & ff) << 16)
            | (((c1 >> 24) & ff) << 24)
        )
        groups = (a, b)
    elif bps == 2:
        if nch == 1:
            lo, hi = _deinterleave_words(chans[0], 2)
            groups = (
                _compress2_16(lo & 0xFFFF)
                | (_compress2_16(lo >> 16) << 8)
                | (_compress2_16(hi & 0xFFFF) << 16)
                | (_compress2_16(hi >> 16) << 24),
            )
        else:
            c0, c1 = chans
            groups = (
                _compress2_16(c0 & 0xFFFF)
                | (_compress2_16(c1 & 0xFFFF) << 8)
                | (_compress2_16(c0 >> 16) << 16)
                | (_compress2_16(c1 >> 16) << 24),
            )
    else:  # bps == 3
        if nch == 1:
            vA, vB, vC, vD = (
                _compress3(p) for p in _deinterleave_words(chans[0], 4)
            )
        else:
            pA, pC = _deinterleave_words(chans[0], 2)
            pB, pD = _deinterleave_words(chans[1], 2)
            vA, vB, vC, vD = (_compress3(p) for p in (pA, pB, pC, pD))
        g0 = (
            ((vA >> 16) & ff)
            | (((vA >> 8) & ff) << 8)
            | ((vA & ff) << 16)
            | (((vB >> 16) & ff) << 24)
        )
        g1 = (
            ((vB >> 8) & ff)
            | ((vB & ff) << 8)
            | (((vC >> 16) & ff) << 16)
            | (((vC >> 8) & ff) << 24)
        )
        g2 = (
            (vC & ff)
            | (((vD >> 16) & ff) << 8)
            | (((vD >> 8) & ff) << 16)
            | ((vD & ff) << 24)
        )
        groups = (g0, g1, g2)

    if k == 1:
        return groups[0]
    return jnp.stack(groups, axis=-1).reshape(*chans[0].shape[:-1], -1)


def _swap16(v: jax.Array) -> jax.Array:
    """u16 value -> its big-endian byte pair as a little-endian u16."""
    return ((v >> 8) & jnp.uint32(0xFF)) | ((v & jnp.uint32(0xFF)) << 8)


def build_header_words(
    step_index, shift, weight, history, geo: BlockGeometry,
    *, channel_leading: bool = False,
):
    """Header fields -> list of (...,) u16 field values (big-endian content).

    Field order per channel: tag = (step_index << 4) | shift, then
    (weight >> shift, history) per tap — the exact byte layout of
    format.framing.build_block_headers (reference: src/aad_encoder.c:618-655).
    Leaves shaped (..., C[, 4]) like BlockHeaderFields. Returned as a plain
    list (not a stacked array): assemble_wire_words pairs the fields into
    words directly, with no stride-2 re-slicing of a stacked minor axis.

    The channel/tap axes are moved to the FRONT once before any extraction:
    the per-(ch, tap) reads then become free leading-axis slices.
    """
    if channel_leading:
        # inputs already (C, ...) / (C, ..., 4) — the folded-lane layout;
        # only the tap axis moves behind the channel axis.
        si_cf = step_index.astype(jnp.uint32)
        sh_cf = shift.astype(jnp.int32)
        w_cf = jnp.moveaxis(weight, -1, 1).astype(jnp.int32)
        h_cf = jnp.moveaxis(history, -1, 1).astype(jnp.uint32)
    else:
        si_cf = jnp.moveaxis(step_index, -1, 0).astype(jnp.uint32)  # (C, ...)
        sh_cf = jnp.moveaxis(shift, -1, 0).astype(jnp.int32)        # (C, ...)
        w_cf = jnp.moveaxis(weight, (-2, -1), (0, 1)).astype(jnp.int32)
        h_cf = jnp.moveaxis(history, (-2, -1), (0, 1)).astype(jnp.uint32)
    tag = (si_cf << TABLES_FLOAT_DIGITS) | (sh_cf.astype(jnp.uint32) & 0xF)
    wv = ((w_cf >> sh_cf[:, None]).astype(jnp.uint32)) & 0xFFFF   # (C, 4, ...)
    hv = h_cf & 0xFFFF
    fields = []
    for ch in range(geo.num_channels):
        fields.append(tag[ch])
        for k in range(FILTER_ORDER):
            fields.append(wv[ch, k])
            fields.append(hv[ch, k])
    return fields  # 9*C scalars-per-lane fields


def assemble_wire_words(hdr_fields, data_words, geo: BlockGeometry) -> jax.Array:
    """9*C header u16 fields + (..., Wd) data words -> (..., wpb) u32 rows.

    The exact inverse of the payload_to_words + parse/_data_words split:
    header u16s pack big-endian into the row's first header_bytes, the data
    words follow, funnel-shifted across word boundaries when header_bytes
    is not 4-byte aligned (mono: 18 bytes).
    """
    rem = geo.header_bytes % 4
    hu = [f.astype(jnp.uint32) for f in hdr_fields]
    dw = data_words.astype(jnp.uint32)
    n16 = len(hu)
    # whole header words: u16 pairs (2i, 2i+1), each byte-swapped
    hw = jnp.stack(
        [
            _swap16(hu[2 * i]) | (_swap16(hu[2 * i + 1]) << 16)
            for i in range(n16 // 2)
        ],
        axis=-1,
    )
    if rem == 0:
        return jnp.concatenate([hw, dw], axis=-1)
    # rem == 2: the last header u16 shares a word with data bytes 0..1
    assert rem == 2 and n16 % 2 == 1
    mid = _swap16(hu[-1]) | ((dw[..., 0] & 0xFFFF) << 16)
    # data word i spills its high half into the next row word:
    # rows base+1 .. base+wd: (D_{i-1} >> 16) | (D_i << 16); the final row
    # (the spare word of words_per_block) is D_{wd-1} >> 16 alone.
    lo = dw >> 16
    body = lo[..., :-1] | ((dw[..., 1:] & 0xFFFF) << 16)
    tail = lo[..., -1:]
    return jnp.concatenate([hw, mid[..., None], body, tail], axis=-1)


def wire_words_to_payload(
    words: np.ndarray, geo: BlockGeometry, num_samples: int
) -> np.ndarray:
    """Host: (B, wpb) u32 rows -> contiguous payload bytes (uint8).

    A free little-endian byte view, a block_size row slice (dropping the
    alignment padding), and the reference's final-block truncation to whole
    interleave units (reference: src/aad_encoder.c:661-726 loop bounds).
    """
    from ..format.geometry import (
        encoded_block_bytes,
        last_block_valid_samples,
        num_blocks_for,
    )

    rows = np.ascontiguousarray(words).astype("<u4", copy=False).view(np.uint8)
    rows = rows.reshape(words.shape[0], -1)[:, : geo.block_size]
    nblocks = num_blocks_for(num_samples, geo.num_samples_per_block)
    rows = rows[:nblocks]
    valid_last = last_block_valid_samples(
        num_samples, geo.num_samples_per_block
    )
    tail_bytes = encoded_block_bytes(geo, valid_last)
    return np.concatenate(
        [rows[: nblocks - 1].reshape(-1), rows[nblocks - 1, :tail_bytes]]
    )
