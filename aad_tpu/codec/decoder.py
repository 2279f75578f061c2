"""High-level decoder: .aad bytes -> PCM.

The pipeline (reference behaviour: src/aad_decoder.c:478-538, re-architected
for an accelerator):

    bytes --host--> header + dense block batch (format.framing)
          --device--> phase A + phase B decode over all blocks in parallel
          --device--> MS->LR, block concatenation, tail truncation

Unlike the reference's sequential while-loop over blocks, every
block x channel task decodes independently (the block header carries full
state), so the whole file is one batched device computation.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import CH_PROCESS_MS, FILE_HEADER_SIZE, FILTER_ORDER
from ..format.framing import FramedStream, frame_stream
from ..format.geometry import BlockGeometry, geometry_from_header
from ..format.header import HeaderInfo, decode_header, validate_header
from .result import InvalidArgumentError
from ..ops.decode import decode_blocks, ms_to_lr
from ..ops.pallas_decode import LANE_BLOCK


@functools.partial(
    jax.jit, static_argnames=("bits_per_sample", "ms", "num_samples", "engine")
)
def _decode_device(
    codes,
    step_index,
    weight,
    history,
    *,
    bits_per_sample: int,
    ms: bool,
    num_samples: int,
    engine: str,
):
    """Device side: (B, C, T) codes + per-block states -> (C, num_samples) PCM."""
    samples = decode_blocks(
        codes,
        step_index,
        weight,
        history,
        bits_per_sample=bits_per_sample,
        engine=engine,
    )  # (B, C, 4 + T)
    if ms:
        samples = ms_to_lr(samples)
    # (B, C, S) -> (C, B*S) -> truncate ragged tail
    pcm = jnp.swapaxes(samples, 0, 1).reshape(samples.shape[1], -1)
    return pcm[:, :num_samples]


def _device_pipeline(
    payload,
    *,
    geo: BlockGeometry,
    num_blocks: int,
    bits_per_sample: int,
    ms: bool,
    num_samples: int,
    engine: str,
):
    """Whole decode on device: padded payload bytes -> (C, num_samples) PCM.

    Every stage — block split, header parse, bit unpack, phase A/B decode,
    MS->LR, concatenation — is tensor ops under one jit, so entire files
    decode without per-sample host round-trips.
    ``payload`` must be zero-padded to ``num_blocks * geo.block_size`` bytes.
    """
    from ..format.framing import parse_block_headers
    from ..ops.bitpack import unpack_codes

    blocks = payload.reshape(num_blocks, geo.block_size)
    states = parse_block_headers(blocks, geo)
    data = blocks[:, geo.header_bytes : geo.header_bytes + geo.data_bytes]
    # Channel-major lane order: transposing (B, C, ...) -> (C, B, ...) here
    # moves whole contiguous rows (cheap); the final (C, B, S) -> (C, B*S)
    # flatten is then a free reshape instead of a 4-byte-granular relayout.
    si = jnp.swapaxes(states.step_index, 0, 1)
    wt = jnp.swapaxes(states.weight, 0, 1)
    hi = jnp.swapaxes(states.history, 0, 1)
    codes = unpack_codes(data, geo)
    samples = decode_blocks(
        jnp.swapaxes(codes, 0, 1),
        si,
        wt,
        hi,
        bits_per_sample=bits_per_sample,
        engine=engine,
    )  # (C, B, 4 + T)
    if ms:
        from ..ops import cseman as cs

        mid, side = samples[0], samples[1]
        samples = jnp.stack(
            [cs.clip16(mid + side), cs.clip16(mid - side)], axis=0
        )
    pcm = samples.reshape(samples.shape[0], -1)
    return pcm[:, :num_samples]


def _device_pipeline_words(
    hdr_words,
    data_words,
    *,
    geo: BlockGeometry,
    num_blocks: int,
    bits_per_sample: int,
    ms: bool,
    engine: str,
):
    """Whole decode on device from u32 wire words (no u8 tensors anywhere).

    ``hdr_words``/``data_words`` are the host-split aligned uint32 views
    (ops.wire32.payload_to_words_split): headers (num_blocks, header_words)
    and the re-based data region (num_blocks, data_words_padded). Header
    parse is single-column shift/masks; the code permutation transposes
    once in compact word space into the time-major words the fused kernel
    reads.

    Returns the samples flat, int16, lane-major with all of channel 0's
    blocks first: the stream is already channel-concatenated, so the caller
    reinterprets it as (C, B*nspb) with a free host-side view.
    """
    from ..ops import cseman as cs
    from ..ops.wire32 import (
        data_to_kernel_words,
        kernel_words_to_codes,
        parse_block_headers_u32,
    )

    C = geo.num_channels
    B = num_blocks
    T = geo.codes_per_block
    states = parse_block_headers_u32(hdr_words, geo)
    si = states.step_index.T.reshape(C * B)
    wt = jnp.swapaxes(states.weight, 0, 1).reshape(C * B, 4)
    hi = jnp.swapaxes(states.history, 0, 1).reshape(C * B, 4)

    kw = data_to_kernel_words(data_words, geo)  # (Wk, C*B) time-major
    if engine in ("fused", "fused_interpret"):
        from ..ops.pallas_decode import decode_words

        # The kernel emits the 4 header samples inline, so its rows are
        # complete nspb-sample blocks.
        samples = decode_words(
            kw, si, hi, wt, num_out=T + 4, bits_per_sample=bits_per_sample,
            interpret=engine == "fused_interpret",
        )
    else:
        from ..ops.decode import compute_qdiffs, lms_scan

        codes = kernel_words_to_codes(kw.T, T)
        qdiffs = compute_qdiffs(codes, si, bits_per_sample)
        body = lms_scan(qdiffs, hi, wt)
        samples = jnp.concatenate(
            [hi[:, ::-1], body], axis=-1
        ).astype(jnp.int16)  # (C*B, nspb); int16-valued by format
    if ms:
        # Recombine in int32 (mid +/- side overflows int16), write int16.
        flat16 = samples.reshape(-1)
        half = flat16.size // 2
        mid = flat16[:half].astype(jnp.int32)
        side = flat16[half:].astype(jnp.int32)
        return jnp.concatenate(
            [cs.clip16(mid + side), cs.clip16(mid - side)]
        ).astype(jnp.int16)
    return samples.reshape(-1)


# Lane blocks of the fused kernel (ops.pallas_decode.LANE_BLOCK) per chunk
# of the transfer-overlap decode: 16 blocks of 128 lanes = 2048 lanes.
_OVERLAP_CHUNK_LANE_BLOCKS = 16


def _lane_multiple(geo: BlockGeometry) -> int:
    """Blocks per fused-kernel lane block (C * blocks fill it exactly)."""
    return max(1, LANE_BLOCK // geo.num_channels)


def _overlap_chunk_blocks(geo: BlockGeometry) -> int:
    """Default chunk size for the transfer-overlap decode pipeline.

    A whole number of the fused kernel's lane blocks, so no chunk pads
    lanes; a FIXED chunk size means every file length shares one compiled
    chunk pipeline (the whole-stream path needs O(log) bucketed compiles
    instead).
    """
    return _OVERLAP_CHUNK_LANE_BLOCKS * _lane_multiple(geo)


def _bucket_blocks(n: int) -> int:
    """Round a block count up to a geometric bucket (~1.3x steps).

    Bounds wasted decode work to <=30% while collapsing the per-file-length
    jit-compile explosion to O(log) shapes.
    """
    if n <= 8:
        return n
    bucket = 8
    while bucket < n:
        bucket = max(bucket + 1, int(bucket * 1.3))
    return bucket


_device_pipeline_jit = jax.jit(
    _device_pipeline,
    static_argnames=(
        "geo",
        "num_blocks",
        "bits_per_sample",
        "ms",
        "num_samples",
        "engine",
    ),
)

_device_pipeline_words_jit = jax.jit(
    _device_pipeline_words,
    static_argnames=(
        "geo",
        "num_blocks",
        "bits_per_sample",
        "ms",
        "engine",
    ),
)


@functools.partial(jax.jit, static_argnames=("nb_padded",))
def _pad_blocks(hdr_w, data_w, *, nb_padded: int):
    """Zero-pad the wire-word block rows to the bucketed count on device.

    The upload-side mirror of :func:`_trim_lanes`: the host ships only the
    real blocks' words and the bucket padding (zero rows, decoded to garbage
    that the trim drops) materialises on device, so no padding crosses the
    host link.
    """
    def pad0(x):
        spec = [(0, nb_padded - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, spec)

    return pad0(hdr_w), pad0(data_w)


@functools.partial(jax.jit, static_argnames=("channels", "nb_padded", "nb"))
def _trim_lanes(lanes, *, channels: int, nb_padded: int, nb: int):
    """Drop bucket-padding blocks on device before the host transfer.

    The pipeline output is lane-major with each channel's padded block run
    contiguous ((C, nb_padded, per-block elements) once reshaped), so the
    real blocks are a static leading slice per channel. The padding is up
    to ~30% of the bytes at a bucket step; the slice is one device copy.
    A tiny per-length slice kernel compile is the price; the heavy decode
    pipeline itself stays on O(log) bucketed shapes.
    """
    per = lanes.size // (channels * nb_padded)
    return lanes.reshape(channels, nb_padded, per)[:, :nb].reshape(-1)


@dataclasses.dataclass
class Decoder:
    """Reusable decoder bound to one stream configuration.

    Mirrors the reference's create/set-header/decode lifecycle
    (reference: src/aad_decoder.h:14-42) but is stateless across calls —
    block independence means there is nothing to carry.
    """

    header: HeaderInfo
    geometry: BlockGeometry
    engine: str = "auto"

    @classmethod
    def from_header(cls, header: HeaderInfo, engine: str = "auto") -> "Decoder":
        """``engine``: "auto" (the fused kernel on a GPU, else scan),
        "fused", "scan" or, in CPU tests, "fused_interpret"."""
        from ..ops.decode import resolve_engine

        validate_header(header)
        geo = geometry_from_header(
            header.num_channels, header.bits_per_sample, header.block_size
        )
        return cls(header=header, geometry=geo, engine=resolve_engine(engine))

    def frame(self, payload: np.ndarray) -> FramedStream:
        """Host-side framing of the post-header payload bytes."""
        framed = frame_stream(payload, self.header, self.geometry)
        from ..utils import debug

        if debug.enabled():
            debug.check_framed_stream(framed.states, framed.codes, self.geometry)
        return framed

    def decode_framed(self, framed: FramedStream) -> jax.Array:
        """Decode a pre-framed stream; returns (C, num_samples) int32."""
        h = self.header
        return _decode_device(
            jnp.asarray(framed.codes),
            jnp.asarray(framed.states.step_index),
            jnp.asarray(framed.states.weight),
            jnp.asarray(framed.states.history),
            bits_per_sample=h.bits_per_sample,
            ms=h.ch_process_method == CH_PROCESS_MS,
            num_samples=h.num_samples,
            engine=self.engine,
        )

    def decode_payload(self, payload: np.ndarray) -> jax.Array:
        return self.decode_framed(self.frame(payload))

    def decode_payload_ondevice(
        self,
        payload,
        bucket: bool = True,
        strict: bool = True,
        overlap_blocks: int | None = None,
    ):
        """Fully fused on-device decode (bitstream parsing included).

        ``payload`` is the post-header byte stream; the host reinterprets it
        as u32 wire words (a free numpy view) and everything else runs in
        one jitted device computation. Returns (C, num_samples) **int16**
        (samples are int16-valued by format; int16 output halves the HBM
        writes) as a zero-copy numpy view of the transferred lane buffer.

        With ``bucket=True`` (default) the block count is padded up to a
        geometric bucket and the sample count left dynamic, so arbitrary
        file lengths share O(log) compiled pipelines instead of one per
        length — padding blocks decode garbage that is sliced away.

        ``strict=False`` opts into the reference's decode-what's-there
        behaviour on truncated payloads (reference: src/aad_decoder.c:514-538
        loop exit; src/main.c:102-111 writes the full-length buffer anyway):
        every block chunk that still holds at least its block header decodes
        (missing trailing bytes read as zero codes — where the reference
        over-reads its file buffer, which is undefined), a final fragment
        smaller than the block header is dropped, and the undecoded tail is
        returned as zero samples (where the reference emits uninitialised
        memory). The default is strict: a mid-stream cut raises
        InsufficientDataError, never silent data loss.

        ``overlap_blocks`` controls the chunked transfer-overlap pipeline
        (block independence: reference src/aad_decoder.c:363-380 — any
        block range decodes standalone). ``None`` (default) auto-enables it
        for streams longer than one chunk; ``0`` forces the single-dispatch
        whole-stream path; an explicit block count sets the chunk size.
        The chunked schedule lets per-chunk downloads stream
        (``copy_to_host_async``) while later chunks upload and decode.
        Output is bit-identical.
        """
        from ..format.geometry import encoded_stream_size, num_blocks_for
        from .result import InsufficientDataError

        if overlap_blocks is not None and overlap_blocks < 0:
            raise InvalidArgumentError(
                f"overlap_blocks must be >= 0, got {overlap_blocks}"
            )
        h = self.header
        geo = self.geometry
        payload = np.asarray(payload, dtype=np.uint8)
        need = encoded_stream_size(geo, h.num_samples)
        nblocks = num_blocks_for(h.num_samples, h.num_samples_per_block)
        if payload.shape[-1] < need:
            if strict:
                # Match the framed and native engines: a mid-stream cut is
                # an error, never silent garbage (format.framing.split_blocks).
                raise InsufficientDataError(
                    f"payload holds {payload.shape[-1]} bytes; {need} required"
                )
            from ..format.geometry import lenient_prefix

            nb_avail, decoded_n = lenient_prefix(
                geo, h.num_samples, payload.shape[-1]
            )
            out = np.zeros((h.num_channels, h.num_samples), dtype=np.int16)
            if nb_avail:
                out[:, :decoded_n] = self._decode_prefix(
                    payload, nb_avail, decoded_n, bucket, overlap_blocks
                )
            return out
        return self._decode_prefix(
            payload, nblocks, h.num_samples, bucket, overlap_blocks
        )

    def _decode_prefix(
        self,
        payload: np.ndarray,
        nblocks: int,
        num_samples: int,
        bucket: bool,
        overlap_blocks: int | None = None,
    ):
        """Decode the first ``nblocks`` blocks to (C, num_samples) int16."""
        from ..ops.wire32 import payload_to_words_split, supports_wire32

        h = self.header
        geo = self.geometry
        nb_padded = _bucket_blocks(nblocks) if bucket else nblocks
        if supports_wire32(geo):
            cb = (
                _overlap_chunk_blocks(geo)
                if overlap_blocks is None
                else overlap_blocks
            )
            if self.engine != "scan":
                # Fill the fused kernel's lane blocks: the padding blocks
                # decode garbage that is sliced away.
                mult = _lane_multiple(geo)
                cb = -(-cb // mult) * mult
                nb_padded = -(-nb_padded // mult) * mult
            if cb and nblocks > cb:
                return self._decode_prefix_overlap(
                    payload, nblocks, num_samples, cb
                )
            # Ship only the real blocks' words; bucket padding materialises
            # on device (_pad_blocks) and is dropped again before download
            # (_trim_lanes) — zero padded bytes cross the link either way.
            hdr_w, data_w = payload_to_words_split(payload, geo, nblocks)
            hdr_j, data_j = jnp.asarray(hdr_w), jnp.asarray(data_w)
            if nb_padded > nblocks:
                hdr_j, data_j = _pad_blocks(hdr_j, data_j, nb_padded=nb_padded)
            lanes = _device_pipeline_words_jit(
                hdr_j,
                data_j,
                geo=geo,
                num_blocks=nb_padded,
                bits_per_sample=h.bits_per_sample,
                ms=h.ch_process_method == CH_PROCESS_MS,
                engine=self.engine,
            )
            if nb_padded > nblocks:
                lanes = _trim_lanes(
                    lanes,
                    channels=h.num_channels,
                    nb_padded=nb_padded,
                    nb=nblocks,
                )
            # Lane-major -> (C, num_samples): a free host view.
            full = np.asarray(lanes).reshape(h.num_channels, -1)
            return full[:, :num_samples]
        total = nb_padded * geo.block_size
        buf = np.zeros(total, dtype=np.uint8)
        n = min(payload.shape[0], nblocks * geo.block_size)
        buf[:n] = payload[:n]
        full = _device_pipeline_jit(
            jnp.asarray(buf),
            geo=geo,
            num_blocks=nb_padded,
            bits_per_sample=h.bits_per_sample,
            ms=h.ch_process_method == CH_PROCESS_MS,
            num_samples=nb_padded * h.num_samples_per_block,
            engine=self.engine,
        )
        return np.asarray(full[:, :num_samples]).astype(np.int16)

    def _decode_prefix_overlap(
        self, payload: np.ndarray, nblocks: int, num_samples: int,
        chunk_blocks: int,
    ) -> np.ndarray:
        """Chunked transfer-overlap decode of the first ``nblocks`` blocks.

        Dispatch phase: per chunk of ``chunk_blocks`` blocks, upload the
        real wire words, run one fused device dispatch
        (:func:`_device_pipeline_words`), and start the download immediately
        (``copy_to_host_async``) — so chunk i's samples stream back while
        chunk i+1 uploads and decodes. Collect phase: paste each chunk's
        lane-major rows into the output columns (blocks are self-contained,
        reference src/aad_decoder.c:363-380, so chunk boundaries are free).

        Every chunk shares ONE compiled pipeline for every file length: the
        chunk shape is fixed and the ragged tail chunk is zero-row padded
        host-side (payload bytes were never shipped for the pad rows'
        payload — only empty word rows, <=2 MB once per stream — and the
        garbage they decode is sliced off in the paste).
        """
        from ..ops.wire32 import payload_to_words_split

        h = self.header
        geo = self.geometry
        C = h.num_channels
        nspb = h.num_samples_per_block
        bs = geo.block_size
        ms = h.ch_process_method == CH_PROCESS_MS
        n_chunks = -(-nblocks // chunk_blocks)
        outs = []
        for i in range(n_chunks):
            b0 = i * chunk_blocks
            real = min(chunk_blocks, nblocks - b0)
            sl = payload[b0 * bs : (b0 + real) * bs]
            # payload_to_words_split zero-fills rows past the slice, so the
            # ragged tail chunk pads to the fixed chunk shape here.
            hdr_w, data_w = payload_to_words_split(sl, geo, chunk_blocks)
            o = _device_pipeline_words_jit(
                jnp.asarray(hdr_w),
                jnp.asarray(data_w),
                geo=geo,
                num_blocks=chunk_blocks,
                bits_per_sample=h.bits_per_sample,
                ms=ms,
                engine=self.engine,
            )
            copy_async = getattr(o, "copy_to_host_async", None)
            if copy_async is not None:
                copy_async()
            outs.append((o, b0, real))
        out = np.zeros((C, num_samples), dtype=np.int16)
        for o, b0, real in outs:
            arr = np.asarray(o).reshape(C, -1)[:, : real * nspb]
            c0 = b0 * nspb
            w = min(arr.shape[1], num_samples - c0)
            if w > 0:
                out[:, c0 : c0 + w] = arr[:, :w]
        return out

    def decode_time_range(
        self, payload: np.ndarray, start_seconds: float, end_seconds: float
    ) -> jax.Array:
        """Random-access decode of a time window (seek support).

        Returns (C, n) samples covering the requested window rounded out to
        block boundaries (block self-containedness makes any window
        decodable without preceding data); trims to the exact sample range.
        """
        h = self.header
        nspb = h.num_samples_per_block
        s0 = max(0, int(start_seconds * h.sampling_rate))
        s1 = min(h.num_samples, int(end_seconds * h.sampling_rate))
        if s1 <= s0:
            raise InvalidArgumentError("empty time range")
        b0 = s0 // nspb
        b1 = -(-s1 // nspb)
        samples = self.decode_block_range(payload, b0, b1 - b0)
        return samples[:, s0 - b0 * nspb : s1 - b0 * nspb]

    def decode_block_range(
        self, payload: np.ndarray, start_block: int, num_blocks: int
    ) -> jax.Array:
        """Random-access decode of a block range (seek support).

        Block self-containedness makes any block range decodable without
        touching preceding data — the device form of the reference's
        per-block ``DecodeBlock`` API (reference: src/aad_decoder.c:321).
        Returns (C, n) int32 where n covers the requested blocks (the final
        stream tail is truncated if the range includes the last block).
        """
        from .result import InvalidArgumentError

        framed = self.frame(payload)
        stop = min(start_block + num_blocks, framed.num_blocks)
        if start_block < 0 or start_block >= framed.num_blocks or stop <= start_block:
            raise InvalidArgumentError(
                f"block range [{start_block}, {start_block + num_blocks}) out of "
                f"bounds for {framed.num_blocks} blocks"
            )
        nspb = self.header.num_samples_per_block
        sub = FramedStream(
            states=type(framed.states)(
                step_index=framed.states.step_index[start_block:stop],
                weight=framed.states.weight[start_block:stop],
                history=framed.states.history[start_block:stop],
            ),
            codes=framed.codes[start_block:stop],
            num_blocks=stop - start_block,
            valid_last=framed.valid_last,
        )
        n = (stop - start_block) * nspb
        if stop == framed.num_blocks:
            n = (stop - start_block - 1) * nspb + framed.valid_last
        h = self.header
        return _decode_device(
            jnp.asarray(sub.codes),
            jnp.asarray(sub.states.step_index),
            jnp.asarray(sub.states.weight),
            jnp.asarray(sub.states.history),
            bits_per_sample=h.bits_per_sample,
            ms=h.ch_process_method == CH_PROCESS_MS,
            num_samples=n,
            engine=self.engine,
        )


def _native_lenient(native, buf: np.ndarray, header, geo) -> np.ndarray:
    """Lenient (strict=False) truncated decode through the native engine.

    The lenient contract — every block chunk still holding its block header
    decodes with the missing trailing bytes as zero codes, the undecoded
    tail is zero samples (Decoder.decode_payload_ondevice) — is exactly
    what the native whole-block path computes on a zero-padded payload:
    zero code bytes ARE zero codes.
    """
    payload = buf[FILE_HEADER_SIZE:]
    from ..format.geometry import lenient_prefix

    nb_avail, decoded_n = lenient_prefix(
        geo, header.num_samples, payload.shape[0]
    )
    out = np.zeros((header.num_channels, header.num_samples), dtype=np.int32)
    if nb_avail:
        span = min(int(payload.shape[0]), nb_avail * geo.block_size)
        padded = np.zeros(nb_avail * geo.block_size + 4, dtype=np.uint8)
        padded[:span] = payload[:span]
        out[:, :decoded_n] = native.decode_payload_blocks(
            padded, header, decoded_n
        )
    return out


def decode(
    data: bytes | np.ndarray, engine: str = "auto", strict: bool = True
) -> tuple[HeaderInfo, np.ndarray]:
    """Decode a complete .aad stream.

    Returns (header, pcm) where pcm is (num_channels, num_samples) int32 in
    the int16 value range — the same convention as the reference's
    ``DecodeWhole`` output buffers (reference: src/aad_decoder.c:478). The
    int32 dtype is a guarantee, normalized at the single exit below, however
    the call dispatched (native, JAX engines, strict or lenient).

    ``engine="auto"`` prefers the native codec: a one-shot bytes-in →
    host-array-out decode pays dispatch latency plus two host↔device
    transfers (payload up, PCM down) on top of the device work (the decoder
    mirror of the encode ``auto`` policy, codec/encoder.py::encode; whether
    the GPU should take it over is for the benchmark to show). The GPU
    serves the device-resident APIs — :class:`Decoder` (whose output can
    stay on device), ``decode_batch``, the sharded pipelines — and explicit
    ``engine="fused"``/``"scan"``.

    ``strict=False`` opts into the reference's decode-what's-there behaviour
    on truncated payloads: available whole blocks decode, the missing tail
    returns as zero samples (see Decoder.decode_payload_ondevice). The
    default raises InsufficientDataError on any mid-stream cut. The native
    engine serves lenient decodes too (see _native_lenient).
    """
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)
    ) else np.asarray(data, dtype=np.uint8)
    header = decode_header(buf.tobytes()[:FILE_HEADER_SIZE])
    validate_header(header)

    from ..format.geometry import encoded_stream_size, geometry_from_header

    geo = geometry_from_header(
        header.num_channels, header.bits_per_sample, header.block_size
    )
    truncated = not strict and buf.shape[0] - FILE_HEADER_SIZE < (
        encoded_stream_size(geo, header.num_samples)
    )
    from ..ops.decode import resolve_engine

    engine = resolve_engine(engine, native="always")
    if engine == "native":
        from .. import native

        if not truncated:
            header, pcm = native.decode(buf)
        else:
            pcm = _native_lenient(native, buf, header, geo)
    else:
        dec = Decoder.from_header(header, engine=engine)
        pcm = dec.decode_payload_ondevice(buf[FILE_HEADER_SIZE:], strict=strict)
    # single exit: int32 whatever the dispatch (free when already int32)
    return header, np.asarray(pcm, dtype=np.int32)
