"""High-level encoder: PCM -> .aad bytes.

Pipeline (reference behaviour: src/aad_encoder.c:814-891, re-architected):

    pcm (C, N) --host--> zero-padded dense blocks (B, C, nspb)
               --device--> LR->MS, sequential block scan w/ trial search
               --host/device--> block headers + packed units -> payload bytes

The device step is one jitted ``lax.scan`` over blocks; channels (and, via
vmap at the batch API, independent streams) ride the lane axes.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    CH_PROCESS_INVALID,
    CH_PROCESS_MS,
    MAX_BITS_PER_SAMPLE,
    MAX_NUM_CHANNELS,
    block_header_size,
)
from ..format.framing import BlockStates, assemble_stream, build_block_headers
from ..format.geometry import (
    BlockGeometry,
    compute_block_geometry,
    num_blocks_for,
)
from ..format.header import HeaderInfo, encode_header
from ..ops.decode import resolve_engine
from ..ops.encode import encode_stream_blocks, lr_to_ms
from .result import InvalidArgumentError, InvalidFormatError


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """Encoder parameters (reference: struct AADEncodeParameter,
    src/aad_encoder.h:8-15) with the reference CLI defaults
    (reference: src/main.c:39-47)."""

    num_channels: int
    sampling_rate: int
    bits_per_sample: int = 4
    max_block_size: int = 1024
    ch_process_method: int = 0
    num_encode_trials: int = 2

    def validate(self) -> None:
        """Parameter validation, mirroring ConvertParameterToHeader
        (reference: src/aad_encoder.c:741-753).

        Note the reference quirk kept intact: bits_per_sample == 1 passes
        *parameter* validation and only fails later at header encode
        (reference: src/aad_encoder.c:743-745 vs :165-167).
        """
        if self.bits_per_sample == 0 or self.bits_per_sample > MAX_BITS_PER_SAMPLE:
            raise InvalidFormatError(f"bad bits_per_sample: {self.bits_per_sample}")
        if self.max_block_size < block_header_size(self.num_channels):
            raise InvalidFormatError("max_block_size cannot fit the block header")
        if self.ch_process_method >= CH_PROCESS_INVALID:
            raise InvalidFormatError(
                f"bad ch_process_method: {self.ch_process_method}"
            )
        if self.num_channels == 0 or self.num_channels > MAX_NUM_CHANNELS:
            raise InvalidFormatError(f"bad num_channels: {self.num_channels}")

    def header_for(self, num_samples: int) -> HeaderInfo:
        geo = self.geometry()
        return HeaderInfo(
            num_channels=self.num_channels,
            num_samples=num_samples,
            sampling_rate=self.sampling_rate,
            bits_per_sample=self.bits_per_sample,
            block_size=geo.block_size,
            num_samples_per_block=geo.num_samples_per_block,
            ch_process_method=self.ch_process_method,
        )

    def geometry(self) -> BlockGeometry:
        return compute_block_geometry(
            self.max_block_size, self.num_channels, self.bits_per_sample
        )


@functools.partial(
    jax.jit, static_argnames=("bits_per_sample", "num_trials", "ms")
)
def _encode_device(blocks, valid, *, bits_per_sample: int, num_trials: int, ms: bool):
    """Device side: (B, C, nspb) padded PCM -> header fields + codes."""
    if ms:
        # LR->MS is per-sample and maps padding zeros to zeros, so applying it
        # to the whole padded signal equals the reference's per-block
        # transform (reference: src/aad_encoder.c:596-603, 496-512).
        blocks = lr_to_ms(blocks)
    return encode_stream_blocks(blocks, valid, bits_per_sample, num_trials)


@functools.partial(
    jax.jit,
    static_argnames=(
        "geo", "num_trials", "ms", "parallel", "warm_passes", "chunk_blocks",
        "lanes_folded",
    ),
)
def _encode_device_wire(
    blocks, valid, *, geo: BlockGeometry, num_trials: int, ms: bool,
    parallel: bool = False, warm_passes: int = 0, chunk_blocks: int = 1,
    lanes_folded: bool = False,
):
    """Whole encode on device: padded PCM -> (B, wpb) u32 wire-word rows.

    The encode mirror of the decoder's wire32 pipeline: trial search + code
    emission (packed words straight from the kernel), block-header field
    packing, the channel-interleave wire permutation and the row assembly
    are all tensor ops under one jit; the host's only job afterwards is a
    free little-endian byte view plus the final-block truncation
    (ops.wire32.wire_words_to_payload). Skips the 8x nibble unpack and the
    host-side byte assembly of the int32-codes path entirely.

    ``parallel=True`` selects the block-independent mode
    (ops.encode.encode_blocks_parallel): the block axis joins the lane
    axes, so every block of the stream encodes concurrently.
    """
    from ..ops.encode import (
        encode_blocks_parallel,
        encode_blocks_parallel_flat,
        encode_stream_words,
    )
    from ..ops.wire32 import (
        assemble_wire_words,
        build_header_words,
        kernel_words_to_wire,
    )

    if parallel and blocks.ndim == 2:
        # Channel-major folded lanes (C*B, nspb): the staging is free on
        # the host (the natural (C, N) -> (C*B, nspb) view) and makes
        # every per-channel wire slice a contiguous leading-axis half.
        assert not ms and chunk_blocks == 1 and warm_passes == 0
        C = geo.num_channels
        L = blocks.shape[0]
        B = L // C
        headers, kw = encode_blocks_parallel_flat(
            blocks, valid, geo.bits_per_sample, num_trials
        )
        hdr_u16 = build_header_words(
            headers.step_index.reshape(C, B),
            headers.shift.reshape(C, B),
            headers.weight.reshape(C, B, 4),
            headers.history.reshape(C, B, 4),
            geo,
            channel_leading=True,
        )
        data_words = kernel_words_to_wire(
            kw.reshape(C, B, -1), geo, channel_axis=0
        )
        return assemble_wire_words(hdr_u16, data_words, geo)

    if lanes_folded and not parallel:
        # Batch-sequential folded lanes: blocks (B, C*S, nspb) with lane
        # l = c*S + s (channel-major over streams), valid (B, C*S), so
        # each channel's wire words are a contiguous slice.
        assert not ms and blocks.ndim == 3
        C = geo.num_channels
        B, L, _ = blocks.shape
        S = L // C
        headers, kw, _ = encode_stream_words(
            blocks, valid, geo.bits_per_sample, num_trials, need_carry=False,
        )

        def unfold(x):  # (B, L[, 4]) -> (B, S, C[, 4]); header-scale tiny
            return jnp.moveaxis(x.reshape(B, C, S, *x.shape[2:]), 1, 2)

        hdr_u16 = build_header_words(
            unfold(headers.step_index),
            unfold(headers.shift),
            unfold(headers.weight),
            unfold(headers.history),
            geo,
        )
        data_words = kernel_words_to_wire(
            kw.reshape(B, C, S, -1), geo, channel_axis=1
        )
        return assemble_wire_words(hdr_u16, data_words, geo)

    if ms:
        blocks = lr_to_ms(blocks)
    if parallel:
        headers, kw = encode_blocks_parallel(
            blocks, valid, geo.bits_per_sample, num_trials,
            chunk_blocks=chunk_blocks, warm_passes=warm_passes,
        )
    else:
        headers, kw, _ = encode_stream_words(
            blocks, valid, geo.bits_per_sample, num_trials
        )
    hdr_u16 = build_header_words(
        headers.step_index, headers.shift, headers.weight, headers.history, geo
    )
    data_words = kernel_words_to_wire(kw, geo)
    return assemble_wire_words(hdr_u16, data_words, geo)


def _pad_to_lanes_flat(
    pcm: np.ndarray, geo: BlockGeometry, bucket=None
) -> tuple[np.ndarray, np.ndarray, int]:
    """(C, N) -> ((C*Bp, nspb) channel-major int32, valid (C*Bp,), B).

    The folded-lane staging for the block-parallel encode: one zero-padded
    per-channel buffer whose reshape IS the lane layout (all of channel
    0's blocks first — the decode pipeline's lane order), covering both
    the final-block zero pad and the ``bucket`` block-count pad in a
    single allocation. Pad lanes carry valid=0.
    """
    nch, n = pcm.shape
    nspb = geo.num_samples_per_block
    nblocks = num_blocks_for(n, nspb)
    Bp = bucket(nblocks) if bucket else nblocks
    buf = np.zeros((nch, Bp * nspb), dtype=np.int32)
    buf[:, :n] = pcm
    valid = np.minimum(
        np.full(Bp, nspb, dtype=np.int64),
        np.maximum(n - np.arange(Bp, dtype=np.int64) * nspb, 0),
    ).astype(np.int32)
    return buf.reshape(nch * Bp, nspb), np.tile(valid, nch), nblocks


def _pad_to_blocks(pcm: np.ndarray, geo: BlockGeometry) -> tuple[np.ndarray, np.ndarray, int]:
    """(C, N) -> ((B, C, nspb) zero-padded int32, valid (B,), B)."""
    nch, n = pcm.shape
    nspb = geo.num_samples_per_block
    nblocks = num_blocks_for(n, nspb)
    padded = np.zeros((nch, nblocks * nspb), dtype=np.int32)
    padded[:, :n] = pcm
    blocks = np.swapaxes(padded.reshape(nch, nblocks, nspb), 0, 1)
    valid = np.minimum(
        np.full(nblocks, nspb, dtype=np.int32),
        n - np.arange(nblocks, dtype=np.int64) * nspb,
    ).astype(np.int32)
    return np.ascontiguousarray(blocks), valid, nblocks


@dataclasses.dataclass
class Encoder:
    """Reusable encoder bound to one configuration.

    ``parallel_blocks=True`` selects the block-independent encode: every
    block is encoded from a fresh processor state (the reference's
    first-block semantics, trial search included), which removes the
    sequential cross-block chain — all blocks of the stream encode
    concurrently across the device's lanes. The output is a fully valid
    stream for any conforming decoder (each block header carries the
    complete decoder state, reference: src/aad_decoder.c:363-380) and is
    byte-identical to concatenating independent single-block encodes; the
    cost is a small quality loss from the predictor's missing cross-block
    warm start. This mode is the framework's own — the reference encoder
    has no equivalent.
    """

    config: EncodeConfig
    geometry: BlockGeometry
    engine: str = "auto"
    parallel_blocks: bool = False
    # Quality/throughput knobs for parallel mode (ops.encode.
    # encode_blocks_parallel): chunk_blocks=c encodes sequentially within
    # chunks of c blocks (true sequential semantics incl. the trial
    # warm-up) and in parallel across chunks — only chunk heads lose the
    # warm start; warm_passes=k Jacobi-warms those chunk heads with the
    # previous chunk's (previous-pass) final state, each pass adding c
    # blocks of predictor history. c=1, k=0 = cold (byte-identical to
    # independent single-block encodes).
    parallel_chunk_blocks: int = 1
    parallel_warm_passes: int = 0

    @classmethod
    def from_config(
        cls,
        config: EncodeConfig,
        engine: str = "auto",
        parallel_blocks: bool = False,
        parallel_chunk_blocks: int = 1,
        parallel_warm_passes: int = 0,
    ) -> "Encoder":
        config.validate()
        return cls(
            config=config,
            geometry=config.geometry(),
            engine=resolve_engine(engine, direction="encode"),
            parallel_blocks=parallel_blocks,
            parallel_chunk_blocks=parallel_chunk_blocks,
            parallel_warm_passes=parallel_warm_passes,
        )

    def encode(self, pcm: np.ndarray) -> bytes:
        """Encode (C, N) int32 PCM (int16-valued) into a complete .aad stream."""
        cfg = self.config
        pcm = np.asarray(pcm, dtype=np.int32)
        if pcm.ndim != 2 or pcm.shape[0] != cfg.num_channels:
            raise InvalidArgumentError(
                f"pcm must be ({cfg.num_channels}, N); got {pcm.shape}"
            )
        from ..utils import debug

        if debug.enabled():
            debug.check_pcm_range(pcm)
        num_samples = pcm.shape[1]
        # header_for -> encode_header re-validates, applying the reference's
        # stricter header-time checks (num_samples > 0, bps >= 2).
        header = self.config.header_for(num_samples)
        file_header = encode_header(header)

        ms = cfg.ch_process_method == CH_PROCESS_MS

        from ..ops.wire32 import supports_wire32, wire_words_to_payload

        flat_lanes = (
            self.parallel_blocks
            and not ms
            and self.parallel_chunk_blocks == 1
            and self.parallel_warm_passes == 0
            and supports_wire32(self.geometry)
        )
        if flat_lanes:
            # Channel-major folded staging: (C, N) pcm -> (C*Bp, nspb) is a
            # single zero-padded buffer + free reshape (no swapaxes copy);
            # see the flat branch of _encode_device_wire. Bucket the
            # block count so distinct stream lengths reuse compiled shapes.
            from .decoder import _bucket_blocks

            lanes2d, valid, _ = _pad_to_lanes_flat(
                pcm, self.geometry, _bucket_blocks
            )
            words = _encode_device_wire(
                jnp.asarray(lanes2d),
                jnp.asarray(valid),
                geo=self.geometry,
                num_trials=cfg.num_encode_trials,
                ms=False,
                parallel=True,
            )
            payload = wire_words_to_payload(
                np.asarray(words), self.geometry, num_samples
            )
            return file_header + payload.tobytes()

        blocks, valid, _ = _pad_to_blocks(pcm, self.geometry)
        if supports_wire32(self.geometry):
            if self.parallel_blocks:
                # Pad the block axis to a geometric bucket: blocks ride the
                # lane axes here, so every distinct count would otherwise
                # compile its own kernel. Pad blocks carry valid=0 and are
                # dropped by the payload row slice.
                from .decoder import _bucket_blocks

                B = blocks.shape[0]
                Bp = _bucket_blocks(B)
                if Bp > B:
                    blocks = np.concatenate(
                        [blocks, np.zeros((Bp - B, *blocks.shape[1:]),
                                          dtype=blocks.dtype)]
                    )
                    valid = np.concatenate(
                        [valid, np.zeros(Bp - B, dtype=valid.dtype)]
                    )
            words = _encode_device_wire(
                jnp.asarray(blocks),
                jnp.asarray(valid),
                geo=self.geometry,
                num_trials=cfg.num_encode_trials,
                ms=ms,
                parallel=self.parallel_blocks,
                warm_passes=(
                    self.parallel_warm_passes if self.parallel_blocks else 0
                ),
                chunk_blocks=(
                    self.parallel_chunk_blocks if self.parallel_blocks else 1
                ),
            )
            payload = wire_words_to_payload(
                np.asarray(words), self.geometry, num_samples
            )
            return file_header + payload.tobytes()

        hdr_fields, codes = _encode_device(
            jnp.asarray(blocks),
            jnp.asarray(valid),
            bits_per_sample=cfg.bits_per_sample,
            num_trials=cfg.num_encode_trials,
            ms=ms,
        )

        states = BlockStates(
            step_index=np.asarray(hdr_fields.step_index),
            weight=np.asarray(hdr_fields.weight),
            history=np.asarray(hdr_fields.history),
        )
        shifts = np.asarray(hdr_fields.shift)
        header_bytes = build_block_headers(states, shifts, self.geometry)
        payload = assemble_stream(
            header_bytes, np.asarray(codes), self.geometry, num_samples
        )
        return file_header + payload.tobytes()


def encode(
    pcm: np.ndarray,
    config: EncodeConfig,
    engine: str = "auto",
    parallel_blocks: bool = False,
    parallel_chunk_blocks: int = 1,
    parallel_warm_passes: int = 0,
) -> bytes:
    """One-shot encode; see :class:`Encoder`.

    ``engine="auto"`` for a *sequential* single stream prefers the native
    engine: the encode recurrence is a serial dependent chain per sample
    (docs/DESIGN.md §3), so one stream gives a device no parallelism to
    use (whether the GPU should take it over is for the benchmark to
    show). With ``parallel_blocks=True`` — the block-independent mode,
    which encodes all blocks of even a single stream concurrently (see
    :class:`Encoder`) — "auto" runs the scan engine on a GPU and the
    block-parallel native host engine (native/aadx.cc, byte-identical for
    every chunk/warm knob setting) elsewhere. Pass "scan" or "native" to
    override.
    """
    engine = resolve_engine(
        engine, direction="encode",
        native="off_gpu" if parallel_blocks else "always",
    )
    if engine == "native":
        from .. import native

        config.validate()
        if parallel_blocks:
            return native.encode_parallel(
                np.asarray(pcm, dtype=np.int32), config,
                chunk_blocks=parallel_chunk_blocks,
                warm_passes=parallel_warm_passes,
            )
        return native.encode(np.asarray(pcm, dtype=np.int32), config)
    return Encoder.from_config(
        config, engine=engine, parallel_blocks=parallel_blocks,
        parallel_chunk_blocks=parallel_chunk_blocks,
        parallel_warm_passes=parallel_warm_passes,
    ).encode(pcm)
