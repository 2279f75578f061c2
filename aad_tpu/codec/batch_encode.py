"""Batched multi-stream encode: many PCM streams in one device computation.

Encode chains state across blocks *within* a stream but is independent
across streams, so a batch runs in lockstep: block b of every stream encodes
together, with streams x channels folded onto the kernel lane axis. Streams
of different lengths ride the same batch via per-(block, stream) valid
counts — a stream's blocks past its end freeze state and are dropped at
assembly, so each stream's bytes equal its solo encode (pinned by tests).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

import jax.numpy as jnp

from ..constants import CH_PROCESS_MS
from ..format.framing import BlockStates, assemble_stream, build_block_headers
from ..format.geometry import num_blocks_for
from ..format.header import encode_header
from ..ops.encode import encode_stream_blocks, lr_to_ms
from ..ops.decode import resolve_engine
from .encoder import EncodeConfig
from .result import InvalidArgumentError


def encode_batch(
    streams: Sequence[np.ndarray],
    config: EncodeConfig,
    engine: str = "auto",
    parallel_blocks: bool = False,
    parallel_chunk_blocks: int = 1,
    parallel_warm_passes: int = 0,
) -> list[bytes]:
    """Encode a batch of (C, N_i) PCM streams under one configuration.

    Returns complete .aad byte strings in input order; each is byte-exact
    with encoding that stream alone (with ``parallel_blocks=True``, with
    encoding that stream alone in parallel mode — see
    :class:`aad_tpu.codec.encoder.Encoder`: block-independent encode, every
    block from a fresh state, blocks joining the lane axes).
    """
    config.validate()
    # "auto": the scan engine on a GPU; elsewhere the native host engines,
    # which beat the scan engine on a CPU by orders of magnitude.
    engine = resolve_engine(engine, direction="encode", native="off_gpu")
    if engine == "native":
        # threaded GIL-free C calls: the CPU-host batch path
        from .. import native as _native

        return _native.encode_batch(
            streams, config, parallel_blocks=parallel_blocks,
            chunk_blocks=parallel_chunk_blocks if parallel_blocks else 1,
            warm_passes=parallel_warm_passes if parallel_blocks else 0,
        )
    geo = config.geometry()
    nspb = geo.num_samples_per_block
    nch = config.num_channels

    lengths = []
    for pcm in streams:
        pcm = np.asarray(pcm)
        if pcm.ndim != 2 or pcm.shape[0] != nch:
            raise InvalidArgumentError(f"stream must be ({nch}, N); got {pcm.shape}")
        lengths.append(pcm.shape[1])
    if not streams:
        return []

    S = len(streams)
    B = max(num_blocks_for(n, nspb) for n in lengths)
    # valid samples per (block, stream); broadcast over channels
    valid = np.clip(
        np.asarray(lengths)[None, :] - np.arange(B)[:, None] * nspb, 0, nspb
    ).astype(np.int32)

    ms = config.ch_process_method == CH_PROCESS_MS
    from ..ops.wire32 import supports_wire32, wire_words_to_payload

    if supports_wire32(geo) and not ms and not parallel_blocks:
        # Folded-lane sequential batch: stage (B, C*S, nspb) with lane
        # l = c*S + s, so each channel's wire words are a contiguous slice
        # (see _encode_device_wire's folded branches).
        from .encoder import _encode_device_wire

        padded = np.zeros((nch, S, B * nspb), dtype=np.int32)
        for s, pcm in enumerate(streams):
            padded[:, s, : lengths[s]] = pcm
        blocks = np.moveaxis(
            padded.reshape(nch, S, B, nspb), 2, 0
        ).reshape(B, nch * S, nspb)
        valid_l = np.tile(valid, (1, nch))  # (B, C*S), c-major
        words = np.asarray(
            _encode_device_wire(
                jnp.asarray(blocks), jnp.asarray(valid_l), geo=geo,
                num_trials=config.num_encode_trials, ms=False,
                lanes_folded=True,
            )
        )  # (B, S, wpb)
        return [
            encode_header(config.header_for(n))
            + wire_words_to_payload(words[:, s], geo, n).tobytes()
            for s, n in enumerate(lengths)
        ]

    padded = np.zeros((S, nch, B * nspb), dtype=np.int32)
    for s, pcm in enumerate(streams):
        padded[s, :, : lengths[s]] = pcm
    # (S, C, B*nspb) -> (B, S, C, nspb)
    blocks = np.ascontiguousarray(
        np.moveaxis(padded.reshape(S, nch, B, nspb), 2, 0)
    )
    valid_j = jnp.asarray(valid)[:, :, None]  # (B, S, 1) -> lanes (S, C)

    if supports_wire32(geo):
        # fully on-device pipeline: codes stay packed, headers and the
        # channel-interleaved wire are assembled as u32 words (see
        # codec.encoder._encode_device_wire); per-stream payloads are free
        # host byte views of the word rows.
        from .encoder import _encode_device_wire

        words = np.asarray(
            _encode_device_wire(
                jnp.asarray(blocks), valid_j, geo=geo,
                num_trials=config.num_encode_trials, ms=ms,
                parallel=parallel_blocks,
                chunk_blocks=parallel_chunk_blocks if parallel_blocks else 1,
                warm_passes=parallel_warm_passes if parallel_blocks else 0,
            )
        )  # (B, S, wpb)
        return [
            encode_header(config.header_for(n))
            + wire_words_to_payload(words[:, s], geo, n).tobytes()
            for s, n in enumerate(lengths)
        ]

    if parallel_blocks:
        raise InvalidArgumentError(
            "parallel_blocks requires a wire32-supported geometry"
        )
    jb = jnp.asarray(blocks)
    if ms:
        jb = lr_to_ms(jb)
    headers, codes = encode_stream_blocks(
        jb,
        valid_j,
        config.bits_per_sample,
        config.num_encode_trials,
    )

    si = np.asarray(headers.step_index)  # (B, S, C)
    sh = np.asarray(headers.shift)
    wt = np.asarray(headers.weight)
    hi = np.asarray(headers.history)
    cd = np.asarray(codes)  # (B, S, C, T)

    out: list[bytes] = []
    for s, n in enumerate(lengths):
        nb = num_blocks_for(n, nspb)
        states = BlockStates(
            step_index=si[:nb, s], weight=wt[:nb, s], history=hi[:nb, s]
        )
        hdr_bytes = build_block_headers(states, sh[:nb, s], geo)
        payload = assemble_stream(hdr_bytes, cd[:nb, s], geo, n)
        out.append(encode_header(config.header_for(n)) + payload.tobytes())
    return out
