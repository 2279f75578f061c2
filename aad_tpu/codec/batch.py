"""Batched multi-stream decode: many .aad files in one device computation.

Block self-containedness means *every block of every stream* is an
independent decode task, so a heterogeneous pile of files flattens into a
few lane batches. Streams are grouped by geometry — block
size, channel count, bit depth and MS flag are static pipeline parameters —
and each group's block rows stack into ONE u32 wire-word batch for the
wire32 device pipeline (codec.decoder._device_pipeline_words): no byte
tensor is built on host or device, and the per-group lane count is
bucketed so differing piles reuse compiled shapes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

import jax.numpy as jnp

from ..constants import CH_PROCESS_MS, FILE_HEADER_SIZE
from ..format.geometry import geometry_from_header, num_blocks_for
from ..format.header import HeaderInfo, decode_header, validate_header
from ..ops.decode import resolve_engine
from ..ops.wire32 import payload_to_words_split


def decode_batch(
    streams: Sequence[bytes | np.ndarray], engine: str = "auto"
) -> list[tuple[HeaderInfo, np.ndarray]]:
    """Decode many complete .aad streams, one device call per geometry group.

    Returns a list of (header, pcm[C, N] int16) in input order.
    """
    from .decoder import (
        _bucket_blocks,
        _device_pipeline_words_jit,
        _lane_multiple,
    )

    # "auto": the fused kernel on a GPU; elsewhere the native host engine,
    # which beats the scan engine on a CPU by orders of magnitude.
    engine = resolve_engine(engine, native="off_gpu")
    if engine == "native":
        # threaded GIL-free C calls: the CPU-host batch path
        from .. import native as _native

        return [
            (h, p.astype(np.int16))
            for h, p in _native.decode_batch(streams)
        ]

    parsed = []
    for data in streams:
        buf = (
            np.frombuffer(bytes(data), dtype=np.uint8)
            if isinstance(data, (bytes, bytearray))
            else np.asarray(data, dtype=np.uint8)
        )
        header = decode_header(buf.tobytes()[:FILE_HEADER_SIZE])
        validate_header(header)
        geo = geometry_from_header(
            header.num_channels, header.bits_per_sample, header.block_size
        )
        parsed.append((header, geo, buf[FILE_HEADER_SIZE:]))

    results: list = [None] * len(parsed)
    groups: dict[tuple, list[int]] = {}
    for i, (h, geo, _) in enumerate(parsed):
        key = (
            geo.num_channels,
            geo.bits_per_sample,
            geo.block_size,
            h.ch_process_method == CH_PROCESS_MS,
        )
        groups.setdefault(key, []).append(i)

    for (nch, bps, _bsz, ms), idxs in groups.items():
        geo = parsed[idxs[0]][1]
        nspb = geo.num_samples_per_block

        spans = []  # (block_offset, nblocks) per stream
        hdr_rows, data_rows = [], []
        start = 0
        for i in idxs:
            h, _, payload = parsed[i]
            nb = num_blocks_for(h.num_samples, nspb)
            hw, dw = payload_to_words_split(payload, geo, nb)
            hdr_rows.append(hw)
            data_rows.append(dw)
            spans.append((start, nb))
            start += nb

        B_real = start
        B_pad = _bucket_blocks(B_real)
        if engine != "scan":
            mult = _lane_multiple(geo)
            B_pad = -(-B_pad // mult) * mult
        # Ship only the real blocks' words; bucket padding materialises on
        # device and is dropped again before download (decoder._pad_blocks /
        # _trim_lanes) — no padded bytes cross the link in either direction.
        from .decoder import _pad_blocks, _trim_lanes

        hdr_j = jnp.asarray(np.concatenate(hdr_rows, axis=0))
        data_j = jnp.asarray(np.concatenate(data_rows, axis=0))
        if B_pad > B_real:
            hdr_j, data_j = _pad_blocks(hdr_j, data_j, nb_padded=B_pad)

        lanes = _device_pipeline_words_jit(
            hdr_j,
            data_j,
            geo=geo,
            num_blocks=B_pad,
            bits_per_sample=bps,
            ms=ms,
            engine=engine,
        )
        if B_pad > B_real:
            # Drop the bucket-padding blocks on device: the host transfer is
            # the batch path's tail cost and the padding is up to ~30% of it.
            lanes = _trim_lanes(
                lanes, channels=nch, nb_padded=B_pad, nb=B_real
            )
        full = np.asarray(lanes).reshape(nch, B_real * nspb)

        for i, (off, nb) in zip(idxs, spans):
            h = parsed[i][0]
            pcm = full[:, off * nspb : off * nspb + nb * nspb][:, : h.num_samples]
            results[i] = (h, pcm)

    return results
