"""Streaming codec: chunked encode/decode with bit-exact state carry.

The encoder-side streaming state the reference carries implicitly across
``EncodeBlock`` calls (processor state chained at src/aad_encoder.c:870,
trial search reading the previous block at :502-512) is made explicit here:

    StreamingEncoder.push(pcm_chunk) -> payload bytes for completed blocks
    StreamingEncoder.finish()        -> tail payload bytes
    StreamingEncoder.header()        -> 31-byte header (after finish)

Chunk boundaries are arbitrary; the emitted byte stream is identical to a
one-shot encode of the concatenated input (pinned by tests). Decoding side,
block self-containedness makes streaming trivial: any whole blocks in the
buffer decode immediately.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..constants import CH_PROCESS_MS
from ..format import framing
from ..format.geometry import encoded_block_bytes
from ..format.header import HeaderInfo, decode_header, encode_header, validate_header
from ..ops.encode import encode_stream_blocks_carry, lr_to_ms
from .encoder import EncodeConfig
from .result import InvalidArgumentError


class StreamingEncoder:
    """Chunked encoder with bit-exact predictor-state carryover."""

    def __init__(
        self,
        config: EncodeConfig,
        engine: str = "auto",
        total_samples: int | None = None,
    ):
        """``total_samples``: declare the stream length up front so
        :meth:`header` is valid before any data arrives — required for
        progressive transmission (the 31-byte header carries the total)."""
        config.validate()
        self.config = config
        self.geometry = config.geometry()
        # Hybrid dispatch, mirroring the one-shot encode(): a streaming
        # stream is a sequential chain, which "auto" serves from the native
        # host engine — the JAX engines serve explicit overrides.
        from ..ops.decode import resolve_engine

        self.engine = resolve_engine(
            engine, direction="encode", native="always"
        )
        self._native = None
        if self.engine == "native":
            from .. import native

            self._native = native
            self._nstate, self._nprev = native.stream_state(config)
        self.total_samples = total_samples
        self._buffer = np.empty((config.num_channels, 0), dtype=np.int32)
        self._carry = None
        self._blocks_done = 0
        self._samples_done = 0
        self._finished = False

    def push(self, pcm: np.ndarray) -> bytes:
        """Feed (C, n) samples; returns payload bytes of completed blocks.

        Only whole blocks are emitted; the remainder is buffered. The final
        (possibly short) block is emitted by :meth:`finish`.
        """
        if self._finished:
            raise InvalidArgumentError("encoder already finished")
        pcm = np.asarray(pcm, dtype=np.int32)
        if pcm.ndim != 2 or pcm.shape[0] != self.config.num_channels:
            raise InvalidArgumentError(
                f"chunk must be ({self.config.num_channels}, n)"
            )
        self._buffer = np.concatenate([self._buffer, pcm], axis=1)
        nspb = self.geometry.num_samples_per_block
        whole = self._buffer.shape[1] // nspb
        if whole == 0:
            return b""
        head = self._buffer[:, : whole * nspb]
        self._buffer = self._buffer[:, whole * nspb :]
        return self._encode_blocks(head, full_blocks=True)

    def finish(self) -> bytes:
        """Flush the buffered tail; further pushes are rejected."""
        if self._finished:
            return b""
        self._finished = True
        if self._buffer.shape[1] == 0:
            return b""
        tail = self._buffer
        self._buffer = np.empty((self.config.num_channels, 0), dtype=np.int32)
        return self._encode_blocks(tail, full_blocks=False)

    def header(self) -> bytes:
        """The 31-byte stream header.

        Uses the declared ``total_samples`` when given (valid immediately);
        otherwise the samples consumed so far (valid after :meth:`finish`).
        """
        n = self.total_samples if self.total_samples is not None else self._samples_done
        return encode_header(self.config.header_for(n))

    @property
    def num_samples(self) -> int:
        return self._samples_done

    def _encode_blocks(self, pcm: np.ndarray, full_blocks: bool) -> bytes:
        geo = self.geometry
        nspb = geo.num_samples_per_block
        n = pcm.shape[1]
        nblocks = -(-n // nspb)

        if self._native is not None:
            data = self._native.encode_chunk(
                pcm, self.config, self._nstate, self._nprev,
                self._blocks_done,
            )
            self._blocks_done += nblocks
            self._samples_done += n
            return data

        padded = np.zeros((pcm.shape[0], nblocks * nspb), dtype=np.int32)
        padded[:, :n] = pcm
        blocks = np.ascontiguousarray(
            np.swapaxes(padded.reshape(pcm.shape[0], nblocks, nspb), 0, 1)
        )
        valid = np.minimum(
            np.full(nblocks, nspb, dtype=np.int64),
            n - np.arange(nblocks, dtype=np.int64) * nspb,
        ).astype(np.int32)

        jb = jnp.asarray(blocks)
        if self.config.ch_process_method == CH_PROCESS_MS:
            jb = lr_to_ms(jb)
        headers, codes, carry = encode_stream_blocks_carry(
            jb,
            jnp.asarray(valid),
            self.config.bits_per_sample,
            self.config.num_encode_trials,
            carry=self._carry,
            blocks_before=self._blocks_done,
        )
        self._carry = carry
        self._blocks_done += nblocks
        self._samples_done += n

        states = framing.BlockStates(
            step_index=np.asarray(headers.step_index),
            weight=np.asarray(headers.weight),
            history=np.asarray(headers.history),
        )
        hdr_bytes = framing.build_block_headers(
            states, np.asarray(headers.shift), geo
        )
        data = framing.pack_codes(np.asarray(codes), geo)
        full = np.concatenate([hdr_bytes, data], axis=-1)  # (B, block_size)
        if full_blocks:
            return full.reshape(-1).tobytes()
        tail_bytes = encoded_block_bytes(geo, int(valid[-1]))
        parts = [full[:-1].reshape(-1), full[-1, :tail_bytes]]
        return np.concatenate(parts).tobytes()


class _ByteFIFO:
    """Amortised O(1)-per-byte byte queue (list of chunks + read offset).

    ``bytes += chunk`` / ``buf = buf[n:]`` both copy the whole remainder,
    making many tiny pushes O(n^2); this keeps pushes append-only and pops
    amortised linear.
    """

    def __init__(self):
        import collections

        self._chunks: "collections.deque[bytes]" = collections.deque()
        self._offset = 0  # consumed bytes of _chunks[0]
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def append(self, data: bytes) -> None:
        if data:
            self._chunks.append(data)
            self._size += len(data)

    def pop(self, n: int) -> bytes:
        """Remove and return exactly ``n`` bytes (caller checks len first)."""
        assert n <= self._size
        out = bytearray()
        while n:
            head = self._chunks[0]
            avail = len(head) - self._offset
            take = min(avail, n)
            out += head[self._offset : self._offset + take]
            self._offset += take
            self._size -= take
            n -= take
            if self._offset == len(head):
                self._chunks.popleft()
                self._offset = 0
        return bytes(out)


class StreamingDecoder:
    """Push-based decoder: emits samples as soon as whole blocks arrive.

    Exploits block self-containedness (reference: src/aad_decoder.c:363-380)
    — each pushed span of complete blocks decodes independently, so latency
    is one block regardless of stream length.
    """

    def __init__(self, engine: str = "auto"):
        # Hybrid dispatch, mirroring the one-shot decode(): per-push decodes
        # pay a dispatch and two transfers on an accelerator, so auto routes
        # to the native host engine; explicit JAX engines override.
        from ..ops.decode import resolve_engine

        self._engine = resolve_engine(engine, native="always")
        self._native = None
        if self._engine == "native":
            from .. import native

            self._native = native
        self._buffer = _ByteFIFO()
        self._header = None
        self._geometry = None
        self._decoder = None
        self._samples_out = 0

    @property
    def header(self) -> HeaderInfo | None:
        return self._header

    def push(self, data: bytes) -> np.ndarray:
        """Feed stream bytes; returns (C, n) decoded samples (n may be 0)."""
        self._buffer.append(bytes(data))
        if self._header is None:
            from ..constants import FILE_HEADER_SIZE
            from ..format.geometry import geometry_from_header

            if len(self._buffer) < FILE_HEADER_SIZE:
                return self._empty()
            header = decode_header(self._buffer.pop(FILE_HEADER_SIZE))
            validate_header(header)
            self._header = header
            self._geometry = geometry_from_header(
                header.num_channels, header.bits_per_sample, header.block_size
            )
            if self._native is None:
                from .decoder import Decoder

                self._decoder = Decoder.from_header(
                    header, engine=self._engine
                )

        h = self._header
        geo = self._geometry
        nspb = h.num_samples_per_block
        remaining_samples = h.num_samples - self._samples_out
        if remaining_samples <= 0:
            return self._empty()

        # Collect every decodable block in the buffer (the stream's final
        # block may be shorter on the wire), then decode them as one batch.
        block_rows = []
        valids = []
        while remaining_samples > 0:
            is_last = remaining_samples <= nspb
            valid = min(nspb, remaining_samples)
            need = (
                encoded_block_bytes(geo, valid) if is_last else geo.block_size
            )
            if len(self._buffer) < need:
                break
            row = np.zeros(geo.block_size, dtype=np.uint8)
            row[:need] = np.frombuffer(self._buffer.pop(need), dtype=np.uint8)
            block_rows.append(row)
            valids.append(valid)
            self._samples_out += valid
            remaining_samples -= valid

        if not block_rows:
            return self._empty()

        if self._native is not None:
            # Headerless whole-block span; 4 bytes of tail slack keep the
            # AVX-512 gathers in bounds (native/aadx.cc::simd_decode_prefix).
            payload = np.concatenate(
                block_rows + [np.zeros(4, dtype=np.uint8)]
            )
            emit = int(sum(valids))
            out = self._native.decode_payload_blocks(payload, h, emit)
            return out.astype(np.int16, copy=False)

        dec = self._decoder
        from ..ops.wire32 import block_rows_to_words_split
        from .decoder import _bucket_blocks, _device_pipeline_words_jit

        # Bucket the batch size so varying push cadences reuse compiled
        # shapes; padding rows decode garbage that is never emitted. The
        # decode itself is the u32 wire pipeline (no byte tensors on
        # device; see codec.decoder._device_pipeline_words).
        n_real = len(block_rows)
        n_pad = _bucket_blocks(n_real)
        if dec.engine != "scan":
            from .decoder import _lane_multiple

            mult = _lane_multiple(geo)
            n_pad = -(-n_pad // mult) * mult
        hdr_w, data_w = block_rows_to_words_split(
            np.stack(block_rows), geo, n_pad
        )

        lanes = _device_pipeline_words_jit(
            jnp.asarray(hdr_w),
            jnp.asarray(data_w),
            geo=geo,
            num_blocks=n_pad,
            bits_per_sample=h.bits_per_sample,
            ms=h.ch_process_method == CH_PROCESS_MS,
            engine=dec.engine,
        )
        full = np.asarray(lanes).reshape(geo.num_channels, n_pad * nspb)
        out = [
            full[:, b * nspb : b * nspb + v] for b, v in enumerate(valids)
        ]
        return np.concatenate(out, axis=1)

    def _empty(self) -> np.ndarray:
        # Channel count is unknown until the header has arrived.
        nch = self._header.num_channels if self._header else 0
        return np.empty((nch, 0), dtype=np.int16)
