"""ctypes bindings for the native host codec (libaadx).

The native path exists for latency: JAX compiles per shape (seconds); the
native codec is instant, so small files, CLI cold starts and CPU-only hosts
use it while large batched workloads go to the device pipeline. It is built
on demand with the in-tree Makefile and cached next to the sources.

Usage:
    from aad_tpu import native
    if native.available():
        data = native.encode(pcm, config)
        header, pcm = native.decode(data)
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

from ..codec.result import (
    AadError,
    ApiResult,
    InsufficientBufferError,
    InsufficientDataError,
    InvalidArgumentError,
    InvalidFormatError,
)
from ..format.header import HeaderInfo

_DIR = pathlib.Path(__file__).parent
_LIB_PATH = _DIR / "libaadx.so"
_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
_build_failed = False


class _AadxInfo(ctypes.Structure):
    _fields_ = [
        ("format_version", ctypes.c_uint32),
        ("codec_version", ctypes.c_uint32),
        ("num_channels", ctypes.c_uint32),
        ("num_samples", ctypes.c_uint32),
        ("sampling_rate", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_uint32),
        ("block_size", ctypes.c_uint32),
        ("num_samples_per_block", ctypes.c_uint32),
        ("ch_process_method", ctypes.c_uint32),
    ]


_ERRORS = {
    1: InvalidArgumentError,
    2: InvalidFormatError,
    3: InsufficientBufferError,
    4: InsufficientDataError,
}


def _raise(rc: int, where: str):
    if rc == 0:
        return
    exc = _ERRORS.get(rc)
    if exc is None:
        raise AadError(ApiResult.NG, f"{where}: native status {rc}")
    raise exc(f"{where} (native)")


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-s"], cwd=_DIR, check=True, capture_output=True, timeout=120
        )
        return _LIB_PATH.exists()
    except Exception:
        return False


def _load() -> "ctypes.CDLL | None":
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        # AAD_TPU_NATIVE_LIB points at a prebuilt libaadx (e.g. a sanitizer
        # build from tools/run_sanitizer_fuzz.py, or a deployment artifact);
        # it bypasses the in-tree build entirely. A missing path is a loud
        # error: an explicit operator override must never silently degrade
        # to the (orders-of-magnitude slower on CPU hosts) JAX fallback.
        override = os.environ.get("AAD_TPU_NATIVE_LIB")
        if override:
            lib_path = pathlib.Path(override)
            if not lib_path.exists():
                raise FileNotFoundError(
                    f"AAD_TPU_NATIVE_LIB={override!r} does not exist"
                )
        else:
            lib_path = _LIB_PATH
            src_mtime = max(
                (p.stat().st_mtime for p in (_DIR / "aadx.cc", _DIR / "aadx.h")),
            )
            if not lib_path.exists() or lib_path.stat().st_mtime < src_mtime:
                if not _build():
                    _build_failed = True
                    return None
        lib = ctypes.CDLL(str(lib_path))
        # Full argtypes, not just restypes: the C entries take size_t, and
        # an undeclared Python int crosses the FFI as a 32-bit c_int whose
        # upper half of the 64-bit register/stack slot is undefined —
        # bounds checks against such a capacity are meaningless.
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        szp = ctypes.POINTER(ctypes.c_size_t)
        infop = ctypes.POINTER(_AadxInfo)
        u32 = ctypes.c_uint32
        sz = ctypes.c_size_t
        lib.aadx_parse_header.restype = ctypes.c_int
        lib.aadx_parse_header.argtypes = [u8p, sz, infop]
        lib.aadx_decode.restype = ctypes.c_int
        lib.aadx_decode.argtypes = [u8p, sz, i32p, sz, infop]
        lib.aadx_encode.restype = ctypes.c_int
        lib.aadx_encode.argtypes = [
            i32p, u32, u32, u32, u32, u32, u32, u32, u8p, sz, szp,
        ]
        lib.aadx_encode_parallel.restype = ctypes.c_int
        lib.aadx_encode_parallel.argtypes = [
            i32p, u32, u32, u32, u32, u32, u32, u32, u32, u32, u8p, sz, szp,
        ]
        lib.aadx_encode_bound.restype = sz
        lib.aadx_encode_bound.argtypes = [u32, u32, u32, u32]
        lib.aadx_block_geometry.restype = ctypes.c_int
        lib.aadx_block_geometry.argtypes = [u32, u32, u32, u32p, u32p]
        lib.aadx_encode_chunk.restype = ctypes.c_int
        lib.aadx_encode_chunk.argtypes = [
            i32p, u32, u32, u32, u32, u32, u32, u32, u32,
            i32p, i32p, u8p, sz, szp,
        ]
        lib.aadx_decode_blocks.restype = ctypes.c_int
        lib.aadx_decode_blocks.argtypes = [u8p, sz, u32, i32p, sz, infop]
        _lib = lib
        return lib


def available() -> bool:
    """True when the native library is (or can be) built and loaded."""
    return _load() is not None


def _as_header(info: _AadxInfo) -> HeaderInfo:
    return HeaderInfo(
        format_version=info.format_version,
        codec_version=info.codec_version,
        num_channels=info.num_channels,
        num_samples=info.num_samples,
        sampling_rate=info.sampling_rate,
        bits_per_sample=info.bits_per_sample,
        block_size=info.block_size,
        num_samples_per_block=info.num_samples_per_block,
        ch_process_method=info.ch_process_method,
    )


def decode(data: bytes | np.ndarray) -> tuple[HeaderInfo, np.ndarray]:
    """Native whole-stream decode; same contract as aad_tpu.decode."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)
    ) else np.ascontiguousarray(data, dtype=np.uint8)

    info = _AadxInfo()
    rc = lib.aadx_parse_header(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        buf.size,
        ctypes.byref(info),
    )
    _raise(rc, "parse_header")
    out = np.empty(info.num_channels * info.num_samples, dtype=np.int32)
    rc = lib.aadx_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        buf.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.size,
        ctypes.byref(info),
    )
    _raise(rc, "decode")
    return _as_header(info), out.reshape(info.num_channels, info.num_samples)


def _check_pcm(pcm: np.ndarray, config) -> np.ndarray:
    """Shared shape gate: pcm must be (config.num_channels, N).

    The C entry derives the stream geometry from the array shape, so a
    mismatched config would otherwise be silently ignored where the JAX
    engines raise (codec/encoder.py::Encoder.encode).
    """
    pcm = np.ascontiguousarray(pcm, dtype=np.int32)
    if pcm.ndim != 2 or pcm.shape[0] != config.num_channels:
        from ..codec.result import InvalidArgumentError

        raise InvalidArgumentError(
            f"pcm must be ({config.num_channels}, N); got {pcm.shape}"
        )
    return pcm


def encode(pcm: np.ndarray, config) -> bytes:
    """Native whole-stream encode; same contract as aad_tpu.codec.encode."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    pcm = _check_pcm(pcm, config)
    nch, n = pcm.shape
    bound = lib.aadx_encode_bound(
        nch, n, config.bits_per_sample, config.max_block_size
    )
    if bound == 0:
        raise InvalidFormatError("bad encode parameters (native)")
    out = np.empty(bound, dtype=np.uint8)
    out_size = ctypes.c_size_t()
    rc = lib.aadx_encode(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nch,
        n,
        config.sampling_rate,
        config.bits_per_sample,
        config.max_block_size,
        config.ch_process_method,
        config.num_encode_trials,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size,
        ctypes.byref(out_size),
    )
    _raise(rc, "encode")
    return out[: out_size.value].tobytes()


def encode_parallel(
    pcm: np.ndarray, config, chunk_blocks: int = 1, warm_passes: int = 0
) -> bytes:
    """Native block-independent (parallel-mode) encode.

    Byte-identical to ``aad_tpu.encode(pcm, config, parallel_blocks=True,
    parallel_chunk_blocks=chunk_blocks,
    parallel_warm_passes=warm_passes)``: chunks of ``chunk_blocks``
    blocks encode sequentially within (full trial warm-up) and in
    parallel across chunks on the AVX-512 lanes; ``warm_passes`` adds the
    Jacobi chunk-head refinement (scalar warm walks feeding the SIMD
    final encode) — the host-engine counterpart of
    ops/encode.py::encode_blocks_parallel and its quality knobs
    (docs/DESIGN.md §1a).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    if chunk_blocks < 1:
        raise InvalidArgumentError(f"chunk_blocks must be >= 1: {chunk_blocks}")
    if warm_passes < 0:
        raise InvalidArgumentError(f"warm_passes must be >= 0: {warm_passes}")
    pcm = _check_pcm(pcm, config)
    nch, n = pcm.shape
    bound = lib.aadx_encode_bound(
        nch, n, config.bits_per_sample, config.max_block_size
    )
    if bound == 0:
        raise InvalidFormatError("bad encode parameters (native)")
    out = np.empty(bound, dtype=np.uint8)
    out_size = ctypes.c_size_t()
    rc = lib.aadx_encode_parallel(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nch,
        n,
        config.sampling_rate,
        config.bits_per_sample,
        config.max_block_size,
        config.ch_process_method,
        config.num_encode_trials,
        chunk_blocks,
        warm_passes,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size,
        ctypes.byref(out_size),
    )
    _raise(rc, "encode_parallel")
    return out[: out_size.value].tobytes()


def stream_state(config) -> tuple[np.ndarray, np.ndarray]:
    """Fresh (state, prev) carry for :func:`encode_chunk`.

    ``state`` is (C, 9) int32 — h[4], w[4], idx per channel; ``prev`` is
    (C, num_samples_per_block) int32, the previous block in the
    channel-transformed domain. Both are mutated in place by encode_chunk.
    """
    geo = config.geometry()
    return (
        np.zeros((config.num_channels, 9), dtype=np.int32),
        np.zeros(
            (config.num_channels, geo.num_samples_per_block), dtype=np.int32
        ),
    )


def encode_chunk(
    pcm: np.ndarray, config, state: np.ndarray, prev: np.ndarray,
    blocks_before: int,
) -> bytes:
    """Encode one streaming chunk, continuing the chain in (state, prev).

    Returns the chunk's payload bytes (no file header). Concatenating the
    header and every chunk's bytes reproduces the one-shot
    :func:`encode` stream exactly — the native counterpart of
    ops/encode.py::encode_stream_blocks_carry, serving StreamingEncoder's
    hybrid dispatch off-accelerator.

    Every chunk except the stream's last must be a whole number of blocks
    (StreamingEncoder buffers to guarantee this); a short chunk is encoded
    as a final truncated block, so pushing more data after one produces a
    divergent stream.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    pcm = _check_pcm(pcm, config)
    nch, n = pcm.shape
    bound = lib.aadx_encode_bound(
        nch, n, config.bits_per_sample, config.max_block_size
    )
    if bound == 0:
        raise InvalidFormatError("bad encode parameters (native)")
    nspb = config.geometry().num_samples_per_block
    if not (
        state.dtype == np.int32 and state.flags.c_contiguous
        and state.shape == (nch, 9)
        and prev.dtype == np.int32 and prev.flags.c_contiguous
        and prev.shape == (nch, nspb)
    ):
        # The C write-back memcpys (nch, 9) / (nch, nspb) into these, so a
        # carry built for a different config would corrupt the heap.
        raise InvalidArgumentError(
            f"carry must be C-contiguous int32 of shapes ({nch}, 9) and "
            f"({nch}, {nspb}); got {state.shape}/{state.dtype}, "
            f"{prev.shape}/{prev.dtype} (use stream_state(config))"
        )
    out = np.empty(bound, dtype=np.uint8)
    out_size = ctypes.c_size_t()
    rc = lib.aadx_encode_chunk(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nch,
        n,
        config.sampling_rate,
        config.bits_per_sample,
        config.max_block_size,
        config.ch_process_method,
        config.num_encode_trials,
        blocks_before,
        state.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        prev.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size,
        ctypes.byref(out_size),
    )
    _raise(rc, "encode_chunk")
    return out[: out_size.value].tobytes()


def decode_payload_blocks(
    payload: np.ndarray, header: HeaderInfo, num_samples: int
) -> np.ndarray:
    """Decode whole blocks from a headerless payload span.

    ``payload`` holds back-to-back blocks (the final one may be zero-padded
    to block_size); ``num_samples`` per channel are emitted. Block
    self-containedness makes chunk boundaries invisible — the native
    counterpart of StreamingDecoder's device pipeline.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    buf = np.ascontiguousarray(payload, dtype=np.uint8)
    info = _AadxInfo(
        format_version=header.format_version,
        codec_version=header.codec_version,
        num_channels=header.num_channels,
        num_samples=header.num_samples,
        sampling_rate=header.sampling_rate,
        bits_per_sample=header.bits_per_sample,
        block_size=header.block_size,
        num_samples_per_block=header.num_samples_per_block,
        ch_process_method=header.ch_process_method,
    )
    out = np.empty(header.num_channels * num_samples, dtype=np.int32)
    rc = lib.aadx_decode_blocks(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        buf.size,
        num_samples,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.size,
        ctypes.byref(info),
    )
    _raise(rc, "decode_blocks")
    return out.reshape(header.num_channels, num_samples)


def encode_batch(
    streams, config, max_workers: int | None = None,
    parallel_blocks: bool = False, chunk_blocks: int = 1,
    warm_passes: int = 0,
) -> list[bytes]:
    """Threaded native batch encode: one GIL-free C call per stream.

    The C API is stateless per call (all work memory is local to
    aadx_encode — aadx.cc keeps no globals), and ctypes drops the GIL for
    the duration of every foreign call, so a plain thread pool scales the
    single-stream engine with host core count (the pool sizes itself to
    os.cpu_count()). This is the CPU-host counterpart of
    the device batch pipeline; results are byte-identical to per-stream
    native encodes (and therefore to the reference binary). With
    ``parallel_blocks`` each stream uses the block-independent mode
    (:func:`encode_parallel`, the AVX-512 engine), with the
    ``chunk_blocks``/``warm_passes`` quality knobs passed through.
    """
    from concurrent.futures import ThreadPoolExecutor
    from functools import partial

    if _load() is None:
        raise RuntimeError("native codec unavailable")
    one = (
        partial(
            encode_parallel, chunk_blocks=chunk_blocks,
            warm_passes=warm_passes,
        )
        if parallel_blocks
        else encode
    )
    streams = list(streams)
    if len(streams) <= 1:
        return [one(pcm, config) for pcm in streams]
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(lambda pcm: one(pcm, config), streams))


def decode_batch(datas, max_workers: int | None = None):
    """Threaded native batch decode; see :func:`encode_batch`.

    Returns [(HeaderInfo, pcm[C, N] int32), ...] in input order.
    """
    from concurrent.futures import ThreadPoolExecutor

    if _load() is None:
        raise RuntimeError("native codec unavailable")
    datas = list(datas)
    if len(datas) <= 1:
        return [decode(d) for d in datas]
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(decode, datas))
