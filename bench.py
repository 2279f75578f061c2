#!/usr/bin/env python
"""Headline benchmark: on-device decode throughput, samples/sec/chip.

Prints exactly one JSON line:
    {"metric": "decode_samples_per_sec", "value": N, "unit": "samples/s",
     "vs_baseline": N / <C reference decode samples/s>}

Method: a large synthetic stereo stream (valid headers, random codes — the
decode data path is branch-free, so random codes are performance-
representative) is decoded end-to-end on device: bitstream split/parse,
the fused decode kernel (or the scan engine), channel recombination. Timing
serialises iterations through a data dependency and materialises the result,
so asynchronous dispatch cannot fake completion. The JSON line names the
platform, device kind and device count it ran on. Without a GPU the
benchmark exits non-zero before any device measurement.

Baselines: the reference C codec measured end-to-end via its CLI, live on
this host — the binary is built out-of-tree on demand from /root/reference
(oracle only, never linked). Recorded constants (decode 25.4e6, encode
6.3e6 samples/s, from a faster machine class) are used only when the
sources or compiler are unavailable.
"""

from __future__ import annotations

import functools
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

# Persist compiled executables across bench invocations: honour
# JAX_COMPILATION_CACHE_DIR, else a fixed directory inside the checkout.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    str(pathlib.Path(__file__).resolve().parent / ".jax_cache"),
)

# Default recorded baselines (C reference CLI wall clock, see docstring).
# Used only when the reference sources are unavailable to re-measure live.
C_DECODE_BASELINE = 25.4e6
C_ENCODE_BASELINE = 6.3e6
REF_BINARY = pathlib.Path(os.environ.get("AAD_REF_BINARY", "/tmp/refbuild/aad"))
REF_SOURCES = pathlib.Path(
    os.environ.get("AAD_TPU_REFERENCE_DIR", "/root/reference")
)

SECONDS = int(os.environ.get("AAD_BENCH_SECONDS", "600"))
RATE = 48000
NCH = 2
# Enough iterations to amortise the single dispatch's fixed cost against
# the per-iteration device time: the reported number is the sustained
# steady-state rate.
ITERS = int(os.environ.get("AAD_BENCH_ITERS", "400"))
ENC_ITERS = int(os.environ.get("AAD_BENCH_ENC_ITERS", "64"))


def build_synthetic_stream(num_samples: int, cfg=None, seed: int = 0):
    """Construct a valid .aad payload with random codes directly (fast).

    ``cfg`` (an EncodeConfig) sets the geometry; the default is the bench
    workload's: stereo, 48 kHz, the reference CLI defaults.
    """
    from aad_tpu.codec.encoder import EncodeConfig
    from aad_tpu.format.framing import BlockStates, assemble_stream, build_block_headers
    from aad_tpu.format.geometry import num_blocks_for
    from aad_tpu.format.header import encode_header

    if cfg is None:
        cfg = EncodeConfig(num_channels=NCH, sampling_rate=RATE)
    nch = cfg.num_channels
    geo = cfg.geometry()
    header = cfg.header_for(num_samples)
    nblocks = num_blocks_for(num_samples, geo.num_samples_per_block)

    rng = np.random.default_rng(seed)
    T = geo.codes_per_block
    codes = rng.integers(
        0, 2**cfg.bits_per_sample, (nblocks, nch, T), dtype=np.uint8
    )
    states = BlockStates(
        step_index=rng.integers(0, 4081, (nblocks, nch)).astype(np.int32),
        weight=rng.integers(-20000, 20000, (nblocks, nch, 4)).astype(np.int32),
        history=rng.integers(-32768, 32768, (nblocks, nch, 4)).astype(np.int32),
    )
    shifts = np.zeros((nblocks, nch), dtype=np.int32)
    hdr_bytes = build_block_headers(states, shifts, geo)
    payload = assemble_stream(hdr_bytes, codes, geo, num_samples)
    return encode_header(header) + payload.tobytes(), header


def _ensure_reference_binary() -> pathlib.Path | None:
    """Build the reference CLI out-of-tree on demand (conformance oracle only).

    Returns the binary path, or None when sources/compiler are unavailable.
    """
    if REF_BINARY.exists():
        return REF_BINARY
    if not (REF_SOURCES / "src").is_dir() or not (REF_SOURCES / "Makefile").exists():
        return None
    try:
        import shutil

        if shutil.which("gcc") is None:
            return None
        build = REF_BINARY.parent
        build.mkdir(parents=True, exist_ok=True)
        if not (build / "src").exists():
            shutil.copytree(REF_SOURCES / "src", build / "src")
            shutil.copy(REF_SOURCES / "Makefile", build / "Makefile")
        subprocess.run(
            ["make", "-s"], cwd=build, check=True, capture_output=True, timeout=120
        )
        return REF_BINARY if REF_BINARY.exists() else None
    except Exception:
        return None


def measure_reference_baselines() -> tuple[float, float]:
    """(decode, encode) samples/s of the C reference CLI, measured live on
    this host when possible; recorded constants otherwise.

    Live measurement keeps ``vs_baseline`` honest across host speeds — the
    recorded constants came from a faster machine class.
    """
    binary = _ensure_reference_binary()
    if binary is None:
        return C_DECODE_BASELINE, C_ENCODE_BASELINE
    try:
        sys.path.insert(0, str(pathlib.Path(__file__).parent / "tests"))
        from util import write_pcm16_wav  # type: ignore

        n = RATE * 60
        t = np.arange(n) / RATE
        sig = (0.4 * 32767 * np.sin(2 * np.pi * 440 * t)).astype(np.int32)
        pcm = np.stack([sig, np.roll(sig, 11)])
        wav = pathlib.Path("/tmp/aad_bench_ref_in.wav")
        write_pcm16_wav(wav, pcm, RATE)
        aad = pathlib.Path("/tmp/aad_bench_ref.aad")
        enc_best = 0.0
        for _ in range(3):  # best-of-3: most favourable to the reference
            t0 = time.time()
            subprocess.run(
                [str(binary), "-e", str(wav), str(aad)],
                check=True, capture_output=True, timeout=300,
            )
            enc_best = max(enc_best, (n * NCH) / (time.time() - t0))
        dec_best = 0.0
        for _ in range(3):
            t0 = time.time()
            subprocess.run(
                [str(binary), "-d", str(aad), "/tmp/aad_bench_ref_out.wav"],
                check=True, capture_output=True, timeout=300,
            )
            dec_best = max(dec_best, (n * NCH) / (time.time() - t0))
        return dec_best, enc_best
    except Exception:
        return C_DECODE_BASELINE, C_ENCODE_BASELINE


def main() -> None:
    import jax
    import jax.numpy as jnp
    from jax import lax

    from aad_tpu import FILE_HEADER_SIZE, decode_header
    from aad_tpu.codec.decoder import (
        Decoder,
        _device_pipeline_words,
        _lane_multiple,
    )
    from aad_tpu.ops.wire32 import payload_to_words_split

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {jax.devices()[0].platform!r}")

    num_samples = RATE * SECONDS
    data, _ = build_synthetic_stream(num_samples)
    header = decode_header(data)
    dec = Decoder.from_header(header)

    payload = np.frombuffer(data, dtype=np.uint8)[FILE_HEADER_SIZE:]
    nblocks = -(-header.num_samples // header.num_samples_per_block)
    # whole lane blocks for the fused kernel
    mult = _lane_multiple(dec.geometry)
    nblocks = -(-nblocks // mult) * mult
    hdr_np, data_np = payload_to_words_split(payload, dec.geometry, nblocks)
    hdr_w, data_w = jnp.asarray(hdr_np), jnp.asarray(data_np)

    def make_run(ms: bool):
        kwargs = dict(
            geo=dec.geometry,
            num_blocks=nblocks,
            bits_per_sample=header.bits_per_sample,
            ms=ms,
            engine=dec.engine,
        )

        @functools.partial(jax.jit, static_argnums=(3,))
        def run(hdr_w, data_w, token, iters):
            # The whole iteration loop runs in ONE dispatch: each iteration
            # perturbs one payload word with the previous iteration's token
            # (serialising the chain) and the full decoded output rides in
            # the loop carry, so XLA must materialise every iteration's
            # samples — no dead-code elimination, no per-iteration
            # dispatch.
            def body(_, carry):
                hw, dw, out, tok = carry
                dw = dw.at[0, 0].set((tok & 1).astype(jnp.uint32))
                out = _device_pipeline_words(hw, dw, **kwargs)
                return (hw, dw, out, out[(-1,) * out.ndim].astype(jnp.int32))

            out0 = _device_pipeline_words(hdr_w, data_w, **kwargs)
            return lax.fori_loop(
                0, iters, body,
                (hdr_w, data_w, out0,
                 out0[(-1,) * out0.ndim].astype(jnp.int32)),
            )

        return run

    samples = header.num_samples * header.num_channels

    def timed_rate(run, iters):
        hw, dw, out, token = run(hdr_w, data_w, jnp.int32(0), iters)
        float(token)  # warm-up + materialise
        t0 = time.time()
        hw, dw, out, token = run(hdr_w, data_w, token, iters)
        float(token)  # force the full chain
        # fori body + the init pipeline
        return samples / ((time.time() - t0) / (iters + 1))

    value = timed_rate(make_run(ms=False), ITERS)
    # The MS -> LR reconstruction pass (reference src/aad_decoder.c:458-470)
    # on the same stream: same methodology, same stream, ms=True pipeline.
    ms_value = timed_rate(make_run(ms=True), ITERS)
    baseline, enc_baseline = measure_reference_baselines()

    enc_value = measure_encode()
    extra = {}
    if ms_value:
        extra["decode_ms_samples_per_sec"] = round(ms_value)
        extra["decode_ms_vs_baseline"] = round(ms_value / baseline, 2)
    if enc_value:
        extra["encode_samples_per_sec"] = round(enc_value)
        extra["encode_vs_baseline"] = round(enc_value / enc_baseline, 2)
    single_value = measure_encode_single_stream()
    if single_value:
        extra["encode_single_stream_samples_per_sec"] = round(single_value)
        extra["encode_single_stream_vs_baseline"] = round(
            single_value / enc_baseline, 2
        )
    e2e = measure_decode_e2e(data, header)
    if e2e:
        extra["decode_e2e_samples_per_sec"] = round(e2e)
        extra["decode_e2e_vs_baseline"] = round(e2e / baseline, 2)
    e2e_dev = measure_decode_e2e_device(data, header)
    if e2e_dev:
        extra["decode_e2e_device_samples_per_sec"] = round(e2e_dev)
        extra["decode_e2e_device_vs_baseline"] = round(e2e_dev / baseline, 2)
    par_value = measure_encode_parallel()
    if par_value:
        extra["encode_parallel_samples_per_sec"] = round(par_value)
        extra["encode_parallel_vs_baseline"] = round(
            par_value / enc_baseline, 2
        )
    par_native = measure_encode_parallel_native()
    if par_native:
        extra["encode_parallel_native_samples_per_sec"] = round(par_native)
        extra["encode_parallel_native_vs_baseline"] = round(
            par_native / enc_baseline, 2
        )
    stream_enc, stream_dec = measure_streaming()
    if stream_enc:
        extra["encode_streaming_samples_per_sec"] = round(stream_enc)
        extra["encode_streaming_vs_baseline"] = round(
            stream_enc / enc_baseline, 2
        )
    if stream_dec:
        extra["decode_streaming_samples_per_sec"] = round(stream_dec)
        extra["decode_streaming_vs_baseline"] = round(
            stream_dec / baseline, 2
        )
    print(
        json.dumps(
            {
                "metric": "decode_samples_per_sec",
                "value": round(value),
                "unit": "samples/s",
                "vs_baseline": round(value / baseline, 2),
                "platform": jax.devices()[0].platform,
                "device_kind": jax.devices()[0].device_kind,
                "device_count": len(jax.devices()),
                **extra,
            }
        )
    )


def measure_encode():
    """Secondary metric: batch encode throughput (trials=2, the CLI default).

    Measures the complete device encode pipeline — trial search, code
    emission, block-header packing and wire-word assembly (the encoder
    counterpart of the decode metric's fully-fused pipeline); only the
    host's free byte view is outside the timed region. Returns samples/s;
    0 on failure.
    """
    try:
        import jax
        import jax.numpy as jnp

        from aad_tpu.codec.encoder import EncodeConfig, _encode_device_wire

        from jax import lax

        cfg = EncodeConfig(num_channels=NCH, sampling_rate=RATE)
        geo = cfg.geometry()
        nspb = geo.num_samples_per_block
        S, B = 4096, 4
        sig = (9000 * np.sin(np.arange(S * B * NCH * nspb) / 17)).astype(np.int32)
        # folded lanes (B, C*S, nspb) — the batch API's staging (see
        # codec.batch_encode)
        blocks = jnp.asarray(sig.reshape(B, S * NCH, nspb))
        valid = jnp.full((B, S * NCH), nspb, dtype=jnp.int32)
        total = S * B * NCH * nspb

        def pipeline(bl):
            return _encode_device_wire(
                bl, valid, geo=geo, num_trials=cfg.num_encode_trials,
                ms=False, lanes_folded=True,
            )

        @functools.partial(jax.jit, donate_argnums=(0,), static_argnums=(2,))
        def run(bl, tok, iters):
            # whole loop in ONE dispatch, chained through the token (the
            # same methodology as the decode metric). The input buffer is
            # donated and the perturbed array itself is carried, so the
            # per-iteration perturbation is an in-place 4-byte write, not
            # a copy of the whole input.
            def body(_, carry):
                bl, out, tok = carry
                bl = bl.at[0, 0, 0].set(tok & 1)
                out = pipeline(bl)
                return (bl, out, out[0, 0, 0].astype(jnp.int32))

            out0 = pipeline(bl)
            return lax.fori_loop(
                0, iters, body, (bl, out0, out0[0, 0, 0].astype(jnp.int32))
            )

        iters = ENC_ITERS
        bl, out, tok = run(blocks, jnp.int32(0), iters)
        float(tok)
        t0 = time.time()
        bl, out, tok = run(bl, tok, iters)
        float(tok)
        dt = (time.time() - t0) / (iters + 1)
        return total / dt
    except Exception:
        return 0


def measure_encode_parallel():
    """Block-independent parallel encode of ONE stream (trials=2).

    The framework's own mode (no reference equivalent): every block
    encodes from a fresh state, so a single stream's blocks ride the
    kernel lane axis — the sequential single-stream latency bound
    disappears. Measures the full device pipeline (trial search, code
    emission, header packing, wire assembly) on one ~340 s stereo stream.
    Returns samples/s; 0 on failure.
    """
    try:
        import jax
        import jax.numpy as jnp
        from jax import lax

        from aad_tpu.codec.encoder import EncodeConfig, _encode_device_wire

        cfg = EncodeConfig(num_channels=NCH, sampling_rate=RATE)
        geo = cfg.geometry()
        nspb = geo.num_samples_per_block
        B = 16384  # one ~340 s stereo stream; smaller B is glue-dominated
        sig = (9000 * np.sin(np.arange(B * NCH * nspb) / 17)).astype(np.int32)
        # channel-major folded lanes (C*B, nspb) — the flat staging the
        # public parallel encode path uses (see _pad_to_lanes_flat)
        blocks = jnp.asarray(sig.reshape(B * NCH, nspb))
        valid = jnp.full(B * NCH, nspb, dtype=jnp.int32)
        total = B * NCH * nspb

        def pipeline(bl):
            return _encode_device_wire(
                bl, valid, geo=geo, num_trials=cfg.num_encode_trials,
                ms=False, parallel=True,
            )

        @functools.partial(jax.jit, donate_argnums=(0,), static_argnums=(2,))
        def run(bl, tok, iters):
            # donated input + carried perturbed array: in-place 4-byte
            # write instead of a full copy per iteration (see
            # measure_encode).
            def body(_, carry):
                bl, out, tok = carry
                bl = bl.at[0, 0].set(tok & 1)
                out = pipeline(bl)
                return (bl, out, out[0, 0].astype(jnp.int32))

            out0 = pipeline(bl)
            return lax.fori_loop(
                0, iters, body, (bl, out0, out0[0, 0].astype(jnp.int32))
            )

        iters = ENC_ITERS
        bl, out, tok = run(blocks, jnp.int32(0), iters)
        float(tok)
        t0 = time.time()
        bl, out, tok = run(bl, tok, iters)
        float(tok)
        dt = (time.time() - t0) / (iters + 1)
        return total / dt
    except Exception:
        return 0


def measure_streaming():
    """Streaming push-based encode + decode wall time (engine='auto').

    One-minute stereo stream pushed in 1-second chunks through
    StreamingEncoder, then the bytes dribbled back through
    StreamingDecoder in 64 KiB pushes — the progressive-transmission
    workload. Auto routes to the native chunk entries
    (aadx_encode_chunk / aadx_decode_blocks). Returns
    (encode samples/s, decode samples/s); 0s on failure.
    """
    try:
        from aad_tpu.codec.encoder import EncodeConfig
        from aad_tpu.codec.streaming import StreamingDecoder, StreamingEncoder

        cfg = EncodeConfig(num_channels=NCH, sampling_rate=RATE)
        n = RATE * 60
        t = np.arange(n) / RATE
        sig = (0.4 * 32767 * np.sin(2 * np.pi * 440 * t)).astype(np.int32)
        pcm = np.stack([sig, np.roll(sig, 11)])

        def run_encode():
            enc = StreamingEncoder(cfg, total_samples=n)
            parts = [enc.header()]
            for i in range(0, n, RATE):
                parts.append(enc.push(pcm[:, i : i + RATE]))
            parts.append(enc.finish())
            return b"".join(parts)

        data = run_encode()  # warm (library load / jit)
        enc_best = 0.0
        for _ in range(3):
            t0 = time.time()
            run_encode()
            enc_best = max(enc_best, pcm.size / (time.time() - t0))

        def run_decode():
            dec = StreamingDecoder()
            outs = [
                dec.push(data[i : i + 65536])
                for i in range(0, len(data), 65536)
            ]
            return outs[-1]

        run_decode()  # warm
        dec_best = 0.0
        for _ in range(3):
            t0 = time.time()
            run_decode()
            dec_best = max(dec_best, pcm.size / (time.time() - t0))
        return enc_best, dec_best
    except Exception:
        return 0, 0


def measure_encode_parallel_native():
    """Host-engine block-parallel encode of ONE stream (trials=2).

    The AVX-512 16-lane implementation of the block-independent mode
    (native/aadx.cc::aadx_encode_parallel, byte-pinned to the JAX parallel
    engines) — what a one-shot ``encode(pcm, cfg, parallel_blocks=True)``
    costs on a CPU-only host, pcm in -> bytes out wall time. Returns
    samples/s; 0 on failure.
    """
    try:
        from aad_tpu import native
        from aad_tpu.codec.encoder import EncodeConfig

        if not native.available():
            return 0
        cfg = EncodeConfig(num_channels=NCH, sampling_rate=RATE)
        n = RATE * 60
        t = np.arange(n) / RATE
        sig = (0.4 * 32767 * np.sin(2 * np.pi * 440 * t)).astype(np.int32)
        pcm = np.stack([sig, np.roll(sig, 11)])
        native.encode_parallel(pcm, cfg)  # warm (library load)
        best = 0.0
        for _ in range(3):
            t0 = time.time()
            native.encode_parallel(pcm, cfg)
            best = max(best, n * NCH / (time.time() - t0))
        return best
    except Exception:
        return 0


def measure_decode_e2e(data: bytes, header):
    """User-facing decode metric: the public ``aad_tpu.decode()`` wall time.

    ``bytes in -> PCM array out`` exactly as a caller gets it, with the
    default ``engine="auto"`` dispatch — which routes a one-shot host
    decode to the native engine (the device round trip costs more than the
    whole decode; see codec/decoder.py::decode). The device-path
    equivalent is ``decode_e2e_device``. Returns samples/s; 0 on failure.
    """
    try:
        import aad_tpu

        samples = header.num_samples * header.num_channels
        h, out = aad_tpu.decode(data)  # warm
        assert out.shape == (header.num_channels, header.num_samples)
        best = 0.0
        for _ in range(3):
            t0 = time.time()
            _, out = aad_tpu.decode(data)
            _ = out[0, -1], out[-1, 0]
            best = max(best, samples / (time.time() - t0))
        return best
    except Exception:
        return 0


def measure_decode_e2e_device(data: bytes, header):
    """Transfer-inclusive device decode metric.

    Wall time for ``bytes in -> int16 PCM out`` through
    ``Decoder.decode_payload_ondevice``: host wire-word view, payload
    upload, the device pipeline, sample download and the host int16 view —
    what a caller of the device path pays per one-shot stream, unlike the
    headline metric's device-resident loop. It takes the chunked
    transfer-overlap schedule by default (chunk i's download streams while
    chunk i+1 uploads and decodes). Returns samples/s (best of 3); 0 on
    failure.
    """
    try:
        from aad_tpu import FILE_HEADER_SIZE, decode_header
        from aad_tpu.codec.decoder import Decoder

        dec = Decoder.from_header(decode_header(data[:FILE_HEADER_SIZE]))
        payload = np.frombuffer(data, dtype=np.uint8)[FILE_HEADER_SIZE:]
        C, N = header.num_channels, header.num_samples
        out = dec.decode_payload_ondevice(payload)  # warm/compile
        assert out.shape == (C, N)
        best = float("inf")
        for _ in range(3):
            t0 = time.time()
            out = dec.decode_payload_ondevice(payload)
            _ = out[0, -1], out[-1, 0]  # touch the host view
            best = min(best, time.time() - t0)
        return N * C / best
    except Exception as exc:  # noqa: BLE001 - metric is best-effort
        print(f"measure_decode_e2e_device failed: {exc!r}", file=sys.stderr)
        return 0


def measure_encode_single_stream():
    """Single-stream encode latency metric.

    Measures the framework's auto-routed single-stream path: one stereo
    stream through ``aad_tpu.encode`` (engine="auto" -> the native engine;
    a lone stream is a serial sample chain, see docs/DESIGN.md §3).
    Baseline: the reference C encoder measured live on this host (see
    measure_reference_baselines). Returns samples/s; 0 on failure.
    """
    try:
        from aad_tpu.codec.encoder import EncodeConfig, encode

        cfg = EncodeConfig(num_channels=NCH, sampling_rate=RATE)
        n = RATE * 60
        t = np.arange(n) / RATE
        sig = (0.4 * 32767 * np.sin(2 * np.pi * 440 * t)).astype(np.int32)
        pcm = np.stack([sig, np.roll(sig, 11)])
        encode(pcm, cfg)  # warm
        best = 0.0
        for _ in range(3):
            t0 = time.time()
            encode(pcm, cfg)
            best = max(best, n * NCH / (time.time() - t0))
        return best
    except Exception:
        return 0


if __name__ == "__main__":
    main()
