#!/usr/bin/env python
"""Smoke test of the codec's device paths on an NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --cards 4  # four cards: the sharded paths only

One card, real sizes, through the public entry points:

1. the card's name and power limit, and the engines "auto" resolves to;
2. headline decode: a 10-minute 48 kHz stereo 4-bit stream through
   ``Decoder.decode_payload_ondevice`` (whole-stream and chunked), then the
   same 10 minutes with MS, as mono 2-bit and as mono 3-bit 1023-byte
   blocks — each bit-identical to the native engine and to the scan engine;
3. ``decode_batch`` of 16 mixed streams, bit-identical to native;
4. device encode (scan engine): block-parallel ``encode`` of the 10-minute
   stream with default and chunk/warm settings, and ``encode_batch`` of 8
   stereo 10-second streams — each byte-identical to native;
5. the fused decode kernel against the scan engine: device pipeline and
   end-to-end decode times (the fused one both chunked and whole-stream);
6. the ``gpu``-marked tests, in this process.

``--cards 4`` runs only the multi-card path (sharded decode, sequence-
parallel encode with the ring handoff, sharded stream encode) and the
one-card runs it is compared with.

Every phase raises on a mismatch; the last line of standard output is a
JSON object with ``"ok": true`` and the device JAX reports. Without a GPU
the script exits non-zero before any phase and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

_ROOT = pathlib.Path(__file__).resolve().parent
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", str(_ROOT / ".jax_cache"))

RATE = 48000
TEN_MIN = RATE * 600


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn):
    """(result, seconds) of one call; the result is on the host."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def check_equal(name: str, got, want) -> None:
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"{name}: result differs from its reference")


def stream(seconds_samples: int, seed: int, **cfg_kw):
    import bench
    from aad_tpu.codec.encoder import EncodeConfig

    cfg = EncodeConfig(sampling_rate=RATE, **cfg_kw)
    data, header = bench.build_synthetic_stream(seconds_samples, cfg, seed)
    return data, header


def pcm_signal(nch: int, n: int, seed: int):
    """Sine plus noise, int16-valued, from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    sig = 9000 * np.sin(t / 17.0)[None, :] + rng.normal(0, 1500, (nch, n))
    return np.clip(sig, -32768, 32767).astype(np.int32)


def phase_engines() -> None:
    from aad_tpu.ops.decode import resolve_engine

    want = {  # API -> (engine "auto" resolves to, the device engine)
        "Decoder": (resolve_engine(), "fused"),
        "decode_batch": (resolve_engine(native="off_gpu"), "fused"),
        "encode_batch": (
            resolve_engine(direction="encode", native="off_gpu"), "scan"),
        "encode(parallel_blocks=True)": (
            resolve_engine(direction="encode", native="off_gpu"), "scan"),
        "Encoder": (resolve_engine(direction="encode"), "scan"),
    }
    log(f"[1] engines auto resolves to: "
        f"{ {api: got for api, (got, _) in want.items()} }")
    for api, (got, device) in want.items():
        if got != device:
            raise AssertionError(f"auto for {api} is {got}, not {device}")


def decode_three_ways(name: str, data: bytes, header, overlap: bool) -> None:
    """Device decode (fused) == scan engine on the card == native."""
    import numpy as np

    from aad_tpu import FILE_HEADER_SIZE, native
    from aad_tpu.codec.decoder import Decoder

    payload = np.frombuffer(data, np.uint8)[FILE_HEADER_SIZE:]
    _, want = native.decode(data)
    want = want.astype(np.int16)
    fused = Decoder.from_header(header, engine="fused")
    scan = Decoder.from_header(header, engine="scan")
    modes = {"whole": 0, "chunked": None} if overlap else {"whole": 0}
    for mode, ob in modes.items():
        out, first = timed(
            lambda: fused.decode_payload_ondevice(payload, overlap_blocks=ob))
        check_equal(f"{name} fused {mode} vs native", out, want)
        _, warm = timed(
            lambda: fused.decode_payload_ondevice(payload, overlap_blocks=ob))
        log(f"[2] {name} fused {mode}: first call {first:.3f} s, "
            f"warm {warm:.3f} s, == native")
    out, first = timed(lambda: scan.decode_payload_ondevice(
        payload, overlap_blocks=0))
    check_equal(f"{name} scan vs native", out, want)
    log(f"[2] {name} scan whole: first call {first:.3f} s, == native")


def phase_headline() -> None:
    data, header = stream(TEN_MIN, 0, num_channels=2)
    decode_three_ways("stereo 4-bit", data, header, overlap=True)
    data, header = stream(TEN_MIN, 1, num_channels=2, ch_process_method=1)
    decode_three_ways("stereo 4-bit MS", data, header, overlap=True)
    data, header = stream(TEN_MIN, 2, num_channels=1, bits_per_sample=2)
    decode_three_ways("mono 2-bit", data, header, overlap=True)
    data, header = stream(TEN_MIN, 3, num_channels=1, bits_per_sample=3,
                          max_block_size=1023)
    if header.num_samples_per_block != 2684:
        raise AssertionError("mono 3-bit 1023-byte blocks hold 2684 samples")
    decode_three_ways("mono 3-bit 1023-byte", data, header, overlap=True)


def phase_batch_decode() -> None:
    import numpy as np

    from aad_tpu import decode_batch, native

    rng = np.random.default_rng(11)
    streams = []
    for i in range(16):
        nch = 1 + i % 2
        kw = dict(num_channels=nch, bits_per_sample=2 + i % 3,
                  ch_process_method=int(nch == 2 and (i // 2) % 2 == 1))
        n = int(rng.integers(RATE, RATE * 300 + 1))
        streams.append(stream(n, 100 + i, **kw)[0])
    out, first = timed(lambda: decode_batch(streams))
    for i, (data, (_, pcm)) in enumerate(zip(streams, out)):
        _, want = native.decode(data)
        check_equal(f"decode_batch stream {i}", pcm, want.astype(np.int16))
    _, warm = timed(lambda: decode_batch(streams))
    total = sum(h.num_samples * h.num_channels for h, _ in out)
    log(f"[3] decode_batch of 16 mixed streams ({total} samples): first call "
        f"{first:.3f} s, warm {warm:.3f} s, == native")


def phase_encode() -> None:
    from aad_tpu import encode, encode_batch, native
    from aad_tpu.codec.encoder import EncodeConfig

    cfg = EncodeConfig(num_channels=2, sampling_rate=RATE)
    pcm = pcm_signal(2, TEN_MIN, 21)
    for kw in ({}, {"parallel_chunk_blocks": 64, "parallel_warm_passes": 1}):
        got, first = timed(
            lambda: encode(pcm, cfg, parallel_blocks=True, **kw))
        want = native.encode_parallel(
            pcm, cfg, chunk_blocks=kw.get("parallel_chunk_blocks", 1),
            warm_passes=kw.get("parallel_warm_passes", 0))
        if got != want:
            raise AssertionError(f"parallel encode {kw} differs from native")
        _, warm = timed(lambda: encode(pcm, cfg, parallel_blocks=True, **kw))
        log(f"[4] encode(parallel_blocks=True, {kw}) of 10 min stereo: "
            f"first call {first:.3f} s, warm {warm:.3f} s, == native")
    cfg = EncodeConfig(num_channels=2, sampling_rate=RATE,
                       num_encode_trials=2)
    streams = [pcm_signal(2, RATE * 10, 30 + s) for s in range(8)]
    got, first = timed(lambda: encode_batch(streams, cfg))
    if got != native.encode_batch(streams, cfg):
        raise AssertionError("encode_batch differs from native")
    _, warm = timed(lambda: encode_batch(streams, cfg))
    log(f"[4] encode_batch of 8 stereo 10 s streams (trials 2): first call "
        f"{first:.3f} s, warm {warm:.3f} s, == native")


def median_ms(fn, runs: int = 20) -> tuple[float, float, float]:
    """(median, first quartile, third quartile) in ms of ``runs`` calls."""
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    q = statistics.quantiles(ts, n=4)
    return statistics.median(ts), q[0], q[2]


def phase_kernel_vs_xla(card: str) -> None:
    import jax
    import numpy as np

    from aad_tpu import FILE_HEADER_SIZE
    from aad_tpu.codec.decoder import (
        Decoder,
        _device_pipeline_words_jit,
        _lane_multiple,
    )
    from aad_tpu.ops.wire32 import payload_to_words_split

    data, header = stream(TEN_MIN, 0, num_channels=2)
    payload = np.frombuffer(data, np.uint8)[FILE_HEADER_SIZE:]
    dec = Decoder.from_header(header, engine="fused")
    geo = dec.geometry
    nb = -(-header.num_samples // header.num_samples_per_block)
    mult = _lane_multiple(geo)
    nb = -(-nb // mult) * mult
    hw, dw = (jax.device_put(a) for a in payload_to_words_split(payload, geo, nb))
    outs = {}
    for engine in ("fused", "scan"):
        def run():
            return _device_pipeline_words_jit(
                hw, dw, geo=geo, num_blocks=nb, bits_per_sample=4, ms=False,
                engine=engine).block_until_ready()

        out, compile_s = timed(run)
        outs[engine] = np.asarray(out)
        med, q1, q3 = median_ms(run)
        log(f"[5] device pipeline {engine}: median {med:.3f} ms (q1 {q1:.3f},"
            f" q3 {q3:.3f}) of 20; first call {compile_s:.3f} s; {card}")
    check_equal("device pipeline fused vs scan", outs["fused"], outs["scan"])
    # overlap_blocks: None is the default (chunked for this stream), 0 whole
    for engine, ob in (("fused", None), ("fused", 0), ("scan", None)):
        d = Decoder.from_header(header, engine=engine)
        d.decode_payload_ondevice(payload, overlap_blocks=ob)  # warm
        med, q1, q3 = median_ms(
            lambda: d.decode_payload_ondevice(payload, overlap_blocks=ob))
        mode = "whole" if ob == 0 else "default"
        log(f"[5] decode_payload_ondevice {engine} {mode}: median {med:.3f} ms"
            f" (q1 {q1:.3f}, q3 {q3:.3f}) of 20; {card}")


def phase_gpu_tests() -> None:
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(_ROOT / "tests" / "test_engines_gpu.py")])
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest exit {rc})")
    log("[6] gpu-marked tests passed")


def phase_four_cards() -> None:
    """Sharded decode and encode on four cards, each against one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from aad_tpu.codec.encoder import EncodeConfig
    from aad_tpu.ops.decode import decode_blocks
    from aad_tpu.ops.encode import encode_blocks_parallel, encode_stream_blocks
    from aad_tpu.parallel.sharded import (
        decode_blocks_sharded,
        encode_blocks_parallel_sharded,
        encode_streams_sharded,
        make_mesh,
    )

    mesh = make_mesh(4)
    placed = sorted({d.id for d in mesh.devices.reshape(-1)})
    log(f"[4c] mesh {dict(mesh.shape)} over device ids {placed}")
    if placed != sorted(d.id for d in jax.devices()[:4]):
        raise AssertionError("the mesh does not span the four cards")
    cfg = EncodeConfig(num_channels=2, sampling_rate=RATE)
    geo = cfg.geometry()
    nspb, T = geo.num_samples_per_block, geo.codes_per_block
    B = -(-RATE * 3600 // nspb)  # one hour of stereo blocks
    L = 2 * B
    rng = np.random.default_rng(5)
    codes = jnp.asarray(rng.integers(0, 16, (L, T), dtype=np.uint8))
    si = jnp.asarray(rng.integers(0, 4081, L).astype(np.int32))
    w = jnp.asarray(rng.integers(-20000, 20000, (L, 4)).astype(np.int32))
    h = jnp.asarray(rng.integers(-32768, 32768, (L, 4)).astype(np.int32))
    one, t1 = timed(lambda: np.asarray(decode_blocks(
        codes, si, w, h, bits_per_sample=4)))
    out, t4 = timed(lambda: decode_blocks_sharded(
        codes, si, w, h, bits_per_sample=4, mesh=mesh))
    shards = sorted({s.device.id for s in out.addressable_shards})
    check_equal("sharded decode vs one card", np.asarray(out), one)
    log(f"[4c] decode_blocks_sharded, one hour ({L} lanes) on cards {shards}:"
        f" {t4:.3f} s (first call); one card {t1:.3f} s; bit-identical")
    _, t4w = timed(lambda: np.asarray(decode_blocks_sharded(
        codes, si, w, h, bits_per_sample=4, mesh=mesh)))
    _, t1w = timed(lambda: np.asarray(decode_blocks(
        codes, si, w, h, bits_per_sample=4)))
    log(f"[4c] decode warm: four cards {t4w:.3f} s, one card {t1w:.3f} s")

    pcm = pcm_signal(2, B * nspb, 6)
    blocks = jnp.asarray(np.moveaxis(pcm.reshape(2, B, nspb), 1, 0))
    valid = jnp.full((B,), nspb, jnp.int32)
    kw = dict(chunk_blocks=64, warm_passes=1)
    (h1, w1), t1 = timed(lambda: jax.block_until_ready(encode_blocks_parallel(
        blocks, valid, 4, cfg.num_encode_trials, **kw)))
    (h4, w4), t4 = timed(lambda: jax.block_until_ready(
        encode_blocks_parallel_sharded(
            blocks, valid, bits_per_sample=4,
            num_trials=cfg.num_encode_trials, mesh=mesh, **kw)))
    check_equal("sequence-parallel encode words", w4, w1)
    for a, b in zip(h4, h1):
        check_equal("sequence-parallel encode headers", a, b)
    log(f"[4c] encode_blocks_parallel_sharded, one hour, chunk 64, warm 1: "
        f"{t4:.3f} s (first call); one card {t1:.3f} s; byte-identical")

    S, n = 8, RATE * 10
    Bs = -(-n // nspb)
    pcm = np.stack([pcm_signal(2, Bs * nspb, 40 + s) for s in range(S)])
    pcm[:, :, n:] = 0
    sb = jnp.asarray(np.moveaxis(pcm.reshape(S, 2, Bs, nspb), 2, 1))
    sv = np.full((S, Bs), nspb, np.int32)
    sv[:, -1] = n - (Bs - 1) * nspb
    sv = jnp.asarray(sv)
    (hs, cs, rmse), t4 = timed(lambda: jax.block_until_ready(
        encode_streams_sharded(sb, sv, bits_per_sample=4,
                               num_trials=cfg.num_encode_trials, mesh=mesh,
                               stat=True)))
    (hu, cu), t1 = timed(lambda: jax.block_until_ready(jax.vmap(
        lambda b, v: encode_stream_blocks(b, v, 4, cfg.num_encode_trials)
    )(sb, sv)))
    check_equal("sharded stream encode codes", cs, cu)
    for a, b in zip(hs, hu):
        check_equal("sharded stream encode headers", a, b)
    if not np.isfinite(float(rmse)):
        raise AssertionError("sharded quality statistic is not finite")
    log(f"[4c] encode_streams_sharded, 8 x 10 s, stat=True (rmse "
        f"{float(rmse):.6f}): {t4:.3f} s (first call); one card {t1:.3f} s;"
        " identical")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.stderr.write(f"chip_smoke: no GPU (JAX found {devices[0].platform})\n")
        return 1
    if len(devices) < args.cards:
        sys.stderr.write(f"chip_smoke: {args.cards} cards asked for, "
                         f"{len(devices)} found\n")
        return 1
    sys.path.insert(0, str(_ROOT))
    card = card_line()
    log(f"[1] card: {card}; JAX devices: {len(devices)} x "
        f"{devices[0].device_kind}")
    t0 = time.perf_counter()
    if args.cards == 4:
        phase_four_cards()
    else:
        phase_engines()
        phase_headline()
        phase_batch_decode()
        phase_encode()
        phase_kernel_vs_xla(card)
        phase_gpu_tests()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
