"""Quality metrics and codec self-verification.

Library-level equivalents of the reference CLI's QA modes (-c statistics,
reconstruction comparison; reference: src/main.c:441-503) plus a deployment
self-check that proves the active engines are bit-exact on this host.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class QualityStats:
    """Full-scale-normalised error statistics between two PCM signals."""

    rmse: float
    mean_abs: float
    max_abs: float

    def __str__(self) -> str:  # mirrors the reference's -c line format
        return f"RMSE:{self.rmse:f} MSD:{self.mean_abs:f} MaxAE:{self.max_abs:f}"


def quality_stats(original: np.ndarray, decoded: np.ndarray) -> QualityStats:
    """Error statistics between original and decoded int16-valued PCM.

    Unlike the reference CLI's -c mode (which preserves a historical
    formula quirk — see cli.py), this computes the straightforward
    full-scale-normalised metrics.
    """
    a = np.asarray(original, dtype=np.float64) / 32768.0
    b = np.asarray(decoded, dtype=np.float64) / 32768.0
    diff = a - b
    return QualityStats(
        rmse=math.sqrt(float(np.mean(diff**2))),
        mean_abs=float(np.mean(np.abs(diff))),
        max_abs=float(np.max(np.abs(diff))) if diff.size else 0.0,
    )


def roundtrip_stats(pcm: np.ndarray, config, engine: str = "auto") -> QualityStats:
    """Encode + decode ``pcm`` and report the reconstruction error."""
    from ..codec.decoder import decode
    from ..codec.encoder import encode

    data = encode(pcm, config, engine=engine)
    _, out = decode(data, engine=engine)
    return quality_stats(pcm, out)


def self_check(verbose: bool = False) -> dict:
    """Prove the active engines are bit-exact on this host/device.

    Runs a deterministic encode+decode cross-check between the portable
    scan engine and whatever the one-shot auto engines resolve to (the
    native codec where it builds, else scan; block-parallel encode on a
    GPU runs the scan engine on the device). ``decode_engine`` in the
    report names the engine the device APIs pick (the fused kernel on a
    GPU). Returns a report dict; raises AssertionError on any mismatch.
    Intended for deployment smoke tests.
    """
    import jax

    from ..codec.decoder import decode
    from ..codec.encoder import EncodeConfig, encode
    from ..constants import FILE_HEADER_SIZE
    from ..ops.decode import resolve_engine

    rng = np.random.default_rng(0)
    n = 2500
    pcm = (
        9000 * np.sin(np.arange(2 * n).reshape(2, n) / 17)
        + rng.integers(-2000, 2000, (2, n))
    ).astype(np.int32)

    report = {
        "platform": jax.devices()[0].platform,
        "decode_engine": resolve_engine("auto"),
        "checks": [],
    }

    for bps in (2, 3, 4):
        cfg = EncodeConfig(
            num_channels=2, sampling_rate=16000, bits_per_sample=bps,
            max_block_size=256,
        )
        ref_stream = encode(pcm, cfg, engine="scan")
        auto_stream = encode(pcm, cfg, engine="auto")
        assert auto_stream == ref_stream, f"encode mismatch at bps={bps}"

        _, ref_pcm = decode(ref_stream, engine="scan")
        _, auto_pcm = decode(ref_stream, engine="auto")
        assert np.array_equal(
            np.asarray(ref_pcm), np.asarray(auto_pcm)
        ), f"decode mismatch at bps={bps}"
        report["checks"].append({"bits_per_sample": bps, "ok": True})
        if verbose:  # pragma: no cover - cosmetic
            print(f"bps={bps}: engines bit-exact")

    # block-parallel mode: its defining property (== concatenated
    # independent single-block encodes) plus decodability
    cfg = EncodeConfig(
        num_channels=2, sampling_rate=16000, max_block_size=256
    )
    nspb = cfg.geometry().num_samples_per_block
    par = encode(pcm, cfg, engine="auto", parallel_blocks=True)
    parts = []
    for b in range(-(-n // nspb)):
        sl = pcm[:, b * nspb : (b + 1) * nspb]
        parts.append(encode(sl, cfg, engine="scan")[FILE_HEADER_SIZE:])
    assert (
        par == par[:FILE_HEADER_SIZE] + b"".join(parts)
    ), "parallel-mode mismatch"
    _, par_pcm = decode(par, engine="auto")
    assert np.asarray(par_pcm).shape == pcm.shape
    report["checks"].append({"parallel_blocks": True, "ok": True})
    if verbose:  # pragma: no cover - cosmetic
        print("parallel mode: per-block property holds")

    return report
