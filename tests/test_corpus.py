"""Tier-7 conformance: RMSE-bounded round trips over the real WAV corpus.

Mirrors the reference's real-audio grid (reference:
test/test_aad_encode_decode.c:492-636): every fixture WAV x bit depth x
block size, RMSE under the per-bps ceilings, encoded size under half the
input. The native codec runs the grid (instant per case; it is pinned
byte-exact to the JAX path by test_native.py), with JAX spot checks.
"""

import numpy as np
import pytest

from aad_tpu import native
from aad_tpu.codec.decoder import decode as jax_decode
from aad_tpu.codec.encoder import EncodeConfig
from aad_tpu.format.wav import read_wav

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native codec could not be built"
)

FIXTURES = [
    "unit_impulse_mono.wav",
    "unit_impulse.wav",
    "sin300Hz_mono.wav",
    "sin300Hz.wav",
    "bunny1.wav",       # contains a LIST chunk: exercises chunk skipping
    "pi_15-25sec.wav",  # real speech/music, stereo 44.1 kHz
]

RMSE_CEILING = {4: 5e-2, 3: 6e-2, 2: 8e-2}


def _roundtrip(pcm, rate, bps, block, ms=False, trials=2):
    cfg = EncodeConfig(
        num_channels=pcm.shape[0],
        sampling_rate=rate,
        bits_per_sample=bps,
        max_block_size=block,
        ch_process_method=1 if ms else 0,
        num_encode_trials=trials,
    )
    data = native.encode(pcm, cfg)
    _, out = native.decode(data)
    return data, out


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("bps", [2, 3, 4])
@pytest.mark.parametrize("block", [128, 256, 1024, 4096])
def test_rmse_and_compression(fixture_dir, name, bps, block):
    fmt, pcm32 = read_wav(str(fixture_dir / name))
    pcm = (pcm32 >> 16).astype(np.int32)

    data, out = _roundtrip(pcm, fmt.sampling_rate, bps, block)
    err = (pcm.astype(np.float64) - out) / 32768.0
    rmse = np.sqrt(np.mean(err**2))
    assert rmse < RMSE_CEILING[bps], f"{name} bps={bps} block={block}: {rmse}"
    # compression sanity (reference: test/test_aad_encode_decode.c:234-238)
    assert len(data) < pcm.size * 2 / 2


@pytest.mark.parametrize("name", ["sin300Hz.wav", "pi_15-25sec.wav"])
def test_ms_mode_real_audio(fixture_dir, name):
    fmt, pcm32 = read_wav(str(fixture_dir / name))
    pcm = (pcm32 >> 16).astype(np.int32)
    _, out = _roundtrip(pcm, fmt.sampling_rate, 4, 1024, ms=True)
    err = (pcm.astype(np.float64) - out) / 32768.0
    assert np.sqrt(np.mean(err**2)) < RMSE_CEILING[4]


def test_jax_spot_check_on_real_audio(fixture_dir):
    """One real-audio case through the full JAX pipeline, vs native."""
    fmt, pcm32 = read_wav(str(fixture_dir / "bunny1.wav"))
    pcm = (pcm32 >> 16).astype(np.int32)
    cfg = EncodeConfig(num_channels=fmt.num_channels,
                       sampling_rate=fmt.sampling_rate, max_block_size=256)
    data = native.encode(pcm, cfg)
    _, out_native = native.decode(data)
    _, out_jax = jax_decode(data, engine="scan")
    np.testing.assert_array_equal(out_native, np.asarray(out_jax))


@pytest.mark.parametrize("name", ["bunny1.wav", "pi_15-25sec.wav"])
@pytest.mark.parametrize("bps", [2, 3, 4])
def test_jax_engines_real_audio_grid(fixture_dir, fused_engine, name, bps):
    """Real audio through the JAX engines, byte-exact vs native.

    The reference runs its corpus grid through the codec under test
    (reference: test/test_aad_encode_decode.c:492-636); this sampled grid
    puts real audio through (a) the JAX scan *encoder* — bytes must equal
    the native engine's (itself byte-exact vs the reference binary) — and
    (b) the scan and fused (interpreted on the CPU, compiled on the GPU)
    *decoders*.
    """
    from aad_tpu.codec.encoder import encode as jax_encode

    fmt, pcm32 = read_wav(str(fixture_dir / name))
    pcm = (pcm32 >> 16).astype(np.int32)
    cfg = EncodeConfig(
        num_channels=fmt.num_channels,
        sampling_rate=fmt.sampling_rate,
        bits_per_sample=bps,
        max_block_size=1024,
    )
    want = native.encode(pcm, cfg)
    got = jax_encode(pcm, cfg, engine="scan")
    assert got == want, f"{name} bps={bps}: scan-encode bytes differ"

    _, out_native = native.decode(want)
    for engine in ("scan", fused_engine):
        _, out = jax_decode(want, engine=engine)
        np.testing.assert_array_equal(
            out_native, np.asarray(out), err_msg=f"{name} bps={bps} {engine}"
        )


def test_golden_compression_ratios(fixture_dir):
    """The fixture compression ratios recorded in BASELINE.md."""
    for wav, aad, expect in [
        ("sin300Hz.wav", "sin300Hz.aad", 24831),
        ("sin300Hz_mono.wav", "sin300Hz_mono.aad", 12223),
    ]:
        fmt, pcm32 = read_wav(str(fixture_dir / wav))
        pcm = (pcm32 >> 16).astype(np.int32)
        cfg = EncodeConfig(num_channels=fmt.num_channels,
                           sampling_rate=fmt.sampling_rate)
        assert len(native.encode(pcm, cfg)) == expect
