"""Encoder conformance: byte-exact streams vs the reference encoder.

The reference only pins *decode* bit-exactness with checked-in goldens; for
encode we go further and compare our streams byte-for-byte against the
reference binary built out-of-tree (SURVEY.md §4 port implication).
"""

import numpy as np
import pytest

from aad_tpu.codec.decoder import decode
from aad_tpu.codec.encoder import EncodeConfig, encode

from util import nyquist, reference_encode, sine, noise, write_pcm16_wav


def _our_encode(pcm, rate, bps, block, trials, ms):
    cfg = EncodeConfig(
        num_channels=pcm.shape[0],
        sampling_rate=rate,
        bits_per_sample=bps,
        max_block_size=block,
        ch_process_method=1 if ms else 0,
        num_encode_trials=trials,
    )
    # pin the JAX engine: this suite exists to conform the scan path
    return encode(pcm, cfg, engine="scan")


# Short signals keep the sequential-scan runtime manageable on the CPU test
# mesh while still covering multiple blocks plus a ragged tail.
N = 2500
RATE = 44100


def _signals(nch):
    return {
        "sine": sine(N, nch, rate=RATE),
        "noise": noise(N, nch),
        "nyquist": nyquist(N, nch),
    }


class TestByteExactVsReference:
    @pytest.mark.parametrize("bps", [2, 3, 4])
    @pytest.mark.parametrize("trials", [0, 2])
    def test_mono(self, reference_cli, tmp_path, bps, trials):
        pcm = _signals(1)["sine"]
        wav = tmp_path / "in.wav"
        write_pcm16_wav(wav, pcm, RATE)
        ref = reference_encode(
            reference_cli, wav, tmp_path / "ref.aad", bps=bps, trials=trials, block=256
        )
        ours = _our_encode(pcm, RATE, bps, 256, trials, ms=False)
        assert ours == ref

    @pytest.mark.parametrize("bps", [2, 3, 4])
    @pytest.mark.parametrize("ms", [False, True])
    def test_stereo(self, reference_cli, tmp_path, bps, ms):
        pcm = _signals(2)["noise"]
        pcm[1] = sine(N, 1, rate=RATE)[0]  # decorrelate channels
        wav = tmp_path / "in.wav"
        write_pcm16_wav(wav, pcm, RATE)
        ref = reference_encode(
            reference_cli, wav, tmp_path / "ref.aad", bps=bps, ms=ms, block=256
        )
        ours = _our_encode(pcm, RATE, bps, 256, trials=2, ms=ms)
        assert ours == ref

    def test_ragged_tail_and_header_only_block(self, reference_cli, tmp_path):
        # N chosen so the final block carries <= 4 samples (header-only)
        from aad_tpu.format.geometry import compute_block_geometry

        geo = compute_block_geometry(256, 1, 4)
        n = geo.num_samples_per_block + 3  # 3-sample tail block
        pcm = sine(n, 1, rate=RATE)
        wav = tmp_path / "in.wav"
        write_pcm16_wav(wav, pcm, RATE)
        ref = reference_encode(reference_cli, wav, tmp_path / "ref.aad", block=256)
        ours = _our_encode(pcm, RATE, 4, 256, trials=2, ms=False)
        assert ours == ref

    def test_trailing_partial_unit(self, reference_cli, tmp_path):
        # 3-bit units carry 8 samples; force a partial final unit
        pcm = noise(301, 1)
        wav = tmp_path / "in.wav"
        write_pcm16_wav(wav, pcm, RATE)
        ref = reference_encode(
            reference_cli, wav, tmp_path / "ref.aad", bps=3, block=64
        )
        ours = _our_encode(pcm, RATE, 3, 64, trials=2, ms=False)
        assert ours == ref


class TestWrappedSquareTrialSSE:
    """Regression: the reference's trial-search accumulator multiplies two
    int32 quantize_error fields (reference: src/aad_encoder.c:459-461), so
    qdiff^2 >= 2^31 WRAPS into a negative term and the double sum can go
    negative (sqrt -> NaN -> comparisons false). Full-scale noise reaches
    that regime through the trial measure passes; an exact-square
    accumulator diverges from the reference (found by the geometry fuzz's
    reference-binary oracle, round 3)."""

    def test_fullscale_noise_odd_geometry_vs_reference(
        self, reference_cli, tmp_path
    ):
        rng = np.random.default_rng(7)
        pcm = rng.integers(-32768, 32768, (2, 1571)).astype(np.int32)
        wav = tmp_path / "wrap.wav"
        write_pcm16_wav(wav, pcm, 8000)
        ref = reference_encode(
            reference_cli, wav, tmp_path / "wrap.aad", bps=3, block=561,
            trials=2,
        )
        ours = _our_encode(pcm, 8000, 3, 561, trials=2, ms=False)
        assert ours == ref

    def test_sse_limb_math_matches_reference_semantics(self):
        """ops.cseman's i64 limb accumulator == the C double accumulator."""
        import jax.numpy as jnp

        from aad_tpu.ops import cseman as cs

        def wrap32(v):
            return (v + 2**31) % 2**32 - 2**31

        rng = np.random.default_rng(3)
        qdiffs = [int(q) for q in rng.integers(-61438, 61439, 500)]
        acc = cs.u64_zero(())
        want = 0
        for q in qdiffs:
            acc = cs.s64_add_i32(acc, cs.wrapped_square(jnp.int32(q)))
            want += wrap32(q * q)
        got = (int(acc[0]) << 32) | int(acc[1])
        got = got - (1 << 64) if got >= (1 << 63) else got
        assert got == want
        # wrap actually occurred in this draw (the regression's whole point)
        assert any(wrap32(q * q) < 0 for q in qdiffs)
        # selection rule: NaN (negative sum) never wins and never loses
        neg = cs.s64_add_i32(cs.u64_zero(()), jnp.int32(-5))
        pos = cs.s64_add_i32(cs.u64_zero(()), jnp.int32(5))
        assert not bool(cs.sse_better(neg, pos))
        assert not bool(cs.sse_better(pos, neg))
        assert bool(cs.sse_better(cs.u64_zero(()), pos))


class TestGoldenFixtureEncode:
    def test_mono_fixture_default_params(self, fixture_dir):
        """Default-parameter encode of the mono fixture == checked-in golden."""
        from aad_tpu.format.wav import read_wav

        fmt, pcm32 = read_wav(str(fixture_dir / "sin300Hz_mono.wav"))
        pcm = (pcm32 >> 16).astype(np.int32)
        ours = _our_encode(pcm, fmt.sampling_rate, 4, 1024, trials=2, ms=False)
        assert ours == (fixture_dir / "sin300Hz_mono.aad").read_bytes()


class TestRoundTrip:
    """RMSE-bounded round trips (reference thresholds:
    test/test_aad_encode_decode.c:303-420) + compression sanity."""

    THRESH = {  # per signal: bps -> max RMSE (full-scale normalised)
        "sine": {4: 5e-2, 3: 6e-2, 2: 8e-2},
        "noise": {4: 1.0e-1, 3: 1.5e-1, 2: 2.4e-1},
        "nyquist": {4: 1.2e-1, 3: 1.6e-1, 2: 2.3e-1},
    }

    @pytest.mark.parametrize("nch", [1, 2])
    @pytest.mark.parametrize("bps", [2, 3, 4])
    @pytest.mark.parametrize("name", ["sine", "noise", "nyquist"])
    def test_rmse(self, nch, bps, name):
        pcm = _signals(nch)[name]
        data = _our_encode(pcm, RATE, bps, 1024, trials=1, ms=False)
        _, out = decode(data, engine="scan")
        err = (pcm.astype(np.float64) - np.asarray(out)) / 32768.0
        rmse = np.sqrt(np.mean(err**2))
        assert rmse < self.THRESH[name][bps], rmse

    def test_compression_bound(self):
        pcm = sine(N, 2, rate=RATE)
        data = _our_encode(pcm, RATE, 4, 1024, trials=0, ms=False)
        assert len(data) < pcm.size * 2 / 2  # < half the int16 input bytes


class TestDeepTrials:
    """Trial counts above 2 vs the reference binary.

    The reference accepts ``-t`` up to 255 (uint8 cast of strtol,
    src/main.c:578-588); deeper searches shift the min-RMSE fold's
    selection pattern because every trial re-encodes prev+current
    (src/aad_encoder.c:470-562). All committed coverage before round 5
    pinned trials in {0,1,2} only — these cells pin the scan AND native
    engines byte-exact against the oracle at -t 4 / -t 8.
    """

    @pytest.mark.parametrize("trials", [4, 8])
    def test_deep_search_scan_and_native_match_reference(
        self, reference_cli, tmp_path, trials
    ):
        from aad_tpu import native

        pcm = _signals(2)["noise"]
        pcm[1] = nyquist(N, 1)[0]  # decorrelated, quantiser-hostile channel
        wav = tmp_path / "in.wav"
        write_pcm16_wav(wav, pcm, RATE)
        ref = reference_encode(
            reference_cli, wav, tmp_path / "ref.aad", bps=4,
            trials=trials, block=192,
        )
        assert _our_encode(pcm, RATE, 4, 192, trials, ms=False) == ref
        if native.available():
            cfg = EncodeConfig(
                num_channels=2, sampling_rate=RATE, bits_per_sample=4,
                max_block_size=192, num_encode_trials=trials,
            )
            assert native.encode(pcm, cfg) == ref
