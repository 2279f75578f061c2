"""Utility-layer tests: debug invariants, profiling meter, word-pack blocks."""

import numpy as np
import pytest

import jax.numpy as jnp

from aad_tpu.codec.result import InvalidFormatError
from aad_tpu.format.geometry import compute_block_geometry
from aad_tpu.utils import debug


class TestDebug:
    def setup_method(self):
        debug.enable(True)

    def teardown_method(self):
        debug.enable(False)

    def test_step_index_out_of_range_rejected(self):
        from aad_tpu.format.framing import BlockStates

        geo = compute_block_geometry(64, 1, 4)
        states = BlockStates(
            step_index=np.array([[5000]], dtype=np.int32),
            weight=np.zeros((1, 1, 4), np.int32),
            history=np.zeros((1, 1, 4), np.int32),
        )
        codes = np.zeros((1, 1, geo.codes_per_block), np.uint8)
        with pytest.raises(InvalidFormatError):
            debug.check_framed_stream(states, codes, geo)

    def test_pcm_range_check(self):
        with pytest.raises(InvalidFormatError):
            debug.check_pcm_range(np.array([[40000]], np.int32))
        debug.check_pcm_range(np.array([[32767, -32768]], np.int32))

    def test_disabled_is_noop(self):
        debug.enable(False)
        debug.check_pcm_range(np.array([[99999]], np.int32))  # no raise

    def test_decoder_frame_hook(self, fixture_dir):
        """Debug mode accepts valid golden streams end-to-end."""
        from aad_tpu import decode

        data = (fixture_dir / "sin300Hz_mono.aad").read_bytes()
        _, pcm = decode(data, engine="scan")
        assert pcm.shape[1] == 24000  # num_samples of the mono fixture


class TestProfiling:
    def test_throughput_meter(self):
        from aad_tpu.utils.profiling import measure_throughput

        x = jnp.ones((64, 64), jnp.int32)
        rep = measure_throughput(lambda a: a * 2 + 1, x, x.size, iters=3)
        assert rep.samples_per_sec > 0
        assert rep.iters == 3
        assert "samples" in str(rep) or "G" in str(rep)


class TestWordPacking:
    def test_pack_unpack_words(self):
        from aad_tpu.ops.wire32 import pack_code_words

        rng = np.random.default_rng(0)
        codes = jnp.asarray(rng.integers(0, 16, (5, 37)).astype(np.int32))
        words = pack_code_words(codes)
        assert words.shape == (5, 5)
        # unpack manually and compare
        got = np.zeros((5, 40), np.int32)
        w = np.asarray(words)
        for k in range(8):
            got[:, k::8] = (w >> (4 * k)) & 0xF
        np.testing.assert_array_equal(got[:, :37], np.asarray(codes))
        # a larger word count zero-pads
        wide = np.asarray(pack_code_words(codes, 7))
        np.testing.assert_array_equal(wide[:, :5], w)
        assert not wide[:, 5:].any()

class TestQuality:
    def test_quality_stats(self):
        from aad_tpu.utils.quality import quality_stats

        a = np.array([[0, 1000, -1000]], np.int32)
        s = quality_stats(a, a)
        assert s.rmse == 0 and s.max_abs == 0
        b = np.array([[0, 1000, -2000]], np.int32)
        s = quality_stats(a, b)
        assert s.max_abs == pytest.approx(1000 / 32768.0)
        assert "RMSE:" in str(s)

    def test_roundtrip_stats(self):
        from aad_tpu.codec.encoder import EncodeConfig
        from aad_tpu.utils.quality import roundtrip_stats

        rng = np.random.default_rng(0)
        pcm = (8000 * np.sin(np.arange(2000) / 9)).astype(np.int32)[None]
        s = roundtrip_stats(
            pcm, EncodeConfig(num_channels=1, sampling_rate=8000), engine="scan"
        )
        assert 0 < s.rmse < 5e-2

    def test_self_check(self):
        from aad_tpu.utils.quality import self_check

        report = self_check()
        assert len(report["checks"]) == 4
        assert all(c["ok"] for c in report["checks"])


def test_main_module_entry():
    """``python -m aad_tpu`` reaches the CLI."""
    import pathlib
    import subprocess
    import sys

    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    r = subprocess.run(
        [sys.executable, "-m", "aad_tpu", "-v"],
        capture_output=True, text=True, cwd=repo, timeout=120,
    )
    assert r.returncode == 0 and "Version" in r.stdout


class TestFileIO:
    def test_encode_decode_file(self, tmp_path, fixture_dir):
        from aad_tpu.io import decode_file, encode_file
        from aad_tpu.format.wav import read_wav

        hdr = encode_file(
            str(fixture_dir / "sin300Hz_mono.wav"), str(tmp_path / "o.aad")
        )
        assert (tmp_path / "o.aad").read_bytes() == (
            fixture_dir / "sin300Hz_mono.aad"
        ).read_bytes()
        hdr2 = decode_file(str(tmp_path / "o.aad"), str(tmp_path / "o.wav"))
        assert hdr2.num_samples == hdr.num_samples
        _, got = read_wav(str(tmp_path / "o.wav"))
        _, want = read_wav(str(fixture_dir / "sin300Hz_mono_decoded.wav"))
        np.testing.assert_array_equal(got, want)


def test_bench_device_metric_contract(monkeypatch):
    """bench.py's transfer-inclusive decode metric keeps its contract.

    ``measure_decode_e2e_device`` returns the samples/s of
    ``Decoder.decode_payload_ondevice`` (bytes in, int16 PCM out). Pinned
    here on a tiny CPU stream so a future signature change cannot rot
    silently; the output itself must stay bit-exact vs the public decode
    path.
    """
    import os
    import pathlib

    # Scope the import's side effects to this test: bench.py setdefaults
    # JAX_COMPILATION_CACHE_DIR at import time, which would otherwise leak
    # into subprocesses spawned by later tests.
    monkeypatch.syspath_prepend(
        str(pathlib.Path(__file__).resolve().parent.parent)
    )
    root = pathlib.Path(__file__).resolve().parent.parent
    monkeypatch.setenv(
        "JAX_COMPILATION_CACHE_DIR",
        os.environ.get("JAX_COMPILATION_CACHE_DIR", str(root / ".jax_cache")),
    )
    import bench as B_mod
    from aad_tpu import FILE_HEADER_SIZE, decode, decode_header

    data, _ = B_mod.build_synthetic_stream(48000 * 2)
    header = decode_header(data[:FILE_HEADER_SIZE])
    sps = B_mod.measure_decode_e2e_device(data, header)
    assert sps > 0
    # The metric's warm decode must agree with the public API's answer.
    from aad_tpu.codec.decoder import Decoder

    dec = Decoder.from_header(header)
    payload = np.frombuffer(data, dtype=np.uint8)[FILE_HEADER_SIZE:]
    got = np.asarray(dec.decode_payload_ondevice(payload))
    _, want = decode(data)
    np.testing.assert_array_equal(got, np.asarray(want, dtype=got.dtype))
