"""Native host codec (libaadx) conformance.

Three-way agreement: native C++ vs JAX pipeline vs the reference binary,
plus golden fixtures. The native codec and the JAX pipeline are fully
independent implementations, so their agreement is strong evidence both
match the format.
"""

import os

import numpy as np
import pytest

from aad_tpu import decode as jax_decode
from aad_tpu import native
from aad_tpu.codec.encoder import EncodeConfig, encode as jax_encode
from aad_tpu.codec.result import InvalidFormatError, InsufficientDataError
from aad_tpu.format.wav import read_wav

from util import noise, sine

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native codec could not be built"
)


class TestGolden:
    @pytest.mark.parametrize(
        "aad,wav",
        [
            ("sin300Hz_mono.aad", "sin300Hz_mono_decoded.wav"),
            ("sin300Hz.aad", "sin300Hz_decoded.wav"),
        ],
    )
    def test_decode(self, fixture_dir, aad, wav):
        data = (fixture_dir / aad).read_bytes()
        h, pcm = native.decode(data)
        _, golden = read_wav(str(fixture_dir / wav))
        np.testing.assert_array_equal(pcm, golden >> 16)

    @pytest.mark.parametrize(
        "wav,aad", [("sin300Hz_mono.wav", "sin300Hz_mono.aad"),
                    ("sin300Hz.wav", "sin300Hz.aad")]
    )
    def test_encode(self, fixture_dir, wav, aad):
        fmt, pcm32 = read_wav(str(fixture_dir / wav))
        pcm = (pcm32 >> 16).astype(np.int32)
        cfg = EncodeConfig(
            num_channels=fmt.num_channels, sampling_rate=fmt.sampling_rate
        )
        assert native.encode(pcm, cfg) == (fixture_dir / aad).read_bytes()

    def test_public_decode_auto_routes_native(self, fixture_dir):
        """engine="auto" one-shot decode prefers native when available —
        a bytes-in -> host-array-out call is transfer/dispatch-bound, not
        compute-bound (codec/decoder.py::decode); output must still match
        the JAX engines bit-exactly."""
        from aad_tpu import decode

        data = (fixture_dir / "sin300Hz.aad").read_bytes()
        _, auto_pcm = decode(data)
        _, scan_pcm = decode(data, engine="scan")
        np.testing.assert_array_equal(auto_pcm, scan_pcm)


class TestCrossImplementation:
    @pytest.mark.parametrize("bps", [2, 3, 4])
    @pytest.mark.parametrize("nch,ms", [(1, False), (2, False), (2, True)])
    def test_encode_agrees_with_jax(self, bps, nch, ms):
        pcm = noise(2000, nch, seed=3)
        if nch == 2:
            pcm[1] = sine(2000, 1)[0]
        cfg = EncodeConfig(
            num_channels=nch,
            sampling_rate=44100,
            bits_per_sample=bps,
            max_block_size=256,
            ch_process_method=1 if ms else 0,
            num_encode_trials=2,
        )
        assert native.encode(pcm, cfg) == jax_encode(pcm, cfg, engine="scan")

    def test_decode_agrees_with_jax(self):
        pcm = noise(3000, 2, seed=4)
        cfg = EncodeConfig(num_channels=2, sampling_rate=44100, max_block_size=128)
        data = native.encode(pcm, cfg)
        h_n, out_n = native.decode(data)
        h_j, out_j = jax_decode(data, engine="scan")
        np.testing.assert_array_equal(out_n, np.asarray(out_j))

    def test_ragged_and_tiny_tails(self):
        from aad_tpu.format.geometry import compute_block_geometry

        geo = compute_block_geometry(256, 1, 4)
        for extra in (1, 3, 4, 5, 7):
            n = geo.num_samples_per_block + extra
            pcm = sine(n, 1)
            cfg = EncodeConfig(num_channels=1, sampling_rate=8000,
                               max_block_size=256)
            data = native.encode(pcm, cfg)
            assert data == jax_encode(pcm, cfg, engine="scan")
            _, out = native.decode(data)
            _, out_j = jax_decode(data, engine="scan")
            np.testing.assert_array_equal(out, np.asarray(out_j))


class TestErrors:
    def test_truncated(self):
        with pytest.raises(InsufficientDataError):
            native.decode(b"AAD\x00123")

    def test_bad_magic(self):
        with pytest.raises(InvalidFormatError):
            native.decode(b"X" * 64)

    def test_bad_config(self):
        with pytest.raises(InvalidFormatError):
            native.encode(
                np.zeros((1, 100), np.int32),
                EncodeConfig(num_channels=1, sampling_rate=8000,
                             bits_per_sample=3, max_block_size=4),
            )


class TestFuzz:
    """Random-payload decode equivalence: native vs JAX scan engine.

    Valid headers + arbitrary payload bytes — both implementations must
    produce identical samples on any well-framed garbage (exercises extreme
    states loaded from block headers).
    """

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("bps", [2, 3, 4])
    def test_random_payload(self, seed, bps):
        from aad_tpu.format.geometry import compute_block_geometry
        from aad_tpu.format.header import HeaderInfo, encode_header

        rng = np.random.default_rng(seed)
        geo = compute_block_geometry(128, 2, bps)
        nblocks = 5
        num_samples = geo.num_samples_per_block * nblocks - 7
        h = HeaderInfo(
            num_channels=2,
            num_samples=num_samples,
            sampling_rate=44100,
            bits_per_sample=bps,
            block_size=geo.block_size,
            num_samples_per_block=geo.num_samples_per_block,
            ch_process_method=seed % 2,
        )
        payload = rng.integers(0, 256, nblocks * geo.block_size, dtype=np.uint8)
        # Raw random block headers INCLUDING out-of-range step indices
        # (4081-4095): since round 5 every engine pins those to table
        # slot 255 (the reference's UB case — see TestMalformedStepIndex),
        # so the fuzz no longer needs to clamp them out.
        data = encode_header(h) + payload.tobytes()

        _, out_native = native.decode(data)
        _, out_jax = jax_decode(data, engine="scan")
        np.testing.assert_array_equal(out_native, np.asarray(out_jax))


class TestTruncationRobustness:
    """Truncated payloads must raise, never overread (the reference's C
    code reads past truncated buffers with only DEBUG asserts)."""

    def _stream(self):
        pcm = noise(3000, 2, seed=30)
        cfg = EncodeConfig(num_channels=2, sampling_rate=8000, max_block_size=128)
        return native.encode(pcm, cfg)

    @pytest.mark.parametrize("cut", [40, 200, 500, -1, -50])
    def test_truncated_raises(self, cut):
        data = self._stream()
        with pytest.raises(InsufficientDataError):
            native.decode(data[:cut] if cut > 0 else data[:len(data) + cut])

    def test_exact_length_ok(self):
        data = self._stream()
        h, pcm = native.decode(data)
        assert pcm.shape == (2, 3000)

    def test_trailing_garbage_tolerated(self):
        # bytes beyond the final block are ignored (stream is self-delimiting
        # by num_samples)
        data = self._stream() + b"\xff" * 64
        h, pcm = native.decode(data)
        assert pcm.shape == (2, 3000)


class TestLibOverride:
    """AAD_TPU_NATIVE_LIB pointing at a missing file must fail loudly —
    an explicit operator override never silently degrades to the JAX
    fallback. Subprocess: the loader's state is module-global."""

    def test_missing_override_raises(self):
        import subprocess
        import sys

        code = (
            "from aad_tpu import native\n"
            "try:\n"
            "    native.available()\n"
            "except FileNotFoundError as e:\n"
            "    print('RAISED', e)\n"
            "else:\n"
            "    print('SILENT')\n"
        )
        env = dict(os.environ)
        env["AAD_TPU_NATIVE_LIB"] = "/nonexistent/libaadx_typo.so"
        out = subprocess.run(
            [sys.executable, "-c", code], env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert "RAISED" in out.stdout, out.stdout + out.stderr


class TestMutationFuzz:
    """Adversarial payload mutations: native and scan must agree byte-for-byte.

    TestFuzz covers *well-framed* garbage (step indices clamped in range);
    this class removes that constraint — random bit flips, span rewrites and
    zeroed spans anywhere past the file header (header-field corruption has
    its own offset matrix in test_format.py, and keeping the geometry fixed
    means the scan engine compiles once). On every mutated stream the two
    independent implementations must take the same branch: both decode to
    identical samples, or both raise a codec error (the reference only
    guards these reads with DEBUG asserts — src/aad_decoder.c:394-455)."""

    @pytest.fixture(scope="class")
    def stream(self):
        pcm = noise(1500, 2, seed=31)
        cfg = EncodeConfig(num_channels=2, sampling_rate=8000,
                           max_block_size=96)
        return native.encode(pcm, cfg)

    @pytest.mark.parametrize("seed", range(24))
    def test_native_scan_agree(self, stream, seed):
        from aad_tpu.codec.result import AadError
        from aad_tpu.constants import FILE_HEADER_SIZE

        rng = np.random.default_rng(7000 + seed)
        buf = bytearray(stream)
        kind = seed % 3
        if kind == 0:  # flip random payload bits
            for _ in range(int(rng.integers(1, 17))):
                i = int(rng.integers(FILE_HEADER_SIZE, len(buf)))
                buf[i] ^= 1 << int(rng.integers(0, 8))
        elif kind == 1:  # rewrite a random payload span
            a = int(rng.integers(FILE_HEADER_SIZE, len(buf)))
            b = min(len(buf), a + int(rng.integers(1, 48)))
            buf[a:b] = rng.integers(0, 256, b - a, dtype=np.uint8).tobytes()
        else:  # zero a random payload span
            a = int(rng.integers(FILE_HEADER_SIZE, len(buf)))
            b = min(len(buf), a + int(rng.integers(1, 96)))
            buf[a:b] = bytes(b - a)
        data = bytes(buf)

        try:
            _, out_native = native.decode(data)
        except AadError:
            out_native = None
        try:
            _, out_jax = jax_decode(data, engine="scan")
        except AadError:
            out_jax = None

        if (out_native is None) != (out_jax is None):
            pytest.fail(
                f"accept/reject divergence: native "
                f"{'rejected' if out_native is None else 'accepted'}, scan "
                f"{'rejected' if out_jax is None else 'accepted'}"
            )
        if out_native is not None:
            np.testing.assert_array_equal(out_native, np.asarray(out_jax))


class TestGeometryFuzz:
    """Differential fuzz over random geometries (odd block sizes included),
    with the **reference binary as the oracle**.

    The reference grids only exercise {128, 256, 1024, 4096}-byte blocks;
    random max_block_size values stress the LCM interleave-unit geometry
    math (reference: src/aad_encoder.c:85-131) through every layer. Each
    seed's random PCM is written to WAV and run through the reference CLI
    at the same (bps, block, ms, trials): our encoders must match its
    bytes and our decoders its decoded WAV — so a shared misreading of the
    interleave math between the scan and native engines cannot pass.
    """

    @pytest.mark.parametrize("seed", range(6))
    def test_random_geometry_differential(
        self, seed, reference_cli, tmp_path
    ):
        from util import reference_decode, reference_encode, write_pcm16_wav

        from aad_tpu.codec.decoder import decode
        from aad_tpu.codec.encoder import EncodeConfig, encode
        from aad_tpu.format.wav import read_wav

        rng = np.random.default_rng(1000 + seed)
        nch = int(rng.integers(1, 3))
        bps = int(rng.integers(2, 5))
        # min block size must fit header + one interleave unit
        mbs = int(rng.integers(40 * nch, 700))
        cfg = EncodeConfig(
            num_channels=nch,
            sampling_rate=8000,
            bits_per_sample=bps,
            max_block_size=mbs,
            ch_process_method=int(rng.integers(0, 2)) if nch == 2 else 0,
            num_encode_trials=int(rng.integers(0, 3)),
        )
        nspb = cfg.geometry().num_samples_per_block
        n = int(rng.integers(1, 3 * nspb + 2))
        pcm = rng.integers(-32768, 32768, (nch, n)).astype(np.int32)

        a = encode(pcm, cfg, engine="scan")
        b = native.encode(pcm, cfg)
        assert a == b, f"geometry {cfg} diverged"

        # the reference binary on the same input and knobs
        wav = tmp_path / "fuzz.wav"
        write_pcm16_wav(wav, pcm, 8000)
        ref = reference_encode(
            reference_cli, wav, tmp_path / "fuzz.aad", bps=bps, block=mbs,
            trials=cfg.num_encode_trials, ms=cfg.ch_process_method == 1,
        )
        assert a == ref, f"geometry {cfg} diverged from the reference binary"

        _, dj = decode(a)
        _, dn = native.decode(a)
        np.testing.assert_array_equal(np.asarray(dj), np.asarray(dn))
        assert dj.shape == (nch, n)

        ref_wav = reference_decode(
            reference_cli, tmp_path / "fuzz.aad", tmp_path / "fuzz_dec.wav"
        )
        _, ref_pcm = read_wav(str(ref_wav))
        np.testing.assert_array_equal(np.asarray(dj), ref_pcm >> 16)
        # the JAX scan decoder face-to-face with the reference binary's
        # decoded WAV — no native engine in this comparison
        _, dscan = decode(ref, engine="scan")
        np.testing.assert_array_equal(np.asarray(dscan), ref_pcm >> 16)

    @pytest.mark.parametrize("seed", range(3))
    def test_parallel_stream_decodes_via_reference_binary(
        self, seed, reference_cli, tmp_path
    ):
        """The block-parallel mode's conforming-stream claim, checked
        against the actual reference decoder: a stream where every block
        (or chunk head) is a stream head must decode identically through
        the reference binary (src/aad_decoder.c:363-380 loads the complete
        decoder state from each block header, so it cannot tell such a
        stream from a sequential one). tools/soak_fuzz.py runs this same
        check at soak scale."""
        from util import reference_decode

        from aad_tpu.codec.encoder import EncodeConfig

        rng = np.random.default_rng(3000 + seed)
        nch = int(rng.integers(1, 3))
        bps = int(rng.integers(2, 5))
        mbs = int(rng.integers(40 * nch, 700))
        cfg = EncodeConfig(
            num_channels=nch,
            sampling_rate=8000,
            bits_per_sample=bps,
            max_block_size=mbs,
            ch_process_method=int(rng.integers(0, 2)) if nch == 2 else 0,
            num_encode_trials=int(rng.integers(0, 3)),
        )
        nspb = cfg.geometry().num_samples_per_block
        n = int(rng.integers(1, 4 * nspb + 2))
        pcm = rng.integers(-32768, 32768, (nch, n)).astype(np.int32)

        par = native.encode_parallel(
            pcm, cfg, chunk_blocks=int(rng.integers(1, 4))
        )
        (tmp_path / "par.aad").write_bytes(par)
        ref_wav = reference_decode(
            reference_cli, tmp_path / "par.aad", tmp_path / "par_dec.wav"
        )
        _, ref_pcm = read_wav(str(ref_wav))
        _, ours = native.decode(par)
        np.testing.assert_array_equal(np.asarray(ours), ref_pcm >> 16)

    @pytest.mark.parametrize("seed", range(4))
    def test_random_geometry_streaming_carry(self, seed):
        """The native streaming carry (aadx_encode_chunk / decode_blocks)
        under random geometry AND random push cadence: chunked bytes must
        equal the one-shot native stream (itself reference-binary-pinned
        above), and the streaming decoder must reproduce the one-shot
        samples at random byte-feed sizes."""
        from aad_tpu.codec.encoder import EncodeConfig
        from aad_tpu.codec.streaming import StreamingDecoder, StreamingEncoder

        rng = np.random.default_rng(3000 + seed)
        nch = int(rng.integers(1, 3))
        bps = int(rng.integers(2, 5))
        mbs = int(rng.integers(40 * nch, 700))
        cfg = EncodeConfig(
            num_channels=nch,
            sampling_rate=8000,
            bits_per_sample=bps,
            max_block_size=mbs,
            ch_process_method=int(rng.integers(0, 2)) if nch == 2 else 0,
            num_encode_trials=int(rng.integers(0, 3)),
        )
        nspb = cfg.geometry().num_samples_per_block
        n = int(rng.integers(1, 6 * nspb + 2))
        pcm = rng.integers(-32768, 32768, (nch, n)).astype(np.int32)
        whole = native.encode(pcm, cfg)

        enc = StreamingEncoder(cfg, engine="native", total_samples=n)
        parts = [enc.header()]
        pos = 0
        while pos < n:
            c = int(rng.integers(1, 2 * nspb + 1))
            parts.append(enc.push(pcm[:, pos : pos + c]))
            pos += c
        parts.append(enc.finish())
        assert b"".join(parts) == whole, f"streaming carry diverged: {cfg}"

        dec = StreamingDecoder(engine="native")
        outs = []
        pos = 0
        while pos < len(whole):
            c = int(rng.integers(1, 4096))
            outs.append(dec.push(whole[pos : pos + c]))
            pos += c
        got = np.concatenate(outs, axis=1)
        _, want = native.decode(whole)
        np.testing.assert_array_equal(got.astype(np.int32), want)

    @pytest.mark.parametrize("seed", range(3))
    def test_random_geometry_parallel_mode(self, seed):
        """Parallel mode upholds its per-block-concat property on random
        geometries too (exercises the wire32 encode permutations for
        non-default interleave patterns)."""
        from aad_tpu.codec.decoder import decode
        from aad_tpu.codec.encoder import EncodeConfig, encode

        rng = np.random.default_rng(2000 + seed)
        nch = int(rng.integers(1, 3))
        bps = int(rng.integers(2, 5))
        mbs = int(rng.integers(40 * nch, 500))
        cfg = EncodeConfig(
            num_channels=nch,
            sampling_rate=8000,
            bits_per_sample=bps,
            max_block_size=mbs,
            num_encode_trials=1,
        )
        nspb = cfg.geometry().num_samples_per_block
        n = 3 * nspb + int(rng.integers(1, nspb))
        pcm = rng.integers(-32768, 32768, (nch, n)).astype(np.int32)

        par = encode(pcm, cfg, engine="scan", parallel_blocks=True)
        parts = []
        for b in range(4):
            sl = pcm[:, b * nspb : (b + 1) * nspb]
            if sl.shape[1] == 0:
                break
            parts.append(encode(sl, cfg, engine="scan")[31:])
        assert par == par[:31] + b"".join(parts)
        _, dn = native.decode(par)
        assert np.asarray(dn).shape == (nch, n)


class TestNativeBatch:
    """Threaded native batch: GIL-free C calls across host cores."""

    def test_encode_batch_matches_solo_and_scales(self):
        from aad_tpu.codec.batch_encode import encode_batch as api_batch
        from aad_tpu.codec.encoder import EncodeConfig

        rng = np.random.default_rng(5)
        cfg = EncodeConfig(num_channels=2, sampling_rate=16000)
        streams = [
            rng.integers(-32768, 32768, (2, n)).astype(np.int32)
            for n in (3000, 1, 5000, 2048)
        ]
        out = native.encode_batch(streams, cfg)
        for pcm, blob in zip(streams, out):
            assert blob == native.encode(pcm, cfg)
        # the public batch API routes engine="native" here
        assert api_batch(streams, cfg, engine="native") == out

    def test_encode_batch_parallel_blocks(self):
        from aad_tpu.codec.batch_encode import encode_batch as api_batch
        from aad_tpu.codec.encoder import EncodeConfig, encode

        rng = np.random.default_rng(11)
        cfg = EncodeConfig(num_channels=2, sampling_rate=16000,
                           max_block_size=128)
        streams = [
            rng.integers(-32768, 32768, (2, n)).astype(np.int32)
            for n in (4000, 777)
        ]
        want = [
            encode(p, cfg, engine="scan", parallel_blocks=True)
            for p in streams
        ]
        assert native.encode_batch(streams, cfg, parallel_blocks=True) == want
        assert api_batch(streams, cfg, engine="native",
                         parallel_blocks=True) == want
        # quality knobs ride the native batch path too
        want_k = [
            encode(p, cfg, engine="scan", parallel_blocks=True,
                   parallel_chunk_blocks=2, parallel_warm_passes=1)
            for p in streams
        ]
        assert api_batch(streams, cfg, engine="native", parallel_blocks=True,
                         parallel_chunk_blocks=2,
                         parallel_warm_passes=1) == want_k

    def test_batch_auto_routes_natively_off_accelerator(self):
        """engine='auto' on a CPU host = the hybrid one-shot policy: the
        native engines do the work, results identical to the JAX path."""
        from aad_tpu.codec.batch import decode_batch
        from aad_tpu.codec.batch_encode import encode_batch
        from aad_tpu.codec.encoder import EncodeConfig, encode
        import jax

        if jax.default_backend() == "gpu":
            pytest.skip("CPU-host routing test")
        rng = np.random.default_rng(13)
        cfg = EncodeConfig(num_channels=2, sampling_rate=16000,
                           max_block_size=128, num_encode_trials=1)
        streams = [
            rng.integers(-32768, 32768, (2, n)).astype(np.int32)
            for n in (2000, 555)
        ]
        enc = encode_batch(streams, cfg)
        assert enc == [encode(p, cfg, engine="scan") for p in streams]
        assert encode_batch(streams, cfg, parallel_blocks=True) == [
            encode(p, cfg, engine="scan", parallel_blocks=True)
            for p in streams
        ]
        for (h, out), pcm, blob in zip(decode_batch(enc), streams, enc):
            _, want = native.decode(blob)
            np.testing.assert_array_equal(out, np.asarray(want))
            assert out.dtype == np.int16

    def test_encode_channel_mismatch_raises(self):
        from aad_tpu.codec.encoder import EncodeConfig
        from aad_tpu.codec.result import InvalidArgumentError

        cfg = EncodeConfig(num_channels=2, sampling_rate=8000)
        mono = np.zeros((1, 100), dtype=np.int32)
        with pytest.raises(InvalidArgumentError):
            native.encode(mono, cfg)
        with pytest.raises(InvalidArgumentError):
            native.encode_parallel(mono, cfg)

    def test_decode_batch_matches_solo(self):
        from aad_tpu.codec.batch import decode_batch as api_batch
        from aad_tpu.codec.encoder import EncodeConfig, encode

        rng = np.random.default_rng(7)
        cfg = EncodeConfig(num_channels=1, sampling_rate=8000,
                           bits_per_sample=3)
        blobs = [
            encode(
                rng.integers(-32768, 32768, (1, n)).astype(np.int32),
                cfg, engine="scan",
            )
            for n in (2500, 100, 4000)
        ]
        got = native.decode_batch(blobs)
        api = api_batch(blobs, engine="native")
        for (h1, p1), (h2, p2), blob in zip(got, api, blobs):
            hs, ps = native.decode(blob)
            np.testing.assert_array_equal(np.asarray(p1), np.asarray(ps))
            np.testing.assert_array_equal(
                np.asarray(p2), np.asarray(ps).astype(np.int16)
            )
            assert h1.num_samples == hs.num_samples == h2.num_samples


class TestForceScalar:
    """AADX_FORCE_SCALAR=1 parity.

    The native engine dispatches to AVX-512 whenever the host supports it,
    so on such hosts the pure-scalar configuration — the configuration that
    IS the reference's entire codec (reference: src/aad_decoder.c:269-318)
    — would otherwise run only as tail drains. The knob forces scalar at
    both dispatch gates (native/aadx.cc::simd_decode_prefix /
    run_simd_encode_parallel); output must be byte-identical to the SIMD
    path and to the reference binary. The knob is read per entry call, so
    one process can exercise and compare both paths.
    """

    GEOMETRIES = [  # (bps, nch, ms, max_block_size, chunk, warm)
        (4, 2, False, 1024, 1, 0),
        (4, 2, True, 1024, 3, 1),  # chunked+Jacobi-warm parallel mode
        (2, 1, False, 256, 1, 0),
        (3, 2, False, 387, 1, 0),  # odd block -> LCM interleave geometry
    ]

    @pytest.mark.parametrize("bps,nch,ms,mbs,chunk,warm", GEOMETRIES)
    def test_scalar_matches_simd(
        self, monkeypatch, bps, nch, ms, mbs, chunk, warm
    ):
        cfg = EncodeConfig(
            num_channels=nch, sampling_rate=16000, bits_per_sample=bps,
            max_block_size=mbs, ch_process_method=1 if ms else 0,
        )
        nspb = cfg.geometry().num_samples_per_block
        pcm = noise(37 * nspb + 11, nch, seed=bps * 10 + nch)
        monkeypatch.delenv("AADX_FORCE_SCALAR", raising=False)
        enc = native.encode(pcm, cfg)
        par = native.encode_parallel(
            pcm, cfg, chunk_blocks=chunk, warm_passes=warm
        )
        _, dec = native.decode(enc)
        _, decp = native.decode(par)
        monkeypatch.setenv("AADX_FORCE_SCALAR", "1")
        assert native.encode(pcm, cfg) == enc
        assert (
            native.encode_parallel(
                pcm, cfg, chunk_blocks=chunk, warm_passes=warm
            )
            == par
        )
        _, dec_s = native.decode(enc)
        np.testing.assert_array_equal(dec_s, dec)
        _, decp_s = native.decode(par)
        np.testing.assert_array_equal(decp_s, decp)

    def test_scalar_matches_reference_binary(
        self, monkeypatch, reference_cli, tmp_path
    ):
        """Forced-scalar encode bytes and decode samples vs the oracle."""
        from util import reference_decode, reference_encode, write_pcm16_wav

        nch, bps, block = 2, 4, 600
        pcm = noise(48000, nch, seed=7)
        wav = tmp_path / "in.wav"
        write_pcm16_wav(wav, pcm, 16000)
        ref_bytes = reference_encode(
            reference_cli, wav, tmp_path / "ref.aad", bps=bps, block=block
        )
        cfg = EncodeConfig(
            num_channels=nch, sampling_rate=16000, bits_per_sample=bps,
            max_block_size=block,
        )
        monkeypatch.setenv("AADX_FORCE_SCALAR", "1")
        assert native.encode(pcm, cfg) == ref_bytes
        _, ours = native.decode(ref_bytes)
        ref_wav = reference_decode(
            reference_cli, tmp_path / "ref.aad", tmp_path / "ref_out.wav"
        )
        _, golden = read_wav(str(ref_wav))
        np.testing.assert_array_equal(ours, golden >> 16)


class TestMalformedStepIndex:
    """Cross-engine agreement on out-of-range wire step indices.

    The 12-bit block-header index field can carry (4080, 4095] — slot 256,
    one past the 256-entry step table. The reference reads out of bounds
    there (src/aad_tables.h:28; DEBUG-only asserts); this framework pins
    the case to slot 255 in every engine. Found by the round-5 sanitizer
    fuzz (UBSan array-bounds in the scalar path); this test holds the
    cross-engine agreement that makes the fix a format-level semantic.
    """

    def _malformed_stream(self, idx=4095):
        from aad_tpu import FILE_HEADER_SIZE
        from aad_tpu.codec.encoder import encode as jenc

        rng = np.random.default_rng(3)
        pcm = rng.integers(-20000, 20000, (1, 3000)).astype(np.int32)
        cfg = EncodeConfig(num_channels=1, sampling_rate=8000)
        data = bytearray(jenc(pcm, cfg, engine="scan"))
        shift = data[FILE_HEADER_SIZE + 1] & 0xF
        tag = (idx << 4) | shift
        data[FILE_HEADER_SIZE] = tag >> 8
        data[FILE_HEADER_SIZE + 1] = tag & 0xFF
        return bytes(data)

    @pytest.mark.parametrize("idx", [4081, 4095])
    def test_all_native_paths_match_scan(self, monkeypatch, idx):
        data = self._malformed_stream(idx)
        _, want = jax_decode(data, engine="scan")
        want = np.asarray(want)
        monkeypatch.setenv("AADX_FORCE_SCALAR", "1")
        _, got_scalar = native.decode(data)
        np.testing.assert_array_equal(got_scalar, want)
        monkeypatch.delenv("AADX_FORCE_SCALAR")
        _, got_simd = native.decode(data)
        np.testing.assert_array_equal(got_simd, want)


class TestWireCeilingGeometry:
    """The block-size wire field's u16 ceiling, pinned deterministically.

    The soak draws large blocks log-uniformly (round 5); this fixes the
    exact boundary — max_block_size 65535, the largest value the header's
    u16 field can carry (write: reference src/aad_encoder.c:188-217) — so
    the six-figure-nspb geometry math is pinned in-suite, not only
    probabilistically. Mono and stereo, ragged second block.
    """

    @pytest.mark.parametrize("nch", [1, 2])
    def test_u16_ceiling_matches_reference(
        self, reference_cli, tmp_path, nch
    ):
        from util import reference_decode, reference_encode, write_pcm16_wav

        cfg = EncodeConfig(
            num_channels=nch, sampling_rate=8000, bits_per_sample=4,
            max_block_size=65535,
        )
        nspb = cfg.geometry().num_samples_per_block
        # mono packs the full 65535; stereo's 2-byte units leave one spare
        assert cfg.geometry().block_size == (65535 if nch == 1 else 65534)
        n = nspb + nspb // 2  # two blocks, second ragged
        rng = np.random.default_rng(65535 + nch)
        pcm = rng.integers(-32768, 32768, (nch, n)).astype(np.int32)
        wav = tmp_path / "in.wav"
        write_pcm16_wav(wav, pcm, 8000)
        ref = reference_encode(
            reference_cli, wav, tmp_path / "ref.aad", bps=4, block=65535
        )
        assert native.encode(pcm, cfg) == ref
        _, dec = native.decode(ref)
        ref_wav = reference_decode(
            reference_cli, tmp_path / "ref.aad", tmp_path / "dec.wav"
        )
        _, want = read_wav(str(ref_wav))
        np.testing.assert_array_equal(dec, want >> 16)


class TestTinyStreamReferenceOverflow:
    """Streams the reference CLI cannot produce (round-5 finding).

    The reference CLI sizes its encode output buffer as the input WAV's
    file size (reference: src/main.c:171-172) and heap-overflows whenever
    the encoded stream is larger — e.g. 3 stereo samples at -s 40: a
    56-byte WAV but a 67-byte minimum stream (31-byte file header + one
    36-byte block header). docs/DESIGN.md §7 records the find. Our
    encoders must handle the input, and the reference DECODER (which
    sizes from the header) must accept our bytes and reproduce our
    samples — the strongest oracle available when the reference encoder
    cannot run.
    """

    def test_tiny_stream_encodes_and_reference_decodes(
        self, reference_cli, tmp_path
    ):
        from util import reference_decode

        cfg = EncodeConfig(
            num_channels=2, sampling_rate=8000, bits_per_sample=2,
            max_block_size=40,
        )
        rng = np.random.default_rng(112)
        pcm = rng.integers(-512, 512, (2, 3)).astype(np.int32)
        ours = native.encode(pcm, cfg)
        assert ours == jax_encode(pcm, cfg, engine="scan")
        assert len(ours) == 67  # 31-byte file header + one block header
        _, dec = native.decode(ours)
        (tmp_path / "o.aad").write_bytes(ours)
        ref_wav = reference_decode(
            reference_cli, tmp_path / "o.aad", tmp_path / "o.wav"
        )
        _, want = read_wav(str(ref_wav))
        np.testing.assert_array_equal(dec, want >> 16)


class TestForgedCarryState:
    """A forged carry state through the public encode_chunk API must stay
    inside the step table (round-5 review finding: the per-step slot min
    was one-sided, so a negative idx — or INT32_MAX, which wraps negative
    under -fwrapv after the rounding add — indexed out of bounds). The
    carry load now clamps to [0, 4080] like the decode header parse, so a
    forged idx behaves exactly as its clamped value."""

    @pytest.mark.parametrize("forged,clamped", [(-4096, 0), (2**31 - 1, 4080)])
    def test_forged_idx_equals_clamped(self, forged, clamped):
        cfg = EncodeConfig(num_channels=2, sampling_rate=8000,
                           max_block_size=256)
        nspb = cfg.geometry().num_samples_per_block
        pcm = noise(3 * nspb, 2, seed=77)
        state_f, prev_f = native.stream_state(cfg)
        state_c, prev_c = native.stream_state(cfg)
        state_f[:, 8] = forged
        state_c[:, 8] = clamped
        got = native.encode_chunk(pcm, cfg, state_f, prev_f, 1)
        want = native.encode_chunk(pcm, cfg, state_c, prev_c, 1)
        assert got == want
