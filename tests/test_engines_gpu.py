"""The compiled fused decode kernel against the scan engine, on the card.

The scan engine is the portable reference implementation (itself pinned
bit-exact to the C reference by the golden suite); these tests pin the
Triton kernel (ops.pallas_decode) to it at real widths, exactly: the codec
is integer-only, so no tolerance applies. They need an NVIDIA GPU and skip
elsewhere; ``python chip_smoke.py`` runs them on the card.
"""

import pathlib
import sys

import numpy as np
import pytest

import jax.numpy as jnp

pytestmark = pytest.mark.gpu

_ROOT = pathlib.Path(__file__).parent.parent


def _bench():
    sys.path.insert(0, str(_ROOT))
    import bench  # repo-root bench module doubles as a stream generator

    return bench


@pytest.mark.parametrize("bps", [2, 3, 4])
def test_fused_matches_scan(gpu, bps):
    from aad_tpu.ops.decode import _decode_blocks_impl

    rng = np.random.default_rng(0)
    L, T = 1100, 988
    codes = jnp.asarray(rng.integers(0, 2**bps, (L, T)).astype(np.uint8))
    si = jnp.asarray(rng.integers(0, 4081, L).astype(np.int32))
    h = jnp.asarray(rng.integers(-32768, 32768, (L, 4)).astype(np.int32))
    w = jnp.asarray(rng.integers(-40000, 40000, (L, 4)).astype(np.int32))
    out = {
        engine: np.asarray(
            _decode_blocks_impl(
                codes, si, w, h, bits_per_sample=bps, engine=engine
            )
        )
        for engine in ("fused", "scan")
    }
    np.testing.assert_array_equal(out["fused"], out["scan"])


def test_table_read_every_slot(gpu):
    """The compiled kernel's step-size table read at all 256 slots:
    lane s starts at slot s, so its first sample is
    clip16(table[s] * 3 >> 3) (code magnitude 1, zero predictor)."""
    from aad_tpu.ops.decode import _decode_blocks_impl
    from aad_tpu.tables import STEPSIZE_TABLE

    L = 256
    codes = np.ones((L, 8), np.uint8)
    si = np.minimum(np.arange(L, dtype=np.int32) * 16, 4080)
    zeros = jnp.zeros((L, 4), jnp.int32)
    out = np.asarray(
        _decode_blocks_impl(
            jnp.asarray(codes), jnp.asarray(si), zeros, zeros,
            bits_per_sample=4, engine="fused",
        )
    )
    want = np.clip((STEPSIZE_TABLE.astype(np.int64) * 3) >> 3, -32768, 32767)
    np.testing.assert_array_equal(out[:, 4], want)


def test_golden_decode_fused(gpu, fixture_dir):
    """Bit-exact fused-engine decode of the stereo golden fixture."""
    from aad_tpu import decode
    from aad_tpu.format.wav import read_wav

    data = (fixture_dir / "sin300Hz.aad").read_bytes()
    _, pcm = decode(data, engine="fused")
    _, golden = read_wav(str(fixture_dir / "sin300Hz_decoded.wav"))
    np.testing.assert_array_equal(pcm, golden >> 16)


@pytest.mark.parametrize("bps", [2, 3, 4])
def test_real_audio_grid_device_engines(gpu, fixture_dir, bps):
    """Real audio through the device engines, byte-exact vs native: the
    scan encode on the card and the fused decode (reference corpus grid:
    test/test_aad_encode_decode.c:492-636)."""
    from aad_tpu import decode, native
    from aad_tpu.codec.encoder import EncodeConfig, encode
    from aad_tpu.format.wav import read_wav

    fmt, pcm32 = read_wav(str(fixture_dir / "bunny1.wav"))
    pcm = (pcm32 >> 16).astype(np.int32)
    cfg = EncodeConfig(
        num_channels=fmt.num_channels,
        sampling_rate=fmt.sampling_rate,
        bits_per_sample=bps,
        max_block_size=1024,
    )
    want = native.encode(pcm, cfg)
    assert encode(pcm, cfg, engine="scan") == want, f"bps={bps}"
    _, out_native = native.decode(want)
    _, out = decode(want, engine="fused")
    np.testing.assert_array_equal(out_native, np.asarray(out))


def test_overlap_pipeline_bit_exact(gpu):
    """The chunked transfer-overlap schedule equals the single-dispatch
    whole-stream path on the card, where copy_to_host_async really
    streams. Block independence makes chunk boundaries free (reference:
    src/aad_decoder.c:363-380)."""
    from aad_tpu import FILE_HEADER_SIZE, decode_header
    from aad_tpu.codec.decoder import Decoder

    data, _ = _bench().build_synthetic_stream(48000 * 40)
    header = decode_header(data)
    dec = Decoder.from_header(header, engine="fused")
    payload = np.frombuffer(data, dtype=np.uint8)[FILE_HEADER_SIZE:]
    whole = np.asarray(dec.decode_payload_ondevice(payload, overlap_blocks=0))
    np.testing.assert_array_equal(whole, dec.decode_payload_ondevice(payload))
    ragged = dec.decode_payload_ondevice(payload, overlap_blocks=500)
    np.testing.assert_array_equal(whole, ragged)


class TestCompiledRandomGeometry:
    """Random geometries through the compiled kernel on the card, with the
    reference binary as oracle (the CPU soak drives the kernel in interpret
    mode only). Seeds are fixed so the compile cache keeps reruns cheap."""

    @pytest.mark.parametrize("seed", range(6))
    def test_fuzz_both_directions_vs_reference(
        self, gpu, seed, reference_cli, tmp_path
    ):
        sys.path.insert(0, str(pathlib.Path(__file__).parent))
        from util import reference_decode, reference_encode, write_pcm16_wav

        from aad_tpu import decode
        from aad_tpu.codec.encoder import EncodeConfig, encode
        from aad_tpu.format.wav import read_wav

        rng = np.random.default_rng(70_000 + seed)
        nch = int(rng.integers(1, 3))
        bps = int(rng.integers(2, 5))
        mbs = int(rng.integers(40 * nch, 1500))
        ms = int(rng.integers(0, 2)) if nch == 2 else 0
        trials = int(rng.integers(0, 5))
        cfg = EncodeConfig(
            num_channels=nch, sampling_rate=8000, bits_per_sample=bps,
            max_block_size=mbs, ch_process_method=ms,
            num_encode_trials=trials,
        )
        nspb = cfg.geometry().num_samples_per_block
        n = int(rng.integers(1, 5 * nspb + 2))
        pcm = rng.integers(-32768, 32768, (nch, n)).astype(np.int32)

        wav = tmp_path / "in.wav"
        write_pcm16_wav(wav, pcm, 8000)
        ref = reference_encode(
            reference_cli, wav, tmp_path / "ref.aad", bps=bps, block=mbs,
            trials=trials, ms=ms == 1,
        )
        assert encode(pcm, cfg, engine="scan") == ref, (
            f"device encode diverged: seed={seed} cfg={cfg}"
        )
        _, got = decode(ref, engine="fused")
        ref_wav = reference_decode(
            reference_cli, tmp_path / "ref.aad", tmp_path / "dec.wav"
        )
        _, want = read_wav(str(ref_wav))
        np.testing.assert_array_equal(np.asarray(got), want >> 16)


def test_hour_scale_stream_device_decode(gpu):
    """A one-hour stereo stream (345.6 M samples, ~350k blocks) decodes
    through the chunked-overlap device path, bit-identical to the native
    host engine: the paste arithmetic, the shape bucketing and the
    wire-word row slicing all cross the 2^31-byte-index neighbourhood
    here (reference block loop: src/aad_decoder.c:514-534)."""
    from aad_tpu import FILE_HEADER_SIZE, decode_header, native
    from aad_tpu.codec.decoder import Decoder

    data, _ = _bench().build_synthetic_stream(48000 * 3600)
    header = decode_header(data)
    assert header.num_samples * header.num_channels >= 3 * 10**8
    dec = Decoder.from_header(header, engine="fused")
    payload = np.frombuffer(data, dtype=np.uint8)[FILE_HEADER_SIZE:]
    pcm = np.asarray(dec.decode_payload_ondevice(payload))
    assert pcm.shape == (2, header.num_samples)
    _, want = native.decode(data)
    np.testing.assert_array_equal(pcm, want.astype(np.int16))


def test_fused_compiled_u16_ceiling_geometry(gpu):
    """The compiled kernel at the block-size wire field's u16 ceiling
    (65535 -> stereo block_size 65534, nspb 65502): a five-figure word
    loop inside one program. Oracle: the native engine (pinned to the
    reference binary at this geometry by
    tests/test_native.py::TestWireCeilingGeometry)."""
    from aad_tpu import decode, native
    from aad_tpu.codec.encoder import EncodeConfig

    cfg = EncodeConfig(
        num_channels=2, sampling_rate=8000, bits_per_sample=4,
        max_block_size=65535,
    )
    nspb = cfg.geometry().num_samples_per_block
    rng = np.random.default_rng(1)
    pcm = rng.integers(-32768, 32768, (2, nspb + nspb // 2)).astype(np.int32)
    data = native.encode(pcm, cfg)
    _, want = native.decode(data)
    _, got = decode(data, engine="fused")
    np.testing.assert_array_equal(np.asarray(got), want.astype(np.int16))
