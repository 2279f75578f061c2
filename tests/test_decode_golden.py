"""Bit-exact decode conformance against the reference's golden fixtures.

This is the canonical cross-implementation check: decode the checked-in
.aad fixtures and compare sample-exact with the decoded WAVs the reference
produced (the same bar as reference: test/test_aad_decoder.c:256-338).
"""

import numpy as np
import pytest

from aad_tpu import decode
from aad_tpu.format.wav import read_wav


@pytest.mark.parametrize(
    "aad_name,wav_name",
    [
        ("sin300Hz_mono.aad", "sin300Hz_mono_decoded.wav"),
        ("sin300Hz.aad", "sin300Hz_decoded.wav"),
    ],
)
@pytest.mark.parametrize("engine", ["scan", "fused_interpret"])
def test_golden_decode_bit_exact(fixture_dir, aad_name, wav_name, engine):
    data = (fixture_dir / aad_name).read_bytes()
    header, pcm = decode(data, engine=engine)

    fmt, golden = read_wav(str(fixture_dir / wav_name))
    assert fmt.num_channels == header.num_channels
    assert fmt.num_samples == header.num_samples
    # Reference CLI writes decoded samples << 16 into 16-bit WAV
    # (reference: src/main.c:124); canonical WAV form is value << 16 again.
    golden16 = golden >> 16
    np.testing.assert_array_equal(pcm, golden16)
    # dtype guarantee: int32 whatever engine/dispatch served the call
    assert np.asarray(pcm).dtype == np.int32


def test_decode_dtype_guarantee_all_dispatches(fixture_dir):
    """decode() returns int32 for every dispatch: auto (native), each JAX
    engine, and the lenient truncated path (the dtype must not
    depend on native availability)."""
    data = (fixture_dir / "sin300Hz_mono.aad").read_bytes()
    for engine in ("auto", "native", "scan", "fused_interpret"):
        _, pcm = decode(data, engine=engine)
        assert np.asarray(pcm).dtype == np.int32, engine
    _, lenient = decode(data[:-40], engine="auto", strict=False)
    assert np.asarray(lenient).dtype == np.int32


def test_decode_block_range_matches_whole(fixture_dir):
    from aad_tpu import FILE_HEADER_SIZE, Decoder, decode_header, HeaderInfo

    data = (fixture_dir / "sin300Hz.aad").read_bytes()
    header, whole = decode(data, engine="scan")
    dec = Decoder.from_header(header, engine="scan")
    payload = np.frombuffer(data, dtype=np.uint8)[FILE_HEADER_SIZE:]
    nspb = header.num_samples_per_block
    # random-access decode of blocks [3, 7)
    part = np.asarray(dec.decode_block_range(payload, 3, 4))
    np.testing.assert_array_equal(part, whole[:, 3 * nspb : 7 * nspb])
    # a range including the ragged tail
    nblocks = -(-header.num_samples // nspb)
    tail = np.asarray(dec.decode_block_range(payload, nblocks - 2, 2))
    np.testing.assert_array_equal(tail, whole[:, (nblocks - 2) * nspb :])


def test_decode_block_range_out_of_bounds(fixture_dir):
    import numpy as np
    import pytest as _pytest

    from aad_tpu import FILE_HEADER_SIZE, Decoder, decode_header
    from aad_tpu.codec.result import InvalidArgumentError

    data = (fixture_dir / "sin300Hz_mono.aad").read_bytes()
    dec = Decoder.from_header(decode_header(data), engine="scan")
    payload = np.frombuffer(data, dtype=np.uint8)[FILE_HEADER_SIZE:]
    with _pytest.raises(InvalidArgumentError):
        dec.decode_block_range(payload, 9999, 2)
    with _pytest.raises(InvalidArgumentError):
        dec.decode_block_range(payload, -1, 2)


def test_decode_time_range(fixture_dir):
    import numpy as np

    from aad_tpu import FILE_HEADER_SIZE, Decoder, decode, decode_header

    data = (fixture_dir / "sin300Hz.aad").read_bytes()
    header, whole = decode(data, engine="scan")
    dec = Decoder.from_header(header, engine="scan")
    payload = np.frombuffer(data, dtype=np.uint8)[FILE_HEADER_SIZE:]
    got = np.asarray(dec.decode_time_range(payload, 0.1, 0.25))
    s0 = int(0.1 * header.sampling_rate)
    s1 = int(0.25 * header.sampling_rate)
    np.testing.assert_array_equal(got, whole[:, s0:s1])


def test_ondevice_bucketed_decode(fixture_dir):
    """Bucketed on-device pipeline decodes goldens bit-exactly, and nearby
    file lengths share a compiled shape."""
    import numpy as np

    from aad_tpu import FILE_HEADER_SIZE, Decoder, decode_header
    from aad_tpu.codec.decoder import _bucket_blocks
    from aad_tpu.format.wav import read_wav

    data = (fixture_dir / "sin300Hz.aad").read_bytes()
    dec = Decoder.from_header(decode_header(data), engine="scan")
    payload = np.frombuffer(data, dtype=np.uint8)[FILE_HEADER_SIZE:]
    pcm = np.asarray(dec.decode_payload_ondevice(payload))
    _, golden = read_wav(str(fixture_dir / "sin300Hz_decoded.wav"))
    np.testing.assert_array_equal(pcm, golden >> 16)

    # bucketing collapses nearby block counts
    assert _bucket_blocks(25) == _bucket_blocks(26)
    assert _bucket_blocks(5) == 5  # tiny files unbucketed
    for n in (1, 9, 100, 5000):
        assert _bucket_blocks(n) >= n


@pytest.mark.parametrize("nch,ms", [(2, False), (2, True), (1, False)])
def test_ondevice_trim_matches_unbucketed(nch, ms):
    """The device-side padding trim (decoder._trim_lanes) is invisible.

    Bucketed decode downloads only the real blocks (the padded tail is
    sliced off on device before the host transfer); the result must equal
    the unbucketed decode bit-for-bit. Block counts chosen to force real
    padding (21 -> 26, 14 -> 16) so the trim path actually runs, for
    stereo, stereo-MS (post-recombination ordering) and mono.
    """
    from aad_tpu import FILE_HEADER_SIZE, Decoder, EncodeConfig, decode_header, encode
    from aad_tpu.codec.decoder import _bucket_blocks
    from aad_tpu.format.geometry import num_blocks_for

    rng = np.random.default_rng(11)
    n = 20000 if nch == 2 else 28000
    pcm = rng.integers(-20000, 20000, (nch, n)).astype(np.int32)
    cfg = EncodeConfig(
        num_channels=nch,
        sampling_rate=44100,
        ch_process_method=1 if ms else 0,
    )
    blob = bytes(encode(pcm, cfg, engine="scan"))
    h = decode_header(blob[:FILE_HEADER_SIZE])
    nb = num_blocks_for(h.num_samples, h.num_samples_per_block)
    assert _bucket_blocks(nb) > nb  # padding (and so the trim) is active
    dec = Decoder.from_header(h, engine="scan")
    payload = np.frombuffer(blob, np.uint8)[FILE_HEADER_SIZE:]
    a = np.asarray(dec.decode_payload_ondevice(payload, bucket=True))
    b = np.asarray(dec.decode_payload_ondevice(payload, bucket=False))
    np.testing.assert_array_equal(a, b)


class TestOverlapPipeline:
    """The chunked transfer-overlap decode (Decoder._decode_prefix_overlap)
    must be bit-identical to the whole-stream pipeline for every engine,
    chunk size, ragged tail, and MS mode — block independence (reference:
    src/aad_decoder.c:363-380) is what makes chunk boundaries free."""

    @staticmethod
    def _stream(nch, bps, ms, n, seed=7):
        from aad_tpu import FILE_HEADER_SIZE, EncodeConfig, decode_header, encode

        rng = np.random.default_rng(seed)
        pcm = rng.integers(-20000, 20000, (nch, n)).astype(np.int32)
        cfg = EncodeConfig(
            num_channels=nch,
            sampling_rate=44100,
            bits_per_sample=bps,
            max_block_size=128,
            ch_process_method=1 if ms else 0,
            num_encode_trials=0,
        )
        blob = bytes(encode(pcm, cfg, engine="scan"))
        h = decode_header(blob[:FILE_HEADER_SIZE])
        payload = np.frombuffer(blob, np.uint8)[FILE_HEADER_SIZE:]
        return h, payload

    @pytest.mark.parametrize(
        "nch,bps,ms", [(2, 4, False), (1, 3, False), (2, 2, True)]
    )
    def test_scan_overlap_matches_whole(self, nch, bps, ms):
        from aad_tpu import Decoder

        h, payload = self._stream(nch, bps, ms, 40000)
        dec = Decoder.from_header(h, engine="scan")
        whole = np.asarray(dec.decode_payload_ondevice(payload, overlap_blocks=0))
        for cb in (7, 16, 64):  # ragged tails at every size
            got = dec.decode_payload_ondevice(payload, overlap_blocks=cb)
            assert got.dtype == np.int16
            np.testing.assert_array_equal(whole, got)

    def test_fused_overlap_matches_whole(self):
        """Fused engine (interpreted): chunk sizes round up to whole kernel
        lane blocks and the packed-u32 chunk rows reassemble bit-exactly."""
        from aad_tpu import Decoder

        h, payload = self._stream(2, 4, False, 67000)  # ~698 blocks > 512
        dec = Decoder.from_header(h, engine="fused_interpret")
        whole = np.asarray(dec.decode_payload_ondevice(payload, overlap_blocks=0))
        got = dec.decode_payload_ondevice(payload, overlap_blocks=512)
        np.testing.assert_array_equal(whole, got)
        # a misaligned request rounds up to the lane multiple, not an error
        got = dec.decode_payload_ondevice(payload, overlap_blocks=500)
        np.testing.assert_array_equal(whole, got)

    def test_fused_overlap_ms_matches_whole_and_scan(self):
        """MS streams through the fused overlap path: the round-5
        word-space recombination returns packed u32, so the chunk paste's
        dtype view and the trim slice must stay bit-exact under MS too."""
        from aad_tpu import Decoder

        h, payload = self._stream(2, 4, True, 67000)
        fused = Decoder.from_header(h, engine="fused_interpret")
        whole = np.asarray(
            fused.decode_payload_ondevice(payload, overlap_blocks=0)
        )
        got = fused.decode_payload_ondevice(payload, overlap_blocks=512)
        np.testing.assert_array_equal(whole, got)
        scan = Decoder.from_header(h, engine="scan")
        want = np.asarray(
            scan.decode_payload_ondevice(payload, overlap_blocks=0)
        )
        np.testing.assert_array_equal(whole, want.astype(whole.dtype))

    def test_negative_overlap_blocks_raises(self):
        """A negative chunk size must raise, not silently return zeros
        (range(negative_chunk_count) is empty, so the dispatch loop would
        never run and the zero-initialised buffer would be 'the decode')."""
        from aad_tpu import Decoder
        from aad_tpu.codec.result import InvalidArgumentError

        h, payload = self._stream(2, 4, False, 40000)
        dec = Decoder.from_header(h, engine="scan")
        with pytest.raises(InvalidArgumentError):
            dec.decode_payload_ondevice(payload, overlap_blocks=-7)

    def test_lenient_overlap_matches_whole(self):
        """strict=False truncated decode through the overlap path."""
        from aad_tpu import Decoder

        h, payload = self._stream(2, 4, False, 40000)
        dec = Decoder.from_header(h, engine="scan")
        cut = payload[: payload.shape[0] - 3 * h.block_size - 5]
        whole = np.asarray(
            dec.decode_payload_ondevice(cut, strict=False, overlap_blocks=0)
        )
        got = dec.decode_payload_ondevice(cut, strict=False, overlap_blocks=16)
        np.testing.assert_array_equal(whole, got)


class TestTruncationJaxEngines:
    """Mid-stream cuts must raise typed errors on every decode path — never
    silently return a garbage tail. Stricter than the reference, which
    decodes whatever prefix exists and returns OK with a zero tail
    (reference: src/aad_decoder.c:514-534); matches the native engine
    (tests/test_native.py::TestRobustness)."""

    @pytest.fixture(scope="class")
    def stream(self, fixture_dir):
        return (fixture_dir / "sin300Hz.aad").read_bytes()

    @pytest.mark.parametrize("cut", [40, 200, 5000, -1, -50])
    def test_whole_decode_truncated_raises(self, stream, cut):
        from aad_tpu.codec.result import InsufficientDataError

        blob = stream[:cut] if cut > 0 else stream[: len(stream) + cut]
        with pytest.raises(InsufficientDataError):
            decode(blob, engine="scan")

    @pytest.mark.parametrize("cut", [1, 4000])
    def test_ondevice_pipeline_truncated_raises(self, stream, cut):
        from aad_tpu import FILE_HEADER_SIZE, Decoder, decode_header
        from aad_tpu.codec.result import InsufficientDataError

        dec = Decoder.from_header(decode_header(stream), engine="scan")
        payload = np.frombuffer(stream, dtype=np.uint8)[FILE_HEADER_SIZE:]
        with pytest.raises(InsufficientDataError):
            dec.decode_payload_ondevice(payload[:-cut])

    def test_trailing_garbage_tolerated(self, stream):
        header, want = decode(stream, engine="scan")
        _, got = decode(stream + b"\xa5" * 13, engine="scan")
        np.testing.assert_array_equal(got, want)


class TestLenientTruncation:
    """strict=False reproduces the reference's decode-what's-there loop
    (reference: src/aad_decoder.c:514-538): whole blocks present in the
    payload decode normally and the missing tail returns as zero samples
    (where the reference CLI writes uninitialised memory,
    src/main.c:102-126)."""

    @pytest.fixture(scope="class")
    def stream(self, fixture_dir):
        return (fixture_dir / "sin300Hz.aad").read_bytes()

    @pytest.mark.parametrize("engine", ["scan", "auto"])
    def test_block_boundary_cut_decodes_prefix(self, stream, engine):
        from aad_tpu import FILE_HEADER_SIZE

        header, whole = decode(stream, engine="scan")
        bs = header.block_size
        nspb = header.num_samples_per_block
        cut = FILE_HEADER_SIZE + 5 * bs  # exactly five whole blocks
        _, got = decode(stream[:cut], engine=engine, strict=False)
        assert got.shape == whole.shape
        np.testing.assert_array_equal(got[:, : 5 * nspb], whole[:, : 5 * nspb])
        assert not np.any(got[:, 5 * nspb :])

    @pytest.mark.parametrize("engine", ["scan", "auto"])
    def test_midblock_cut_keeps_whole_blocks(self, stream, engine):
        from aad_tpu import FILE_HEADER_SIZE

        header, whole = decode(stream, engine="scan")
        bs = header.block_size
        nspb = header.num_samples_per_block
        # cut inside block 3's data region but past its block header: the
        # partial block decodes with the missing bytes as zero codes, so
        # only the first 3 whole blocks are asserted sample-exact
        cut = FILE_HEADER_SIZE + 3 * bs + 40
        _, got = decode(stream[:cut], engine=engine, strict=False)
        np.testing.assert_array_equal(got[:, : 3 * nspb], whole[:, : 3 * nspb])

    @pytest.mark.parametrize("engine", ["scan", "auto"])
    def test_subheader_fragment_dropped(self, stream, engine):
        from aad_tpu import FILE_HEADER_SIZE

        header, whole = decode(stream, engine="scan")
        bs = header.block_size
        nspb = header.num_samples_per_block
        # 10 bytes < the 36-byte stereo block header: fragment is dropped
        cut = FILE_HEADER_SIZE + 2 * bs + 10
        _, got = decode(stream[:cut], engine=engine, strict=False)
        np.testing.assert_array_equal(got[:, : 2 * nspb], whole[:, : 2 * nspb])
        assert not np.any(got[:, 2 * nspb :])

    def test_full_stream_unaffected(self, stream):
        _, want = decode(stream, engine="scan")
        _, got = decode(stream, engine="scan", strict=False)
        np.testing.assert_array_equal(got, want)

    def test_native_lenient_matches_scan_exactly(self, stream):
        """The partial block's zero-code decode must agree bit-for-bit
        between the JAX prefix path and the native zero-padded-span path
        (zero code bytes ARE zero codes), at every cut class."""
        from aad_tpu import FILE_HEADER_SIZE
        from aad_tpu import native

        if not native.available():
            pytest.skip("native codec unavailable")
        header, _ = decode(stream, engine="scan")
        bs = header.block_size
        for cut in (
            FILE_HEADER_SIZE + 5 * bs,       # block boundary
            FILE_HEADER_SIZE + 3 * bs + 40,  # mid-data
            FILE_HEADER_SIZE + 2 * bs + 10,  # sub-header fragment
            FILE_HEADER_SIZE + 2,            # sub-header of block 0
            len(stream) - 1,                 # one byte short
        ):
            _, want = decode(stream[:cut], engine="scan", strict=False)
            _, got = decode(stream[:cut], engine="native", strict=False)
            np.testing.assert_array_equal(got, np.asarray(want))
