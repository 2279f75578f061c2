"""Block-independent parallel encode mode.

Every block is encoded from a fresh processor state — the reference's
first-block semantics, trial search included (the warm-up on the previous
block only happens from block 1 on, reference: src/aad_encoder.c:503) — so
the block axis becomes a lane axis and all blocks of one stream encode
concurrently. The output is a valid stream for any conforming decoder
(each block header carries the complete decoder state, reference:
src/aad_decoder.c:363-380); the defining byte-level property pinned here is
that the parallel stream equals the concatenation of independent
single-block encodes.
"""

import numpy as np
import pytest

from aad_tpu.codec.batch_encode import encode_batch
from aad_tpu.codec.decoder import decode
from aad_tpu.codec.encoder import EncodeConfig, encode


def _signal(nch: int, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    sig = 7000 * np.sin(t / 7.0)[None, :] + rng.integers(-500, 500, (nch, n))
    return np.clip(sig, -32768, 32767).astype(np.int32)


def _cfg(nch, bps, ms=0, trials=2, block=128):
    return EncodeConfig(
        num_channels=nch,
        sampling_rate=16000,
        bits_per_sample=bps,
        max_block_size=block,
        ch_process_method=ms,
        num_encode_trials=trials,
    )


GRID = [
    (1, 4, 0, 2),
    (2, 4, 1, 2),
    (1, 3, 0, 1),
    (2, 3, 0, 2),
    (1, 2, 0, 0),
    (2, 2, 1, 1),
]


@pytest.mark.parametrize("nch,bps,ms,trials", GRID)
def test_parallel_equals_per_block_encodes(nch, bps, ms, trials):
    """The defining property: parallel stream == concatenated independent
    single-block encodes, byte for byte (incl. a short final block)."""
    cfg = _cfg(nch, bps, ms, trials)
    nspb = cfg.geometry().num_samples_per_block
    n = nspb * 4 + max(nspb // 3, 5)
    pcm = _signal(nch, n, seed=bps + nch)

    par = encode(pcm, cfg, engine="scan", parallel_blocks=True)

    parts = []
    for b in range(5):
        sl = pcm[:, b * nspb : (b + 1) * nspb]
        if sl.shape[1] == 0:
            break
        parts.append(encode(sl, cfg, engine="scan")[31:])
    assert par == par[:31] + b"".join(parts)


def test_parallel_first_block_equals_sequential():
    """Block 0 of a parallel stream is byte-identical to the sequential
    encoder's block 0 (both start from the initial state)."""
    cfg = _cfg(2, 4)
    geo = cfg.geometry()
    pcm = _signal(2, geo.num_samples_per_block * 3, seed=9)
    par = encode(pcm, cfg, engine="scan", parallel_blocks=True)
    seq = encode(pcm, cfg, engine="scan")
    assert par[31 : 31 + geo.block_size] == seq[31 : 31 + geo.block_size]


@pytest.mark.parametrize("bps,ceiling", [(4, 5e-2), (3, 6e-2), (2, 8e-2)])
def test_parallel_roundtrip_quality(bps, ceiling):
    """Parallel streams stay inside the reference's sine RMSE ceilings
    (reference: test/test_aad_encode_decode.c:303-340)."""
    cfg = EncodeConfig(
        num_channels=2, sampling_rate=44100, bits_per_sample=bps
    )
    n = cfg.geometry().num_samples_per_block * 3 + 55
    t = np.arange(n, dtype=np.float64)
    wave = (16384 * np.sin(2 * np.pi * 440.0 * t / 44100)).astype(np.int32)
    pcm = np.stack([wave, wave])
    blob = encode(pcm, cfg, engine="scan", parallel_blocks=True)
    header, dec = decode(blob)
    rmse = np.sqrt(
        np.mean((np.asarray(dec, np.float64) - pcm) ** 2)
    ) / 32768.0
    assert rmse < ceiling


def _native_or_skip():
    from aad_tpu import native

    if not native.available():
        pytest.skip("native codec unavailable")
    return native


@pytest.mark.parametrize("trials", [0, 1, 2, 3, 4, 5])
def test_sequential_scan_trials_match_native(trials):
    """Device (scan) sequential encode == native bytes for trial searches
    of depth 0-5: stereo with a ragged final block, the selection
    semantics of the reference trial loop (src/aad_encoder.c:470-562)."""
    native = _native_or_skip()
    cfg = _cfg(2, 4, trials=trials, block=320)
    nspb = cfg.geometry().num_samples_per_block
    pcm = _signal(2, 3 * nspb - 37, seed=40 + trials)
    assert encode(pcm, cfg, engine="scan") == native.encode(pcm, cfg)


@pytest.mark.parametrize("parallel", [False, True])
def test_mono_3bit_large_block_matches_native(parallel):
    """Mono 3-bit 1023-byte blocks (2684 samples per block, the largest
    block the bench shapes use) with a ragged final block: scan == native
    in sequential and block-parallel mode."""
    native = _native_or_skip()
    cfg = _cfg(1, 3, trials=1, block=1023)
    nspb = cfg.geometry().num_samples_per_block
    assert nspb == 2684
    pcm = _signal(1, 2 * nspb - 37, seed=3)
    if parallel:
        want = native.encode_parallel(pcm, cfg)
    else:
        want = native.encode(pcm, cfg)
    assert encode(pcm, cfg, engine="scan", parallel_blocks=parallel) == want


@pytest.mark.parametrize(
    "trials,chunk_blocks,warm_passes",
    [(0, 1, 0), (2, 1, 0), (1, 2, 1), (1, 1, 1)],
)
def test_parallel_scan_chunk_warm_matches_native(
    trials, chunk_blocks, warm_passes
):
    """Block-parallel scan encode == native for the chunk/warm settings
    and trial counts the device path serves (stereo 4-bit, ragged tail)."""
    native = _native_or_skip()
    cfg = _cfg(2, 4, trials=trials)
    nspb = cfg.geometry().num_samples_per_block
    pcm = _signal(2, 6 * nspb - 17, seed=53)
    got = encode(
        pcm, cfg, engine="scan", parallel_blocks=True,
        parallel_chunk_blocks=chunk_blocks,
        parallel_warm_passes=warm_passes,
    )
    want = native.encode_parallel(
        pcm, cfg, chunk_blocks=chunk_blocks, warm_passes=warm_passes
    )
    assert got == want


def test_batch_parallel_matches_solo():
    """encode_batch(parallel_blocks=True): every stream equals its solo
    parallel encode, across unequal lengths."""
    cfg = _cfg(2, 4, ms=1)
    nspb = cfg.geometry().num_samples_per_block
    streams = [
        _signal(2, nspb * 3 + 7, seed=1),
        _signal(2, nspb + 1, seed=2),
        _signal(2, nspb * 2, seed=3),
    ]
    batch = encode_batch(streams, cfg, engine="scan", parallel_blocks=True)
    for pcm, blob in zip(streams, batch):
        assert blob == encode(pcm, cfg, engine="scan", parallel_blocks=True)


def test_parallel_block_bucketing_pad_path():
    """Block counts are padded to a geometric bucket for compile reuse; the
    pad blocks (valid=0) must not change the payload."""
    cfg = _cfg(1, 4)
    nspb = cfg.geometry().num_samples_per_block
    B = 9  # buckets to 10
    pcm = _signal(1, B * nspb - 13, seed=23)
    par = encode(pcm, cfg, engine="scan", parallel_blocks=True)
    parts = []
    for b in range(B):
        sl = pcm[:, b * nspb : (b + 1) * nspb]
        parts.append(encode(sl, cfg, engine="scan")[31:])
    assert par == par[:31] + b"".join(parts)


def test_parallel_decodes_with_reference_semantics():
    """A parallel stream decodes identically through the JAX decoder and
    the native C++ decoder (which mirrors the reference exactly)."""
    from aad_tpu import native

    if not native.available():  # pragma: no cover
        pytest.skip("native codec unavailable")
    cfg = _cfg(2, 4, ms=1)
    pcm = _signal(2, cfg.geometry().num_samples_per_block * 3 + 77, seed=31)
    blob = encode(pcm, cfg, engine="scan", parallel_blocks=True)
    _, dec_jax = decode(blob)
    _, dec_nat = native.decode(blob)
    np.testing.assert_array_equal(np.asarray(dec_jax), np.asarray(dec_nat))


def test_chunked_parallel_equals_per_chunk_encodes():
    """chunk_blocks=c: the stream equals concatenated independent
    c-block-span sequential encodes (true sequential semantics within a
    chunk, stream-head semantics at every chunk head)."""
    cfg = _cfg(2, 4, trials=2)
    nspb = cfg.geometry().num_samples_per_block
    c = 3
    n = nspb * 7 + 41  # 3 chunks, last one partial
    pcm = _signal(2, n, seed=41)
    par = encode(
        pcm, cfg, engine="scan", parallel_blocks=True,
        parallel_chunk_blocks=c,
    )
    parts = []
    for g in range(3):
        sl = pcm[:, g * c * nspb : (g + 1) * c * nspb]
        if sl.shape[1] == 0:
            break
        parts.append(encode(sl, cfg, engine="scan")[31:])
    assert par == par[:31] + b"".join(parts)


def test_chunk_spanning_stream_equals_sequential():
    """chunk_blocks >= num blocks: parallel mode IS the sequential encode,
    byte for byte (the whole stream is one chunk)."""
    cfg = _cfg(2, 3, ms=1, trials=2)
    nspb = cfg.geometry().num_samples_per_block
    pcm = _signal(2, nspb * 4 + 19, seed=43)
    par = encode(
        pcm, cfg, engine="scan", parallel_blocks=True,
        parallel_chunk_blocks=64,
    )
    seq = encode(pcm, cfg, engine="scan")
    assert par == seq


def test_warm_pass_stream_decodes_and_improves():
    """Jacobi warm passes emit valid streams with RMSE strictly between
    cold-parallel and sequential on an LMS-unfriendly signal."""
    rng = np.random.default_rng(47)
    cfg = _cfg(1, 4, trials=1, block=1024)
    nspb = cfg.geometry().num_samples_per_block
    n = nspb * 6
    # strongly tonal signal: the predictor needs cross-block history
    t = np.arange(n, dtype=np.float64)
    pcm = np.clip(
        12000 * np.sin(2 * np.pi * t / 450.0)
        + 4000 * np.sin(2 * np.pi * t / 37.0)
        + rng.integers(-200, 200, (1, n)),
        -32768, 32767,
    ).astype(np.int32)

    def rmse(blob):
        _, dec = decode(blob)
        return float(
            np.sqrt(np.mean((np.asarray(dec, np.float64) - pcm) ** 2))
        )

    cold = rmse(encode(pcm, cfg, engine="scan", parallel_blocks=True))
    warm = rmse(
        encode(
            pcm, cfg, engine="scan", parallel_blocks=True,
            parallel_warm_passes=2,
        )
    )
    seq = rmse(encode(pcm, cfg, engine="scan"))
    assert warm <= cold
    assert warm < cold * 1.001 or cold == seq  # warm never hurts


class TestNativeParallel:
    """The AVX-512/scalar native block-parallel engine (aadx_encode_parallel)
    must be byte-identical to the JAX parallel mode — the fourth pinned
    implementation of the block-independent contract."""

    @pytest.mark.parametrize("nch,bps,ms,trials", GRID)
    def test_native_parallel_matches_scan(self, nch, bps, ms, trials):
        from aad_tpu import native

        if not native.available():
            pytest.skip("native codec unavailable")
        cfg = _cfg(nch, bps, ms, trials)
        nspb = cfg.geometry().num_samples_per_block
        # >= 2 full SIMD chunks (32 lanes) plus a scalar remainder + ragged
        # tail so every path in the native dispatcher runs
        n = nspb * (64 // nch + 3) + max(nspb // 3, 5)
        pcm = _signal(nch, n, seed=3 * bps + nch)
        a = native.encode_parallel(pcm, cfg)
        b = encode(pcm, cfg, engine="scan", parallel_blocks=True)
        assert a == b

    @pytest.mark.parametrize("nch,bps,ms,trials", GRID)
    @pytest.mark.parametrize("c", [2, 5, 64])
    def test_native_chunked_matches_scan(self, nch, bps, ms, trials, c):
        """The chunked quality knob (parallel_chunk_blocks=c) through the
        native SIMD lanes: chunks walk their c blocks sequentially per
        lane, byte-identical to the JAX chunked mode."""
        from aad_tpu import native

        if not native.available():
            pytest.skip("native codec unavailable")
        cfg = _cfg(nch, bps, ms, trials)
        nspb = cfg.geometry().num_samples_per_block
        # >= 1 full SIMD chunk-group at c=2/5 plus scalar chunks + tail
        n = nspb * (c * (32 // nch) + 2 * c + 1) + 7
        pcm = _signal(nch, n, seed=7 * bps + nch + c)
        a = native.encode_parallel(pcm, cfg, chunk_blocks=c)
        b = encode(pcm, cfg, engine="scan", parallel_blocks=True,
                   parallel_chunk_blocks=c)
        assert a == b

    def test_native_chunked_degenerates_to_sequential(self):
        from aad_tpu import native

        if not native.available():
            pytest.skip("native codec unavailable")
        cfg = _cfg(2, 4, 1, 2)
        nspb = cfg.geometry().num_samples_per_block
        pcm = _signal(2, nspb * 9 + 13, seed=5)
        assert native.encode_parallel(pcm, cfg, chunk_blocks=10**6) == \
            native.encode(pcm, cfg)

    @pytest.mark.parametrize("seed", range(3))
    def test_native_chunked_random_geometry(self, seed):
        """Random geometry x random chunk size through the chunked SIMD
        walk, vs the scan chunked mode."""
        from aad_tpu import native
        from aad_tpu.codec.encoder import EncodeConfig

        if not native.available():
            pytest.skip("native codec unavailable")
        rng = np.random.default_rng(4000 + seed)
        nch = int(rng.integers(1, 3))
        bps = int(rng.integers(2, 5))
        mbs = int(rng.integers(40 * nch, 500))
        c = int(rng.integers(2, 9))
        cfg = EncodeConfig(
            num_channels=nch, sampling_rate=8000, bits_per_sample=bps,
            max_block_size=mbs,
            ch_process_method=int(rng.integers(0, 2)) if nch == 2 else 0,
            num_encode_trials=int(rng.integers(0, 3)),
        )
        nspb = cfg.geometry().num_samples_per_block
        n = int(rng.integers(1, nspb * (c * (32 // nch) + c + 2)))
        pcm = rng.integers(-32768, 32768, (nch, n)).astype(np.int32)
        a = native.encode_parallel(pcm, cfg, chunk_blocks=c)
        b = encode(pcm, cfg, engine="scan", parallel_blocks=True,
                   parallel_chunk_blocks=c)
        assert a == b, f"{cfg} c={c} n={n}"

    @pytest.mark.parametrize("seed", range(4))
    def test_native_warm_random_geometry(self, seed):
        """Random geometry x chunk size x warm passes: the native Jacobi
        refinement (scalar warm walks seeding the SIMD/scalar final
        encode, aadx.cc::warm_walk_chunk) vs the scan warm mode
        (ops/encode.py::parallel_warm_states), byte-exact. Covers SIMD
        seed injection, the scalar-tail seed, and ragged tails."""
        from aad_tpu import native
        from aad_tpu.codec.encoder import EncodeConfig

        if not native.available():
            pytest.skip("native codec unavailable")
        rng = np.random.default_rng(6000 + seed)
        nch = int(rng.integers(1, 3))
        bps = int(rng.integers(2, 5))
        mbs = int(rng.integers(40 * nch, 500))
        c = int(rng.integers(1, 6))
        k = int(rng.integers(1, 4))
        cfg = EncodeConfig(
            num_channels=nch, sampling_rate=8000, bits_per_sample=bps,
            max_block_size=mbs,
            ch_process_method=int(rng.integers(0, 2)) if nch == 2 else 0,
            num_encode_trials=int(rng.integers(0, 3)),
        )
        nspb = cfg.geometry().num_samples_per_block
        n = int(rng.integers(1, nspb * (c * (32 // nch) + c + 2)))
        pcm = rng.integers(-32768, 32768, (nch, n)).astype(np.int32)
        a = native.encode_parallel(pcm, cfg, chunk_blocks=c, warm_passes=k)
        b = encode(pcm, cfg, engine="scan", parallel_blocks=True,
                   parallel_chunk_blocks=c, parallel_warm_passes=k)
        assert a == b, f"{cfg} c={c} k={k} n={n}"

    @pytest.mark.parametrize("seed", range(4))
    def test_native_parallel_random_geometry(self, seed):
        """Random (odd) block geometries through the SIMD dispatcher: the
        LCM interleave-unit math must hold in the vector emit/assembly
        paths too, not just at the default 1024-byte block. Stream length
        guarantees full SIMD chunks, the scalar full-block remainder AND a
        ragged tail in one stream."""
        from aad_tpu import native

        if not native.available():
            pytest.skip("native codec unavailable")
        rng = np.random.default_rng(4000 + seed)
        nch = int(rng.integers(1, 3))
        cfg = EncodeConfig(
            num_channels=nch,
            sampling_rate=8000,
            bits_per_sample=int(rng.integers(2, 5)),
            max_block_size=int(rng.integers(40 * nch, 500)),
            ch_process_method=int(rng.integers(0, 2)) if nch == 2 else 0,
            num_encode_trials=int(rng.integers(0, 3)),
        )
        nspb = cfg.geometry().num_samples_per_block
        nblocks = 32 // nch + int(rng.integers(1, 16 // nch))
        n = nspb * nblocks + int(rng.integers(1, nspb))
        pcm = rng.integers(-32768, 32768, (nch, n)).astype(np.int32)
        a = native.encode_parallel(pcm, cfg)
        b = encode(pcm, cfg, engine="scan", parallel_blocks=True)
        assert a == b, f"geometry {cfg} diverged"
        # the stream is long enough to engage the AVX-512 *decode* block
        # groups too (the short geometry-fuzz streams only hit its scalar
        # tail), so pin the SIMD gather math at odd geometries both ways
        _, d_native = native.decode(a)
        _, d_scan = decode(a, engine="scan")
        np.testing.assert_array_equal(
            np.asarray(d_native), np.asarray(d_scan)
        )

    def test_native_engine_param_and_auto_routing(self):
        from aad_tpu import native

        if not native.available():
            pytest.skip("native codec unavailable")
        cfg = _cfg(2, 4, 0, 2)
        nspb = cfg.geometry().num_samples_per_block
        pcm = _signal(2, nspb * 20 + 11, seed=9)
        want = encode(pcm, cfg, engine="scan", parallel_blocks=True)
        assert encode(pcm, cfg, engine="native", parallel_blocks=True) == want
        # auto routes plain parallel mode natively off-accelerator
        assert encode(pcm, cfg, engine="auto", parallel_blocks=True) == want
        # the chunked knob rides the native lanes too
        want_c = encode(pcm, cfg, engine="scan", parallel_blocks=True,
                        parallel_chunk_blocks=3)
        assert encode(pcm, cfg, engine="native", parallel_blocks=True,
                      parallel_chunk_blocks=3) == want_c
        assert encode(pcm, cfg, engine="auto", parallel_blocks=True,
                      parallel_chunk_blocks=3) == want_c
        # the Jacobi warm quality knob, native vs JAX (scalar warm walks
        # seeding the SIMD final encode)
        want_w = encode(pcm, cfg, engine="scan", parallel_blocks=True,
                        parallel_chunk_blocks=3, parallel_warm_passes=2)
        assert encode(pcm, cfg, engine="native", parallel_blocks=True,
                      parallel_chunk_blocks=3,
                      parallel_warm_passes=2) == want_w
