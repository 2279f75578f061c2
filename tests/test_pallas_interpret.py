"""The fused decode kernel's logic on the CPU, through Pallas interpret mode.

``engine="fused_interpret"`` runs the GPU kernel (ops.pallas_decode) op by
op on the CPU, so the CPU suite checks the kernel itself against the scan
engine, not only the code around it. Shapes are kept small because
interpreted programs run slowly. Bit-exactness bar matches the reference
decoder suite (reference: test/test_aad_decoder.c:256-338).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest

from aad_tpu.format.geometry import compute_block_geometry
from aad_tpu.format.framing import (
    BlockStates,
    assemble_stream,
    build_block_headers,
)
from aad_tpu.ops.pallas_decode import LANE_BLOCK

RNG = np.random.default_rng(7)


def _random_states(nb, nch, rng=RNG):
    return BlockStates(
        step_index=rng.integers(0, 4081, (nb, nch)).astype(np.int32),
        weight=rng.integers(-20000, 20000, (nb, nch, 4)).astype(np.int32),
        history=rng.integers(-32768, 32768, (nb, nch, 4)).astype(np.int32),
    )


def _lane_inputs(L, T, bps, lo=0, hi=4081):
    codes = jnp.asarray(RNG.integers(0, 2**bps, (L, T), dtype=np.uint8))
    si = jnp.asarray(RNG.integers(lo, hi, (L,)).astype(np.int32))
    wt = jnp.asarray(RNG.integers(-20000, 20000, (L, 4)).astype(np.int32))
    hi_ = jnp.asarray(RNG.integers(-32768, 32768, (L, 4)).astype(np.int32))
    return codes, si, wt, hi_


def _both_engines(codes, si, wt, hi, bps):
    from aad_tpu.ops.decode import _decode_blocks_impl

    fused = _decode_blocks_impl(
        codes, si, wt, hi, bits_per_sample=bps, engine="fused_interpret"
    )
    scan = _decode_blocks_impl(
        codes, si, wt, hi, bits_per_sample=bps, engine="scan"
    )
    return np.asarray(fused), np.asarray(scan)


@pytest.mark.parametrize("bps", [2, 3, 4])
def test_fused_decode_kernel_matches_scan(bps):
    """Codes-level entry: kernel (interpret) == lax.scan engine."""
    fused, scan = _both_engines(*_lane_inputs(24, 70, bps), bps)
    np.testing.assert_array_equal(fused, scan)


def _wire_stream(nch, bps, ms, nb, rng):
    geo = compute_block_geometry(64 * nch, nch, bps)
    nspb = geo.num_samples_per_block
    ns = nb * nspb - 3
    codes = rng.integers(0, 2**bps, (nb, nch, geo.codes_per_block),
                         dtype=np.uint8)
    hdr = build_block_headers(
        _random_states(nb, nch, rng), np.zeros((nb, nch), np.int32), geo
    )
    return geo, ns, np.asarray(assemble_stream(hdr, codes, geo, ns))


# Lane counts C * B around the kernel's lane block: one program with one
# live lane (two under MS, which needs both channels), a count that is not
# a multiple of the lane block, and several lane blocks.
_LANES = {"one": 1, "ragged": LANE_BLOCK + 2, "several": 3 * LANE_BLOCK - 20}


@pytest.mark.parametrize("ms", [False, True])
@pytest.mark.parametrize("lanes", sorted(_LANES))
@pytest.mark.parametrize("bps", [2, 3, 4])
def test_fused_pipeline_matches_scan(bps, lanes, ms):
    """The wire-word pipeline with the kernel (interpret) == with scan,
    for every bit depth, lane count class and MS on/off."""
    from aad_tpu.codec.decoder import _device_pipeline_words
    from aad_tpu.ops.wire32 import payload_to_words_split

    nch = 2 if ms else 1
    nb = max(1, _LANES[lanes] // nch)
    rng = np.random.default_rng(1000 + 10 * bps + nb)
    geo, ns, payload = _wire_stream(nch, bps, ms, nb, rng)
    hdr_w, data_w = payload_to_words_split(payload, geo, nb)
    out = {}
    for engine in ("scan", "fused_interpret"):
        lanes_out = np.asarray(
            _device_pipeline_words(
                jnp.asarray(hdr_w), jnp.asarray(data_w), geo=geo,
                num_blocks=nb, bits_per_sample=bps, ms=ms, engine=engine,
            )
        )
        out[engine] = lanes_out.reshape(nch, -1)[:, :ns]
    np.testing.assert_array_equal(out["fused_interpret"], out["scan"])


@pytest.mark.parametrize("nch,bps", [(2, 4), (1, 4), (2, 3), (2, 2)])
def test_wire32_fused_pipeline_matches_u8_scan(nch, bps):
    """Full words pipeline + kernel (interpret) == u8 scan pipeline."""
    from aad_tpu.codec.decoder import _device_pipeline, _device_pipeline_words
    from aad_tpu.ops.wire32 import payload_to_words_split

    geo = compute_block_geometry(128, nch, bps)
    nspb = geo.num_samples_per_block
    nb = 5
    ns = nb * nspb - 3
    T = geo.codes_per_block
    codes = RNG.integers(0, 2**bps, (nb, nch, T), dtype=np.uint8)
    states = _random_states(nb, nch)
    hdr = build_block_headers(states, np.zeros((nb, nch), np.int32), geo)
    payload = np.asarray(assemble_stream(hdr, codes, geo, ns))

    buf = np.zeros(nb * geo.block_size, np.uint8)
    buf[: len(payload)] = payload
    want = np.asarray(
        _device_pipeline(
            jnp.asarray(buf), geo=geo, num_blocks=nb, bits_per_sample=bps,
            ms=(nch == 2), num_samples=ns, engine="scan",
        )
    )

    hdr_w, data_w = payload_to_words_split(payload, geo, nb)
    lanes = np.asarray(
        _device_pipeline_words(
            jnp.asarray(hdr_w), jnp.asarray(data_w), geo=geo,
            num_blocks=nb, bits_per_sample=bps, ms=(nch == 2),
            engine="fused_interpret",
        )
    )
    got = lanes.reshape(nch, -1)[:, :ns]
    np.testing.assert_array_equal(got, want)


def test_golden_fixture_fused_interpret(fixture_dir):
    """Golden .aad decodes bit-exactly through the kernel on CPU."""
    from aad_tpu.codec.decoder import Decoder
    from aad_tpu.constants import FILE_HEADER_SIZE
    from aad_tpu.format.header import decode_header
    from aad_tpu.format.wav import read_wav

    data = (fixture_dir / "sin300Hz_mono.aad").read_bytes()
    header = decode_header(data[:FILE_HEADER_SIZE])
    dec = Decoder.from_header(header, engine="fused_interpret")
    pcm = np.asarray(
        dec.decode_payload_ondevice(np.frombuffer(data, np.uint8)[FILE_HEADER_SIZE:])
    )
    g = read_wav(str(fixture_dir / "sin300Hz_mono_decoded.wav"))
    ref = np.asarray(g[1] if isinstance(g, tuple) else g) >> 16
    np.testing.assert_array_equal(pcm, ref)


def test_fused_decode_malformed_step_index_matches_scan():
    """Engines agree on wire step indices in (4080, 4095] — slot 256.

    A malformed block header can carry a 12-bit index above the encoder-
    reachable maximum (4080); its table slot is 256, one past the table,
    which the reference reads out of bounds (src/aad_tables.h:28 — its
    asserts are DEBUG-only). The framework defines the case instead: every
    parse point clamps the index to 4080 before any engine runs, so the
    kernel's table read stays inside the table and adversarial streams
    cannot diverge engines.
    """
    fused, scan = _both_engines(*_lane_inputs(24, 70, 4, 4081, 4096), 4)
    np.testing.assert_array_equal(fused, scan)


@pytest.mark.parametrize("bps", [2, 4])
def test_fused_table_read_every_slot(bps):
    """The kernel reads the step-size table right at all 256 slots.

    Lane s starts at step index 16 * s (slot s) with zero predictor state
    and a first code of magnitude 1, so its first decoded sample is
    clip16(table[s] * 3 >> (bps - 1)); the whole output must also equal
    the scan engine's.
    """
    from aad_tpu.tables import STEPSIZE_TABLE

    L, T = 256, 16
    codes = RNG.integers(0, 2**bps, (L, T), dtype=np.uint8)
    codes[:, 0] = 1
    si = np.minimum(np.arange(L, dtype=np.int32) * 16, 4080)
    zeros = jnp.zeros((L, 4), jnp.int32)
    fused, scan = _both_engines(
        jnp.asarray(codes), jnp.asarray(si), zeros, zeros, bps
    )
    want = np.clip(
        (STEPSIZE_TABLE.astype(np.int64) * 3) >> (bps - 1), -32768, 32767
    )
    np.testing.assert_array_equal(fused[:, 4], want)
    np.testing.assert_array_equal(fused, scan)


def test_fused_interpret_refuses_gpu_and_fused_refuses_cpu(monkeypatch):
    """The kernel never falls back: compiled needs a GPU, interpreted
    refuses one."""
    import jax

    from aad_tpu.ops import pallas_decode

    with pytest.raises(ValueError, match="needs a GPU"):
        pallas_decode.check_platform(interpret=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(ValueError, match="interpret mode"):
        pallas_decode.check_platform(interpret=True)
    pallas_decode.check_platform(interpret=False)
