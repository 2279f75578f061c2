"""Engine choice: (platform, API, engine argument) -> engine, in one place.

ops.decode.resolve_engine is the only code that maps an engine argument to
an engine. Each public API passes its direction and its policy for the
native host engine; this table pins the result on both platforms,
including the refusals. The platform and the native library's
availability are patched, so the GPU rows run on the CPU.
"""

import jax
import numpy as np
import pytest

from aad_tpu import native
from aad_tpu.ops.decode import resolve_engine

# API -> (direction, native policy) as each API calls resolve_engine.
APIS = {
    "Decoder": ("decode", "never"),
    "decode_blocks_sharded": ("decode", "never"),
    "decode_batch": ("decode", "off_gpu"),
    "decode": ("decode", "always"),
    "StreamingDecoder": ("decode", "always"),
    "Encoder": ("encode", "never"),
    "encode_batch": ("encode", "off_gpu"),
    "encode(parallel_blocks=True)": ("encode", "off_gpu"),
    "encode": ("encode", "always"),
    "StreamingEncoder": ("encode", "always"),
}

R = ValueError  # refused
TABLE = [
    # platform, API, engine argument, native available, expected
    ("gpu", "Decoder", "auto", True, "fused"),
    ("gpu", "Decoder", "fused", True, "fused"),
    ("gpu", "Decoder", "scan", True, "scan"),
    ("gpu", "Decoder", "fused_interpret", True, R),
    ("gpu", "Decoder", "native", True, R),
    ("gpu", "decode_blocks_sharded", "auto", True, "fused"),
    ("gpu", "decode_batch", "auto", True, "fused"),
    ("gpu", "decode_batch", "native", True, "native"),
    ("gpu", "decode", "auto", True, "native"),
    ("gpu", "decode", "auto", False, "fused"),
    ("gpu", "StreamingDecoder", "auto", True, "native"),
    ("gpu", "Encoder", "auto", True, "scan"),
    ("gpu", "Encoder", "fused", True, R),
    ("gpu", "encode_batch", "auto", True, "scan"),
    ("gpu", "encode(parallel_blocks=True)", "auto", True, "scan"),
    ("gpu", "encode", "auto", True, "native"),
    ("gpu", "StreamingEncoder", "scan", True, "scan"),
    ("cpu", "Decoder", "auto", True, "scan"),
    ("cpu", "Decoder", "fused", True, R),
    ("cpu", "Decoder", "fused_interpret", True, "fused_interpret"),
    ("cpu", "decode_blocks_sharded", "auto", True, "scan"),
    ("cpu", "decode_batch", "auto", True, "native"),
    ("cpu", "decode_batch", "auto", False, "scan"),
    ("cpu", "decode", "auto", True, "native"),
    ("cpu", "decode", "scan", True, "scan"),
    ("cpu", "Encoder", "auto", True, "scan"),
    ("cpu", "encode_batch", "auto", True, "native"),
    ("cpu", "encode(parallel_blocks=True)", "auto", True, "native"),
    ("cpu", "encode(parallel_blocks=True)", "auto", False, "scan"),
    ("cpu", "encode", "auto", True, "native"),
    ("cpu", "encode", "fused_interpret", True, R),
    ("cpu", "StreamingEncoder", "auto", False, "scan"),
    ("cpu", "Decoder", "pallas", True, R),
    ("gpu", "Decoder", "pallas", True, R),
    ("gpu", "Encoder", "pallas", True, R),
    ("cpu", "encode", "pallas", True, R),
    ("cpu", "decode", "bogus", True, R),
]


@pytest.mark.parametrize("platform,api,engine,have_native,expected", TABLE)
def test_engine_table(monkeypatch, platform, api, engine, have_native, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setattr(native, "available", lambda: have_native)
    direction, policy = APIS[api]
    if expected is R:
        with pytest.raises(ValueError):
            resolve_engine(engine, direction=direction, native=policy)
    else:
        assert resolve_engine(
            engine, direction=direction, native=policy
        ) == expected


def test_explicit_native_unavailable_raises(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native codec unavailable"):
        resolve_engine("native", native="always")


def test_public_apis_refuse_removed_and_wrong_platform_engines():
    """The public entry points route through the table: "pallas" is gone
    everywhere, and the compiled kernel is refused on the CPU."""
    from aad_tpu import Decoder, decode_batch, encode, encode_batch
    from aad_tpu.codec.encoder import EncodeConfig
    from aad_tpu.format.header import HeaderInfo

    cfg = EncodeConfig(num_channels=1, sampling_rate=8000)
    pcm = np.zeros((1, 64), np.int32)
    header = HeaderInfo(
        num_channels=1, num_samples=64, sampling_rate=8000,
        bits_per_sample=4, block_size=cfg.geometry().block_size,
        num_samples_per_block=cfg.geometry().num_samples_per_block,
        ch_process_method=0,
    )
    for call in (
        lambda: encode(pcm, cfg, engine="pallas"),
        lambda: encode_batch([pcm], cfg, engine="pallas"),
        lambda: decode_batch([b""], engine="pallas"),
        lambda: Decoder.from_header(header, engine="pallas"),
        lambda: Decoder.from_header(header, engine="fused"),
    ):
        with pytest.raises(ValueError):
            call()
