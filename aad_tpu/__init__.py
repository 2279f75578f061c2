"""aad_tpu — a GPU adaptive-differential (AAD) audio codec framework.

A ground-up JAX/XLA/Pallas re-design of the AAD codec (bitstream-compatible
with aikiriao/AAD): block-parallel decode, batched/sharded multi-stream
processing, a fused GPU decode kernel, and host-side WAV/CLI tooling.

Public surface:

    decode(data)                      -> (HeaderInfo, pcm[C, N] int32)
    encode(pcm, config)               -> bytes
    decode_header(data)               -> HeaderInfo
    calculate_block_size(...)         -> (block_size, samples_per_block)
    Decoder / Encoder                 -> reusable jitted pipelines
    EncodeConfig                      -> encoder parameter dataclass
    StreamingEncoder                  -> chunked encode with state carry
"""

from .codec.result import (
    AadError,
    ApiResult,
    InsufficientBufferError,
    InsufficientDataError,
    InvalidArgumentError,
    InvalidFormatError,
)
from .constants import (
    CH_PROCESS_MS,
    CH_PROCESS_NONE,
    CODEC_VERSION,
    FILE_HEADER_SIZE,
    FILTER_ORDER,
    FORMAT_VERSION,
    MAX_BITS_PER_SAMPLE,
    MAX_NUM_CHANNELS,
    MIN_BITS_PER_SAMPLE,
)
from .format.geometry import (
    BlockGeometry,
    calculate_block_size,
    compute_block_geometry,
    geometry_from_header,
)
from .format.header import HeaderInfo, decode_header, encode_header, validate_header
from .codec.decoder import Decoder, decode
from .codec.encoder import EncodeConfig, Encoder, encode
from .codec.streaming import StreamingDecoder, StreamingEncoder
from .codec.batch import decode_batch
from .codec.batch_encode import encode_batch
from .codec.transcode import transcode
from . import native
from .io import decode_file, encode_file
from .utils.quality import QualityStats, quality_stats, roundtrip_stats, self_check

__version__ = "0.1.0"

__all__ = [
    "AadError",
    "ApiResult",
    "BlockGeometry",
    "CH_PROCESS_MS",
    "CH_PROCESS_NONE",
    "CODEC_VERSION",
    "Decoder",
    "FILE_HEADER_SIZE",
    "FILTER_ORDER",
    "FORMAT_VERSION",
    "HeaderInfo",
    "InsufficientBufferError",
    "InsufficientDataError",
    "InvalidArgumentError",
    "InvalidFormatError",
    "MAX_BITS_PER_SAMPLE",
    "MAX_NUM_CHANNELS",
    "MIN_BITS_PER_SAMPLE",
    "EncodeConfig",
    "Encoder",
    "StreamingDecoder",
    "StreamingEncoder",
    "calculate_block_size",
    "compute_block_geometry",
    "decode",
    "decode_batch",
    "encode_batch",
    "transcode",
    "decode_file",
    "decode_header",
    "encode",
    "encode_file",
    "encode_header",
    "geometry_from_header",
    "native",
    "quality_stats",
    "roundtrip_stats",
    "self_check",
    "validate_header",
]
