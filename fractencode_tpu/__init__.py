"""fractencode_tpu — a fractal image codec framework in JAX.

JAX/XLA/Pallas implementation of Partitioned Iterated Function System
(PIFS) fractal image compression with the capabilities of the reference C++
implementation (sebsgit/fractencode), re-designed for accelerators: the
all-pairs range/domain search is batched matrix algebra (a Pallas kernel on
NVIDIA GPUs), the decoder is an on-device fixed-point loop, and multi-device
scaling uses ``jax.sharding`` meshes instead of thread pools.
"""
from .params import EncoderConfig, DecoderConfig, REFERENCE_COMPAT
from .encode import (EncodeResult, encode_plane, encode_batch,
                     encode_batch_stacked)
from .decode import decode_plane, decode_batch_stacked

__version__ = "0.1.0"

__all__ = [
    "EncoderConfig",
    "DecoderConfig",
    "REFERENCE_COMPAT",
    "EncodeResult",
    "encode_plane",
    "encode_batch",
    "encode_batch_stacked",
    "decode_plane",
    "decode_batch_stacked",
    "__version__",
]
