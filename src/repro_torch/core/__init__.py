"""FTTQ statistics and QAT quantizer, the ternary wire tensor, codecs, the
fused encode and the T-FedAvg protocol pieces (port of ``repro.core``)."""

from repro_torch.core.compression import (
    Codec,
    CodecSpec,
    CompressionSpec,
    DowncastTensor,
    TopKTensor,
    available_codecs,
    compress_pytree,
    decompress_pytree,
    get_codec,
    register_codec,
    wire_nbytes,
)

__all__ = [
    "Codec", "CodecSpec", "CompressionSpec", "DowncastTensor", "TopKTensor",
    "available_codecs", "compress_pytree", "decompress_pytree", "get_codec",
    "register_codec", "wire_nbytes",
]
