"""PyTorch workloads of the port: the Llama-family decoder and its
flash-attention kernel.  Module names mirror the JAX package's
``workloads/``; the flash functions live in ``workloads.flash_attention``
(not re-exported here, so that name stays the module)."""

from . import llama
from .inference import (
    DecodeTransformerLM,
    decode_throughput,
    greedy_generate,
    make_decoder,
    sample_generate,
)
