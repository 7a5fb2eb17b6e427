"""PyTorch workloads of the port: the Llama-family decoder and LM trainer
with their flash-attention kernels (forward and backward), and AlexNet
training with its max-pool and fused conv+pool kernels.  Module names
mirror the JAX package's ``workloads/``; the kernel functions live in ``workloads.flash_attention``,
``workloads.pool`` and ``workloads.convpool`` (not re-exported here, so
those names stay the modules)."""

from . import llama
from .alexnet import (
    AlexNet,
    create_train_state,
    loss_fn,
    space_to_depth,
    synthetic_batch,
    train_step,
)
from .inference import (
    DecodeTransformerLM,
    decode_throughput,
    greedy_generate,
    make_decoder,
    sample_generate,
)
from .transformer import (
    TransformerLM,
    lm_loss,
    lm_train_step,
    synthetic_lm_batch,
)
