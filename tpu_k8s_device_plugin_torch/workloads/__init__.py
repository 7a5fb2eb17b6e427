"""PyTorch workloads of the port: the Llama-family decoder, its
continuous-batching serving engine and iteration scheduler, and its
LM trainer, with their flash-attention kernels (forward and backward), and AlexNet training
with its max-pool and fused conv+pool kernels.  Module names
mirror the JAX package's ``workloads/``; the kernel functions live in ``workloads.flash_attention``,
``workloads.pool`` and ``workloads.convpool`` (not re-exported here, so
those names stay the modules).

The serving tier's modules (``server``, and the fleet tier above it:
``trafficgen``, ``router``, ``replay``, ``fleet``) are imported by name,
as the JAX package's are: it exports none of their names here.

The names below load their module at first use, so importing one
workload (``workloads.alexnet``) does not import the others."""

import importlib

_EXPORTS = {
    "llama": None,
    "scheduler": None,
    "AlexNet": "alexnet",
    "create_train_state": "alexnet",
    "loss_fn": "alexnet",
    "space_to_depth": "alexnet",
    "synthetic_batch": "alexnet",
    "train_step": "alexnet",
    "DecodeTransformerLM": "inference",
    "decode_throughput": "inference",
    "greedy_generate": "inference",
    "make_decoder": "inference",
    "sample_generate": "inference",
    "AdmitState": "serving",
    "IterationScheduler": "scheduler",
    "ServingEngine": "serving",
    "TransformerLM": "transformer",
    "lm_loss": "transformer",
    "lm_train_step": "transformer",
    "synthetic_lm_batch": "transformer",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = _EXPORTS[name]
    if module is None:
        return importlib.import_module(f"{__name__}.{name}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
