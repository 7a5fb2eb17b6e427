"""Parameters of the JAX package's models into the port's modules.

The JAX package's LM parameter tree (``TransformerLM.init`` or
``llama.train_model(cfg).init``, the same tree its decoder serves) is
nested dicts of arrays.  :func:`params_from_jax` turns it into a
``state_dict`` for ``DecodeTransformerLM``: the names carry over with
``.`` for ``/``, a Dense ``kernel [in, out]`` becomes ``weight
[out, in]``, and ``embed.embedding`` becomes ``embed.weight``.  Leaves
stay f32; ``load_state_dict`` casts each to its parameter's dtype once,
which gives the operand values that flax's cast at every use gives
(RMSNorm scales stay f32, as flax uses them).

:func:`alexnet_params_from_jax` does the same for the JAX ``AlexNet``
tree: conv kernels HWIO become OIHW weights, Dense kernels ``[in, out]``
become ``[out, in]``, and the ``pool="fused"`` tree's renamed stages map
back to ``Conv_0..Conv_4``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = ""):
    for name, sub in tree.items():
        path = f"{prefix}{name}"
        if isinstance(sub, Mapping):
            yield from _flatten(sub, path + ".")
        else:
            yield path, sub


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for the port's decoder from the JAX parameter tree
    (leaves anything ``np.asarray`` takes)."""
    out = {}
    for path, leaf in _flatten(tree):
        scope, _, leaf_name = path.rpartition(".")
        arr = torch.from_numpy(np.array(leaf, dtype=np.float32))
        if leaf_name == "kernel":
            if arr.dim() != 2:
                # .T of a 4-D conv kernel would swap H and W silently
                raise ValueError(
                    f"{path}: a Dense kernel is 2-D, got shape "
                    f"{tuple(arr.shape)}; conv trees go through "
                    "alexnet_params_from_jax")
            out[f"{scope}.weight"] = arr.T.contiguous()
        elif leaf_name == "embedding":
            out[f"{scope}.weight"] = arr
        elif leaf_name == "scale" and scope.endswith("_norm"):
            out[path] = arr
        else:
            raise NotImplementedError(
                f"{path}: not a dense full-precision LM parameter; "
                "quantized, MoE and LoRA trees are not yet ported")
    return out


# the JAX pool="fused" AlexNet names its three conv+pool stages
# FusedConvPool_i and numbers the plain convs between them from 0
_FUSED_NAMES = {
    "FusedConvPool_0": "Conv_0",
    "FusedConvPool_1": "Conv_1",
    "Conv_0": "Conv_2",
    "Conv_1": "Conv_3",
    "FusedConvPool_2": "Conv_4",
}


def alexnet_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``AlexNet`` (any ``pool``) from the JAX
    ``AlexNet`` parameter tree, the ``xla``/``pallas`` tree or the
    ``fused`` one."""
    fused = "FusedConvPool_0" in tree
    out = {}
    for path, leaf in _flatten(tree):
        scope, _, leaf_name = path.rpartition(".")
        if fused:
            scope = _FUSED_NAMES.get(scope, scope)
        arr = torch.from_numpy(np.array(leaf, dtype=np.float32))
        if leaf_name == "bias":
            out[f"{scope}.bias"] = arr
        elif leaf_name == "kernel" and arr.dim() == 4:  # HWIO -> OIHW
            out[f"{scope}.weight"] = arr.permute(3, 2, 0, 1).contiguous()
        elif leaf_name == "kernel" and arr.dim() == 2:  # [in, out]
            out[f"{scope}.weight"] = arr.T.contiguous()
        else:
            raise ValueError(f"{path}: not an AlexNet parameter")
    return out
