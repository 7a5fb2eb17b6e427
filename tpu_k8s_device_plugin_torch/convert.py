"""Parameters of the JAX package's models into the port's modules.

The JAX package's LM parameter tree (``TransformerLM.init`` or
``llama.train_model(cfg).init``, the same tree its decoder serves) is
nested dicts of arrays.  :func:`params_from_jax` turns it into a
``state_dict`` for ``DecodeTransformerLM``: the names carry over with
``.`` for ``/``, a Dense ``kernel [in, out]`` becomes ``weight
[out, in]``, and ``embed.embedding`` becomes ``embed.weight``; the
quantized, expert and adapter leaves keep their layout (the function's
docstring lists each).  Float leaves stay f32; ``load_state_dict``
casts each to its parameter's dtype once, which gives the operand
values that flax's cast at every use gives (RMSNorm scales stay f32, as
flax uses them).

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


# leaves that keep the JAX package's layout and dtype as they are (see
# params_from_jax)
_AS_IS = ("kernel_int8", "kernel_int4", "scale", "router", "experts_up",
          "experts_down", "experts_up_int8", "experts_down_int8",
          "experts_up_scale", "experts_down_scale")


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for the port's decoder or training model from the JAX
    parameter tree (leaves anything ``np.asarray`` takes).  The port's
    layout of each leaf:

    * a full-precision Dense ``kernel [in, out]`` becomes ``weight
      [out, in]`` (the one transpose; only a 2-D ``kernel`` takes it);
    * ``embed.embedding`` becomes ``embed.weight``;
    * the quantized projections keep the JAX layout and dtype:
      ``kernel_int8 [in, out]`` int8 with ``scale [out]`` f32, and
      ``kernel_int4 [in, out // 2]`` int8 (two values a byte, never
      transposed: a transpose would pair the wrong nibbles) with group
      scales ``scale [in // g, out]``; a norm's ``scale`` is as it is;
    * the MoE ``router [D, E]``, ``experts_up [E, D, F]``,
      ``experts_down [E, F, D]`` and their ``_int8`` / ``_scale`` forms
      keep the JAX layout (the port's ``MoEFFN`` contracts them as the
      JAX einsums do);
    * the LoRA stacks ``{name}_lora_A [n, in, r]`` and ``{name}_lora_B
      [n, r, out]`` are as they are, siblings of their projection in
      the block.

    Integer leaves stay int8; every other leaf becomes f32, and
    ``load_state_dict`` casts it to its parameter's dtype once."""
    out = {}
    for path, leaf in _flatten(tree):
        scope, _, leaf_name = path.rpartition(".")
        np_leaf = np.asarray(leaf)
        if np_leaf.dtype == np.int8:
            arr = torch.from_numpy(np.array(np_leaf))
        else:
            arr = torch.from_numpy(np.array(np_leaf, dtype=np.float32))
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
        elif leaf_name in _AS_IS or leaf_name.endswith(("_lora_A",
                                                        "_lora_B")):
            out[path] = arr
        else:
            raise ValueError(f"{path}: not an LM parameter")
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
