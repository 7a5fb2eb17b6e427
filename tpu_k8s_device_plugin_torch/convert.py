"""Parameters of the JAX decoder into the port's modules.

The JAX package's LM parameter tree (``TransformerLM.init`` or
``llama.train_model(cfg).init``, the same tree its decoder serves) is
nested dicts of arrays.  :func:`params_from_jax` turns it into a
``state_dict`` for ``DecodeTransformerLM``: the names carry over with
``.`` for ``/``, a Dense ``kernel [in, out]`` becomes ``weight
[out, in]``, and ``embed.embedding`` becomes ``embed.weight``.  Leaves
stay f32; ``load_state_dict`` casts each to its parameter's dtype once,
which gives the operand values that flax's cast at every use gives
(RMSNorm scales stay f32, as flax uses them).
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
