"""Exact wire codec for KV-checkpoint migration between replicas.

Disaggregated prefill/decode serving ships a finished prefill's engine
checkpoint (``ServingEngine.preempt``'s state dict: the raw paged KV
snapshot plus every host mirror — outputs, knobs, draw chains, grammar
state) from a prefill-class replica to a decode-class one over
``POST /migrate``.  The checkpoint round-trip must be EXACT — resume
on the far side has to be bit-identical to resume in-process, which is
what makes disagg output byte-identical to single-replica serving —
so this module is a tiny tagged binary format, not pickle (an internal
endpoint still should not execute attacker-supplied bytecode) and not
plain JSON (float round-trips and dtype fidelity are the whole point).

Layout::

    MAGIC | u64 header_len | header JSON (utf-8) | blob 0 | blob 1 ...

The header is a JSON tree in which every non-JSON value is a tagged
object: numpy arrays and torch tensors become ``{"__nd__": i,
"dtype", "shape"}`` referencing the i-th raw little-endian blob, tuples
/ frozensets / bytes / non-finite floats / non-string-keyed dicts get
their own tags.  Everything is deterministic, so a payload written by
the JAX package's codec and one written here for the same state are
the same bytes, and either side reads the other's.

bf16 arrays: numpy has no bfloat16 of its own, so a torch bf16 tensor
goes out under the dtype name ``"bfloat16"`` with its little-endian
bytes (what an ``ml_dtypes`` bf16 array writes), and a ``"bfloat16"``
blob comes back as a ``torch.bfloat16`` tensor on the CPU.  Every other
dtype comes back as a numpy array.
"""

from __future__ import annotations

import base64
import json
import math
import struct
from typing import Any, Dict, List

import numpy as np
import torch

__all__ = ["dump_payload", "load_payload", "MIGRATE_CONTENT_TYPE",
           "MigrateError"]

#: the internal replica-to-replica content type the router forwards
#: opaquely (a replica answering a prefill_only request with anything
#: else is a decline, handled by normal pass-through)
MIGRATE_CONTENT_TYPE = "application/x-tpu-kv-migrate"

_MAGIC = b"TPUMIG1\n"


class MigrateError(ValueError):
    """A payload that is not a well-formed migration container."""


def _enc(obj: Any, blobs: List[bytes]) -> Any:
    """Tree -> JSON-safe tree, appending array storage to *blobs*."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        if math.isfinite(obj):
            return obj
        return {"__f__": repr(obj)}          # inf/-inf/nan, exact
    if isinstance(obj, bytes):
        return {"__b__": base64.b64encode(obj).decode("ascii")}
    if isinstance(obj, torch.Tensor):
        t = obj.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            blobs.append(_le_bytes(t.view(torch.int16).numpy()))
            return {"__nd__": len(blobs) - 1, "dtype": "bfloat16",
                    "shape": list(t.shape)}
        obj = t.numpy()
    if isinstance(obj, np.generic):
        # numpy scalar: a 0-d array round-trips dtype AND value
        obj = np.asarray(obj)
    if isinstance(obj, np.ndarray) or hasattr(obj, "__array__"):
        # numpy array (or anything with __array__); raw
        # little-endian C-order bytes are the exactness guarantee.
        # Shape is taken BEFORE the contiguous copy — that call
        # promotes 0-d scalars to shape (1,).  dtype by NAME, not
        # .str: ml_dtypes extension types stringify as opaque void
        # ("<V2"), and builtin names ("float32", "int8") are
        # endian-free — the bytes are already little-endian
        arr = np.asarray(obj)
        shape = list(arr.shape)
        blobs.append(_le_bytes(arr))
        return {"__nd__": len(blobs) - 1,
                "dtype": arr.dtype.name,
                "shape": shape}
    if isinstance(obj, tuple):
        return {"__t__": [_enc(v, blobs) for v in obj]}
    if isinstance(obj, frozenset):
        # sort for determinism (members are token ids in practice)
        return {"__fs__": [_enc(v, blobs) for v in sorted(obj)]}
    if isinstance(obj, list):
        return [_enc(v, blobs) for v in obj]
    if isinstance(obj, dict):
        # tagged pair list: checkpoint dicts key on ints (layer
        # indices, copy indices) as well as strings, and JSON would
        # silently stringify them
        return {"__d__": [[_enc(k, blobs), _enc(v, blobs)]
                          for k, v in obj.items()]}
    raise MigrateError(
        f"migration payload cannot carry {type(obj).__name__}")


def _le_bytes(arr: np.ndarray) -> bytes:
    """C-order little-endian bytes of *arr*."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    return arr.tobytes()


def _dec(node: Any, blobs: List[memoryview]) -> Any:
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    if isinstance(node, list):
        return [_dec(v, blobs) for v in node]
    if not isinstance(node, dict):
        raise MigrateError(f"bad node {type(node).__name__}")
    if "__f__" in node:
        return float(node["__f__"])
    if "__b__" in node:
        return base64.b64decode(node["__b__"])
    if "__nd__" in node:
        i = int(node["__nd__"])
        if not 0 <= i < len(blobs):
            raise MigrateError(f"blob index {i} out of range")
        if node["dtype"] == "bfloat16":
            raw = np.frombuffer(blobs[i], dtype="<i2").reshape(
                node["shape"]).astype(np.int16)
            return torch.from_numpy(raw).view(torch.bfloat16)
        arr = np.frombuffer(
            blobs[i], dtype=np.dtype(node["dtype"])
        ).reshape(node["shape"]).copy()
        return arr
    if "__t__" in node:
        return tuple(_dec(v, blobs) for v in node["__t__"])
    if "__fs__" in node:
        return frozenset(_dec(v, blobs) for v in node["__fs__"])
    if "__d__" in node:
        return {_dec(k, blobs): _dec(v, blobs)
                for k, v in node["__d__"]}
    raise MigrateError(f"unknown tag in {sorted(node)[:3]}")


def dump_payload(obj: Dict[str, Any]) -> bytes:
    """Serialize one migration payload (the /migrate wire body)."""
    blobs: List[bytes] = []
    tree = _enc(obj, blobs)
    sizes = [len(b) for b in blobs]
    header = json.dumps({"tree": tree, "blobs": sizes},
                        separators=(",", ":")).encode()
    return b"".join([_MAGIC, struct.pack("<Q", len(header)), header]
                    + blobs)


def load_payload(data: bytes) -> Dict[str, Any]:
    """Inverse of :func:`dump_payload`; raises :class:`MigrateError`
    on anything malformed (the /migrate handler answers 400)."""
    if not data.startswith(_MAGIC):
        raise MigrateError("not a migration payload (bad magic)")
    off = len(_MAGIC)
    if len(data) < off + 8:
        raise MigrateError("truncated header length")
    (hlen,) = struct.unpack_from("<Q", data, off)
    off += 8
    if len(data) < off + hlen:
        raise MigrateError("truncated header")
    try:
        header = json.loads(data[off:off + hlen])
    except ValueError as e:
        raise MigrateError(f"bad header JSON: {e}") from e
    off += hlen
    if not isinstance(header, dict) or "tree" not in header:
        raise MigrateError("header missing 'tree'")
    blobs: List[memoryview] = []
    view = memoryview(data)
    for size in header.get("blobs", []):
        size = int(size)
        if len(data) < off + size:
            raise MigrateError("truncated blob section")
        blobs.append(view[off:off + size])
        off += size
    out = _dec(header["tree"], blobs)
    if not isinstance(out, dict):
        raise MigrateError("payload root must be a dict")
    return out
