"""Checkpoint / resume for the port's workloads, on torch state dicts.

The JAX package's ``workloads/checkpoint.py`` with its names and
semantics; the format is the port's own (orbax imports JAX).  The state
is what a training loop of the port holds, typically
``{"params": model.state_dict(), "opt_state": opt.state_dict()}``:
nested dicts, lists and tuples whose leaves are tensors or plain values.

* **One directory per step** under a base dir (the pod's volume):
  ``step_<n>/`` holds each process's payload ``state-<rank>.pt``
  (``torch.save`` of the whole tree, tensors copied to the host) and,
  written last, ``checkpoint.json``: the format version, the step, each
  leaf's key, shape and dtype, and every payload's byte size.  That file
  is the commit marker: a dir without it, with one that does not parse,
  or whose payloads are not the sizes it records, is torn and skipped.
* **Crash-safe saves**: every save writes into ``.step-tmp-<n>`` and
  commits with one ``os.replace``; a process killed mid-save leaves
  that orphan (swept by the next save), never a torn ``step_<n>``.
  Each payload and the marker are fsynced before the rename.  In a
  multi-process run (``torch.distributed`` initialized) every rank
  writes its payload into that one tmp dir, and rank 0 alone sweeps,
  writes the marker, commits and garbage-collects, between barriers.
* **Safe loading**: payloads load with ``torch.load(...,
  weights_only=True)``, so a checkpoint cannot run code.  Restored onto
  a template, each tensor goes to the device of the template's tensor
  (the CPU for a template on the ``meta`` device); a restore whose keys,
  shapes or dtypes differ from the template's raises, so a restore of
  the newest step falls back to the next older whole one.  Without a
  template the tree restores onto the CPU.
* **Elastic-slice restarts**: :class:`ReshapeSignal` watches the slice
  membership file the device plugin keeps; when the slice reshapes
  under a running job, the train loop checkpoints and exits with
  :data:`RESHAPE_EXIT_CODE` so the orchestrator restarts it under the
  new generation's identity.

Torch optimizers make their state at their first step, so a fresh
optimizer's ``state_dict`` has nothing to hold a checkpoint against:
:func:`optimizer_template` gives the state dict it will have, on the
``meta`` device.

* **Sharded state** (``shardings``: a tree of
  :class:`.parallel.Sharding` beside the state).  Torch tensors do not
  carry their placement as JAX arrays do, so a sharded save names it:
  each rank writes its own pieces, and the marker records the mesh's
  axis sizes and each split leaf's spec.  A restore with ``shardings``
  puts each leaf together from the payloads that hold its pieces (or
  takes it whole from an unsharded save) and gives every rank its piece
  under the new placement, on a mesh of the same shape or another.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from ..slice.state import Membership, load_membership
from ..types import constants

log = logging.getLogger(__name__)

_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_PREFIX = ".step-tmp-"
_PAYLOAD_RE = re.compile(r"^state-(\d+)\.pt$")
# the commit marker, written last into the tmp dir
_METADATA = "checkpoint.json"
_FORMAT_VERSION = 1

# Exit code a reshape-interrupted workload leaves with after its final
# checkpoint: distinct from crash codes so supervisors/JobSets can tell
# "restart me under the new slice identity" from a real failure.
RESHAPE_EXIT_CODE = 77


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step}")


def _payload_name(rank: int) -> str:
    return f"state-{rank}.pt"


def _leaves(tree: Any, path: Tuple = ()) -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` of every leaf of a tree of dicts, lists and
    tuples; the key joins the path with ``/``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield "/".join(str(p) for p in path), tree
        return
    for k, sub in items:
        yield from _leaves(sub, path + (k,))


def _map_leaves(tree: Any, fn, path: Tuple = ()) -> Any:
    """*tree* rebuilt with each leaf replaced by ``fn(key, leaf)``."""
    if isinstance(tree, dict):
        return type(tree)((k, _map_leaves(v, fn, path + (k,)))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn("/".join(str(p) for p in path), tree)


def _describe(tree: Any) -> Dict[str, Dict[str, Any]]:
    """Each leaf's record by key: a tensor's shape and dtype, another
    leaf's type name."""
    out = {}
    for key, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            out[key] = {"shape": list(leaf.shape),
                        "dtype": str(leaf.dtype).replace("torch.", "")}
        else:
            out[key] = {"type": type(leaf).__name__}
    return out


def _read_metadata(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(path, _METADATA), "r",
                  encoding="utf-8") as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(meta, dict) or meta.get("format") != _FORMAT_VERSION \
            or not isinstance(meta.get("payloads"), dict) \
            or not isinstance(meta.get("leaves"), list):
        return None
    return meta


def _whole_metadata(path: str) -> Optional[Dict[str, Any]]:
    """The commit marker of a whole step dir, else None: the dir must
    hold a parseable marker, and every payload it names at the size it
    records."""
    meta = _read_metadata(path)
    if meta is None:
        return None
    for name, size in meta["payloads"].items():
        try:
            if os.path.getsize(os.path.join(path, name)) != size:
                return None
        except OSError:
            return None
    return meta


def _step_complete(path: str) -> bool:
    """Structural torn-dir check.  Our own saves commit atomically (tmp
    + rename), so this guards against external copies interrupted
    mid-transfer and truncated files."""
    return _whole_metadata(path) is not None


def _sweep_orphans(base: str, keep: Optional[str] = None) -> None:
    """Remove temp dirs a crashed save left behind (best-effort).
    *keep* names the in-flight tmp dir of the CURRENT save, which must
    survive the sweep (another process may already be writing into it —
    multi-process saves share one deterministic tmp name)."""
    try:
        names = os.listdir(base)
    except OSError:
        return
    for name in names:
        if name.startswith(_TMP_PREFIX) and name != keep:
            shutil.rmtree(os.path.join(base, name), ignore_errors=True)


def _distributed() -> bool:
    return torch.distributed.is_available() \
        and torch.distributed.is_initialized()


def _process_index() -> int:
    """This process's rank; 0 when ``torch.distributed`` is not
    initialized (single-process runs)."""
    return torch.distributed.get_rank() if _distributed() else 0


def _process_count() -> int:
    return torch.distributed.get_world_size() if _distributed() else 1


def _barrier(name: str) -> None:
    """Cross-process sync point for multi-process saves (*name* says
    which, for logs); a no-op in a single process."""
    if _process_count() <= 1:
        return
    log.debug("checkpoint barrier %s", name)
    torch.distributed.barrier()


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _to_host(state: Any) -> Any:
    """*state* with every tensor detached and on the host, after the
    devices its tensors live on have finished their pending work (a
    step still in flight must not be serialized half done)."""
    for dev in {leaf.device for _, leaf in _leaves(state)
                if isinstance(leaf, torch.Tensor)
                and leaf.device.type == "cuda"}:
        torch.cuda.synchronize(dev)

    return _map_leaves(state, lambda _, leaf: leaf.detach().to("cpu")
                       if isinstance(leaf, torch.Tensor) else leaf)


def _write_payload(path: str, state: Any) -> None:
    with open(path, "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())


def _placement(shardings: Any) -> Optional[Dict[str, Any]]:
    """The marker's record of a sharded save: the mesh's axis sizes (in
    mesh order: a rank's payload is its row-major place on the mesh) and
    the spec of each split leaf."""
    if shardings is None:
        return None
    mesh, specs = None, {}
    for key, sh in _leaves(shardings):
        if sh is None:
            continue
        mesh = sh.mesh
        if any(axis is not None for axis in sh.spec):
            specs[key] = list(sh.spec)
    if mesh is None:
        return None
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "specs": specs}


def _write_metadata(tmp: str, step: int, state: Any,
                    placement: Optional[Dict[str, Any]] = None) -> None:
    payloads = {name: os.path.getsize(os.path.join(tmp, name))
                for name in sorted(os.listdir(tmp))
                if _PAYLOAD_RE.match(name)}
    meta = {
        "format": _FORMAT_VERSION,
        "step": step,
        "leaves": [{"key": k, **rec} for k, rec in _describe(state).items()],
        "payloads": payloads,
    }
    if placement is not None:
        meta["placement"] = placement
    with open(os.path.join(tmp, _METADATA), "w", encoding="utf-8") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(
    base_dir: str, step: int, state: Dict[str, Any],
    keep_last: Optional[int] = None, shardings: Any = None,
) -> str:
    """Atomically save *state* (typically ``{"params": ...,
    "opt_state": ...}``) under ``base_dir/step_<n>``.

    The tree is copied to the host (after its devices drain), written
    into a hidden temp dir in the same filesystem and committed with one
    ``os.replace`` — a crash at ANY point leaves either no ``step_<n>``
    or a whole one, never a torn directory.  With *keep_last*, older
    step dirs beyond the newest N are removed after a successful save
    (never before).

    Multi-process safe: under an initialized ``torch.distributed`` every
    process writes its payload into the SAME deterministic tmp dir
    (``.step-tmp-<step>``), and only process 0 sweeps orphans, writes
    the commit marker, renames the dir into place and garbage-collects
    old steps — each mutation fenced by a barrier so no rank returns
    before the step dir exists.  *shardings* (a tree of
    :class:`.parallel.Sharding` beside *state*) says how each rank's
    leaves are pieces of the whole ones; the marker records it."""
    if step < 0:
        raise ValueError(f"step must be >= 0, got {step}")
    if keep_last is not None and keep_last < 1:
        raise ValueError("keep_last must be >= 1 when set")
    base = os.path.abspath(base_dir)
    rank = _process_index()
    primary = rank == 0
    os.makedirs(base, exist_ok=True)
    final = _step_dir(base, step)
    tmp = os.path.join(base, f"{_TMP_PREFIX}{step}")
    if primary:
        _sweep_orphans(base, keep=os.path.basename(tmp))
        # stale tmp of a crashed save of this same step: clear it before
        # any peer starts writing into it
        shutil.rmtree(tmp, ignore_errors=True)
    _barrier(f"ckpt_save_pre_{step}")
    try:
        os.makedirs(tmp, exist_ok=True)
        host = _to_host(state)
        _write_payload(os.path.join(tmp, _payload_name(rank)), host)
        # every process's payload must be durable before the commit
        _barrier(f"ckpt_save_written_{step}")
        if primary:
            _write_metadata(tmp, step, host, _placement(shardings))
            _fsync_dir(tmp)
            if os.path.isdir(final):
                # overwrite: os.replace onto a non-empty dir raises
                shutil.rmtree(final)
            os.replace(tmp, final)
            _fsync_dir(base)
    except BaseException:
        if primary:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    # no process may observe (or GC around) a not-yet-committed step
    _barrier(f"ckpt_save_committed_{step}")
    if keep_last is not None and primary:
        for old in list_steps(base)[:-keep_last]:
            shutil.rmtree(_step_dir(base, old), ignore_errors=True)
    return final


def list_steps(base_dir: str) -> List[int]:
    """Completed checkpoint steps under *base_dir* (ascending).  Torn or
    partial step dirs are skipped, not raised on — a resume must come up
    from the newest WHOLE checkpoint."""
    if not os.path.isdir(base_dir):
        return []
    steps = []
    for name in os.listdir(base_dir):
        m = _STEP_RE.match(name)
        if not m:
            continue
        if not _step_complete(os.path.join(base_dir, name)):
            log.warning("skipping torn checkpoint dir %s",
                        os.path.join(base_dir, name))
            continue
        steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(base_dir: str) -> Optional[int]:
    steps = list_steps(base_dir)
    return steps[-1] if steps else None


def restore_checkpoint(
    base_dir: str,
    step: Optional[int] = None,
    template: Any = None,
    shardings: Any = None,
) -> Dict[str, Any]:
    """Restore the checkpoint at *step* (default: newest restorable).

    Without an explicit *step*, torn checkpoints are skipped: if the
    newest step dir fails to restore (a payload that does not load, or
    a tree that does not match *template*), the next older one is
    tried, so a damaged tail never strands a resumable job.  An explicit
    *step* restores exactly that one or raises.

    ``template`` is a tree like the saved one (``model.state_dict()``,
    :func:`optimizer_template`): the restored tree must have its keys,
    and each tensor its shape and dtype, and lands on its tensor's
    device.  With ``shardings`` (a tree of :class:`.parallel.Sharding`
    beside the template) each rank restores its piece of every leaf
    under that placement, whatever the mesh the checkpoint was saved
    from; the template then holds the pieces' shapes."""
    if step is not None:
        path = os.path.abspath(_step_dir(base_dir, step))
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint at {path!r}")
        return _restore_one(path, template, shardings)
    return restore_latest(base_dir, template, shardings)[1]


def restore_latest(base_dir: str, template: Any = None, shardings: Any = None
                   ) -> Tuple[int, Dict[str, Any]]:
    """``(step, state)`` of the newest restorable checkpoint, falling
    back over torn ones as :func:`restore_checkpoint` does: a resuming
    loop counts from the step it really got."""
    candidates = list_steps(base_dir)
    if not candidates:
        raise FileNotFoundError(f"no checkpoints under {base_dir!r}")
    last_err: Optional[BaseException] = None
    for cand in reversed(candidates):
        path = os.path.abspath(_step_dir(base_dir, cand))
        try:
            return cand, _restore_one(path, template, shardings)
        except Exception as e:
            # a structurally-complete dir that still fails to load is
            # torn below the marker (or not this template's tree): fall
            # back to the next older whole checkpoint
            log.warning("checkpoint %s unrestorable (%s); trying older",
                        path, e)
            last_err = e
    raise FileNotFoundError(
        f"no restorable checkpoint under {base_dir!r} "
        f"(last error: {last_err})")


def _check_tree(got: Dict[str, Dict], want: Dict[str, Dict],
                what: str) -> None:
    """*got* must have *want*'s keys, each tensor its shape and dtype;
    where *want* holds a plain value (an lr, a flag), *got* must hold
    one too, of any value."""
    if got.keys() != want.keys():
        missing = sorted(want.keys() - got.keys())[:5]
        extra = sorted(got.keys() - want.keys())[:5]
        raise ValueError(f"checkpoint tree differs from {what}: missing "
                         f"{missing}, unexpected {extra}")
    for key, rec in want.items():
        if ("shape" in rec or "shape" in got[key]) and got[key] != rec:
            raise ValueError(f"{key}: checkpoint holds {got[key]}, {what} "
                             f"wants {rec}")


def _load_payload(path: str, meta: Dict[str, Any], rank: int) -> Any:
    """The tree of *rank*'s payload (rank 0's where *rank* wrote none),
    checked against the marker."""
    name = _payload_name(rank)
    if name not in meta["payloads"]:
        name = _payload_name(0)
    tree = torch.load(os.path.join(path, name), map_location="cpu",
                      weights_only=True)
    _check_tree(_describe(tree), {rec["key"]: {k: v for k, v in rec.items()
                                               if k != "key"}
                                  for rec in meta["leaves"]},
                "its commit marker")
    return tree


def _reshard(path: str, meta: Dict[str, Any], shardings: Any) -> Any:
    """This rank's pieces under *shardings*: each leaf put together from
    the payloads holding its pieces (the marker's placement; an unsharded
    save's rank 0 holds it whole), then cut for this rank."""
    placement = meta.get("placement") or {"mesh": {}, "specs": {}}
    axes = list(placement["mesh"].items())
    first = _load_payload(path, meta, 0)
    loaded: Dict[int, Dict[str, Any]] = {0: dict(_leaves(first))}

    def piece(key: str, coord) -> torch.Tensor:
        rank = 0
        for c, (_, size) in zip(coord, axes):
            rank = rank * size + c
        if rank not in loaded:
            loaded[rank] = dict(_leaves(_load_payload(path, meta, rank)))
        return loaded[rank][key]

    def whole(key: str, spec, coord=()) -> torch.Tensor:
        if len(coord) == len(axes):
            return piece(key, coord)
        axis, size = axes[len(coord)]
        if axis not in spec:
            return whole(key, spec, coord + (0,))
        return torch.cat([whole(key, spec, coord + (c,))
                          for c in range(size)], dim=spec.index(axis))

    targets = dict(_leaves(shardings))

    def place(key, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        full = whole(key, placement["specs"].get(key, []))
        sh = targets.get(key)
        return full if sh is None else sh.local(full)

    return _map_leaves(first, place)


def _restore_one(path: str, template: Any,
                 shardings: Any = None) -> Dict[str, Any]:
    meta = _whole_metadata(path)
    if meta is None:
        raise FileNotFoundError(
            f"no whole checkpoint at {path!r}: {_METADATA} is missing or "
            "unreadable, or a payload is not the size it records")
    if shardings is None:
        tree = _load_payload(path, meta, _process_index())
    else:
        tree = _reshard(path, meta, shardings)
    got = _describe(tree)
    if template is None:
        return tree
    _check_tree(got, _describe(template), "the template")
    devices = {key: leaf.device for key, leaf in _leaves(template)
               if isinstance(leaf, torch.Tensor)}

    def place(key, leaf):
        dev = devices.get(key)
        if dev is None or dev.type in ("cpu", "meta"):
            return leaf
        return leaf.to(dev)

    return _map_leaves(tree, place)


@torch.no_grad()
def optimizer_template(opt: torch.optim.Optimizer) -> Dict[str, Any]:
    """The ``state_dict`` that *opt* has once it has stepped, on the
    ``meta`` device: torch optimizers make their state (momentum, Adam's
    moments and step) at their first step, so a fresh optimizer's state
    dict cannot serve as a restore template.  Built by one step of a
    twin optimizer (same class, same groups and options) over meta
    parameters with zero gradients; *opt* is not touched."""
    groups = []
    for group in opt.param_groups:
        metas = []
        for p in group["params"]:
            m = torch.empty_like(p, device="meta")
            m.grad = torch.zeros_like(m)
            metas.append(m)
        groups.append({**{k: v for k, v in group.items() if k != "params"},
                       "params": metas})
    twin = type(opt)(groups)
    twin.step()
    return twin.state_dict()


class ReshapeSignal:
    """Cooperative elastic-slice restart hook for train loops.

    The device plugin stamps every slice-coordinated container with
    ``TPU_SLICE_GENERATION`` (the membership generation its worker
    identity belongs to) and keeps the crash-safe membership file
    current as the slice reshapes.  A train loop polls :meth:`check`
    between steps; once the live generation moves past the baseline —
    survivors re-formed without a member, or an evicted member returned
    — the loop saves a final checkpoint and exits with
    :data:`RESHAPE_EXIT_CODE` so the orchestrator restarts it under the
    new generation's identity::

        signal = ReshapeSignal(state_path)
        for step in range(start, steps):
            loss = train_step(model, opt, ...)
            if signal.check() is not None:
                save_checkpoint(ckpt_dir, step + 1, state)
                raise SystemExit(RESHAPE_EXIT_CODE)

    In-process integrations (tests, single-binary harnesses) can skip
    the file watch and wire :meth:`fire` straight to the slice client's
    reshape callback.
    """

    def __init__(
        self,
        state_path: str = constants.SLICE_STATE_FILE,
        generation: Optional[int] = None,
    ) -> None:
        self._path = state_path
        self._lock = threading.Lock()
        self._fired: Optional[Membership] = None
        if generation is not None:
            self.baseline = generation
        else:
            env_gen = os.environ.get(constants.ENV_TPU_SLICE_GENERATION)
            if env_gen:
                # the generation Allocate stamped this container with: the
                # authoritative baseline even if the file already moved on
                self.baseline = int(env_gen)
            else:
                m = load_membership(state_path)
                self.baseline = m.generation if m is not None else 0

    def fire(self, old: Optional[Membership], new: Membership) -> None:
        """Direct wiring for the slice client's reshape callback."""
        with self._lock:
            self._fired = new

    def check(self) -> Optional[Membership]:
        """The new membership once the slice has reshaped past this
        job's baseline generation; None while the identity holds.  A
        dissolved slice (membership file gone) is NOT a reshape — the
        job keeps running on whatever devices it holds."""
        with self._lock:
            if self._fired is not None:
                return self._fired
        m = load_membership(self._path)
        if m is None or self.baseline <= 0:
            return None
        if m.generation != self.baseline:
            with self._lock:
                self._fired = m
            return m
        return None

    @property
    def triggered(self) -> bool:
        with self._lock:
            return self._fired is not None
