"""Rank 0 decides, every rank runs: the engine calls of a tensor-parallel
server.

A ``ServingEngine`` split over a mesh's ``model`` axis runs one process
a rank, and every rank must make the same engine calls in the same
order: each call runs collectives over the axis.  The engine itself is
deterministic (the logits are gathered, so every rank picks the same
tokens), but what a scheduler or an HTTP server decides depends on the
host: arrivals, windows, budgets, preemptions.  So rank 0 alone decides
them, and the other ranks replay its calls.

:class:`EngineLeader` wraps rank 0's engine.  Before it runs a call that
changes the engine (:data:`REPLAYED`), it sends the call's record (the
method's name and its host arguments, pickled) to the other ranks over a
gloo control group; after the call it sends the outcome.  Engine-made
objects that come back and go in again (an ``AdmitState``, a window's
handle) travel as numbers given in the order both sides make them.
A preemption callback that the engine calls inside a call is rank 0's;
the other ranks run the engine calls it makes as rank 0 sends them, and
return the value it returned.  Calls that only read the engine run on
rank 0 alone; a method in neither set raises, so a new engine method is
never run on one rank by mistake.

:func:`follow` is the other ranks' loop: it receives each record, makes
the same call on its engine, and checks that its outcome matches rank
0's.  A mismatch raises, and a lost rank fails the control group's next
call; a server then stops (``on_lost``), it never serves on one rank.
"""

from __future__ import annotations

import inspect
import threading
from typing import Any, Callable, Dict, Optional

import torch.distributed as dist

# the engine methods rank 0 sends to the other ranks before it runs them
REPLAYED = frozenset({
    "admit", "begin_admit", "admit_step", "admit_step_packed",
    "warm_packed", "abort_admit", "finish_admit", "_finish_admit_dispatch",
    "_finish_admit_resolve", "step", "run", "run_scan", "scan_dispatch",
    "scan_harvest", "scan_abandon", "jump_round", "spec_round", "run_spec",
    "release", "preempt", "resume", "park_session", "demote_session",
    "resume_session", "discard_session", "register_grammar",
    "register_prefix", "release_prefix", "set_preempt_cb",
})

# the methods that only read the engine's host state: rank 0 alone
READ_ONLY = frozenset({
    "output", "finished", "finish_reason", "stats", "free_slots",
    "token_logprobs", "prompt_logprobs", "forced_pending", "spec_ready",
    "jump_ready", "accept_rate", "grammar_rel", "grammar_abs",
    "session_slots",
})

# calls after which an engine-made object is no longer used
_LAST_USE = frozenset({"_finish_admit_resolve", "finish_admit",
                       "abort_admit", "scan_harvest", "scan_abandon"})


class _Handle:
    """An engine-made object in a record: its number on both sides."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n


class _Callback:
    """A callback argument in a record: the receiving side installs its
    replay of rank 0's callback."""


def _made_by_engine(obj) -> bool:
    from .serving import AdmitState, _ScanHandle

    return isinstance(obj, (AdmitState, _ScanHandle))


def _outcome(value) -> Any:
    """What both sides compare after a call: a plain value itself, a
    container's type and size, another object's type."""
    if isinstance(value, (bool, int, float, str, type(None))):
        return value
    if isinstance(value, (dict, list, tuple)):
        return type(value).__name__, len(value)
    return type(value).__name__


class _Channel:
    """Records from rank 0 of the control group to the others."""

    def __init__(self, group):
        self.group = group
        self.src = dist.get_global_rank(group, 0)

    def send(self, record) -> None:
        dist.broadcast_object_list([record], src=self.src, group=self.group)

    def recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]


class EngineLeader:
    """Rank 0's engine, replayed on the other ranks of *group* (a gloo
    group of every rank of the model axis, rank 0 first): attributes and
    :data:`READ_ONLY` methods are the engine's, :data:`REPLAYED` methods
    are sent before they run.  *on_lost* is called with the error when
    the control group fails (a rank died); the error is raised after
    it."""

    def __init__(self, engine, group,
                 on_lost: Optional[Callable[[BaseException], None]] = None):
        self.__dict__.update(
            _engine=engine, _chan=_Channel(group), _on_lost=on_lost,
            _lock=threading.RLock(), _numbers={}, _next=0)

    def __getattr__(self, name: str):
        attr = getattr(self._engine, name)
        if name in REPLAYED:
            return lambda *a, **kw: self._call(name, a, kw)
        if inspect.ismethod(attr) and name not in READ_ONLY:
            raise AttributeError(
                f"{name} is neither replayed on the other tensor-parallel "
                "ranks nor read-only")
        return attr

    def _send(self, record) -> None:
        try:
            self._chan.send(record)
        except Exception as e:
            if self._on_lost is not None:
                self._on_lost(e)
            raise

    def _encode(self, value):
        if _made_by_engine(value):
            return _Handle(self._numbers[id(value)][0])
        if callable(value):
            return _Callback()
        if isinstance(value, (list, tuple)):
            return type(value)(self._encode(v) for v in value)
        return value

    def _call(self, name: str, args: tuple, kwargs: dict):
        with self._lock:
            if name == "set_preempt_cb" and args and args[0] is not None:
                args = (self._replayed_cb(args[0]),) + args[1:]
            self._send(("call", name, self._encode(args),
                        {k: self._encode(v) for k, v in kwargs.items()}))
            try:
                out = getattr(self._engine, name)(*args, **kwargs)
            except BaseException as e:
                self._send(("done", ("raised", type(e).__name__)))
                raise
            if _made_by_engine(out):
                self._numbers[id(out)] = (self._next, out)
                self.__dict__["_next"] += 1
            if name in _LAST_USE:
                for a in args:
                    self._numbers.pop(id(a), None)
            self._send(("done", _outcome(out)))
            return out

    def _replayed_cb(self, cb):
        def wrapped(*args):
            value = cb(*args)
            self._send(("return", value))
            return value

        return wrapped

    def close(self) -> None:
        """End the other ranks' :func:`follow` loops."""
        with self._lock:
            self._send(("stop",))


class _Follower:
    def __init__(self, engine, group):
        self.engine, self.chan = engine, _Channel(group)
        self.objects: Dict[int, Any] = {}
        self.next = 0

    def _decode(self, value):
        if isinstance(value, _Handle):
            return self.objects[value.n]
        if isinstance(value, _Callback):
            return self._replay_cb
        if isinstance(value, (list, tuple)):
            return type(value)(self._decode(v) for v in value)
        return value

    def _replay_cb(self, *args):
        """Rank 0's callback, as it ran there: the engine calls it made,
        then the value it returned."""
        while True:
            record = self.chan.recv()
            if record[0] == "return":
                return record[1]
            self._run(record)

    def _run(self, record) -> None:
        if record[0] != "call":
            raise RuntimeError(f"tensor-parallel control record out of "
                               f"order: {record[0]!r}")
        _, name, args, kwargs = record
        args = self._decode(args)
        kwargs = {k: self._decode(v) for k, v in kwargs.items()}
        try:
            out = getattr(self.engine, name)(*args, **kwargs)
            mine = _outcome(out)
        except Exception as e:
            out, mine = None, ("raised", type(e).__name__)
        if _made_by_engine(out):
            self.objects[self.next] = out
            self.next += 1
        if name in _LAST_USE:
            for a, raw in zip(args, record[2]):
                if isinstance(raw, _Handle):
                    self.objects.pop(raw.n, None)
        tag, theirs = self.chan.recv()
        if tag != "done" or theirs != mine:
            raise RuntimeError(
                f"tensor-parallel ranks diverged at {name}: rank 0 gave "
                f"{theirs!r}, this rank {mine!r}")

    def loop(self) -> None:
        while True:
            record = self.chan.recv()
            if record[0] == "stop":
                return
            self._run(record)


def follow(engine, group) -> None:
    """Replay rank 0's engine calls on *engine* (this rank's) until rank 0
    closes its :class:`EngineLeader`.  Raises when this rank's outcome of
    a call differs from rank 0's, or when the control group fails."""
    _Follower(engine, group).loop()
