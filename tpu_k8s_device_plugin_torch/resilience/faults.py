"""Deterministic, seeded fault injection.

The port's own copy of the JAX package's ``resilience/faults.py`` (the
port imports nothing of that package): every recovery path can be
provoked on demand, repeatably, with a one-line spec — no kernel
modules, no tc/netem, no flaky sleeps.  *recorder* is any object with
``record(name, **fields)``.

Spec grammar (``--fault-spec`` / ``TPU_DP_FAULTS``)::

    spec  := rule (';' rule)*
    rule  := op ':' kind ':' arg [':' prob]
    op    := dotted operation name (kubelet.register, slice.join,
             slice.heartbeat, health.list, probe, serve.step,
             serve.schedule, ...)
    kind  := 'error' | 'drop' | 'hang'
    arg   := error/drop: probability in [0,1]
             hang: seconds to stall (optional prob as 4th field)

Examples::

    slice.join:error:0.3            # 30% of joins fail fast
    probe:hang:5                    # every probe stalls 5s
    kubelet.register:drop:0.5       # half the Registers are lost
    serve.step:error:0.02           # 2% of scheduler steps crash
    serve.schedule:hang:5           # every scheduler iteration wedges
                                    # 5s (trips the schedule watchdog)

Determinism: the injector owns one ``random.Random(seed)``; the same
seed and call sequence produce the same injections, so a chaos failure
reproduces with ``--seed N`` exactly like an engine fuzz failure
reproduces with ``ENGINE_FUZZ_SEED``.

Zero overhead when unset: injection is armed by assigning the module
global ``ACTIVE``.  Hot-path call sites are written as::

    if faults.ACTIVE is not None:
        faults.ACTIVE.fire("serve.step")

so the disabled cost is one module-attribute load and an ``is None``
test — no function call, no dict lookup (a test asserts this shape).
``error`` and ``drop`` raise :class:`InjectedFault`; boundaries that
retry on transport errors list it in their retry/except tuples, which
keeps the injection visible to exactly the recovery machinery under
test and invisible to everything else.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional

log = logging.getLogger(__name__)

ENV_FAULTS = "TPU_DP_FAULTS"
ENV_FAULT_SEED = "TPU_DP_FAULT_SEED"

_KINDS = ("error", "drop", "hang")


class InjectedFault(Exception):
    """A fault fired by the injector (never raised in production
    configs: constructing one requires an installed spec)."""

    def __init__(self, op: str, kind: str) -> None:
        super().__init__(f"injected {kind} at {op}")
        self.op = op
        self.kind = kind


class FaultRule:
    """One parsed spec rule."""

    __slots__ = ("op", "kind", "arg", "prob")

    def __init__(self, op: str, kind: str, arg: float,
                 prob: float) -> None:
        self.op = op
        self.kind = kind
        self.arg = arg
        self.prob = prob

    def __repr__(self) -> str:
        return (f"FaultRule({self.op}:{self.kind}:{self.arg:g}"
                f":{self.prob:g})")


class FaultSpec:
    """A parsed ``--fault-spec`` string (rules in declaration order)."""

    def __init__(self, rules: List[FaultRule], text: str = "") -> None:
        self.rules = rules
        self.text = text

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        rules: List[FaultRule] = []
        for part in text.split(";"):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if len(fields) not in (3, 4):
                raise ValueError(
                    f"bad fault rule {part!r}: want op:kind:arg[:prob]")
            op, kind = fields[0].strip(), fields[1].strip()
            if not op:
                raise ValueError(f"bad fault rule {part!r}: empty op")
            if kind not in _KINDS:
                raise ValueError(
                    f"bad fault rule {part!r}: kind must be one of "
                    f"{', '.join(_KINDS)}")
            try:
                arg = float(fields[2])
            except ValueError:
                raise ValueError(
                    f"bad fault rule {part!r}: arg must be a number")
            if kind == "hang":
                if arg < 0:
                    raise ValueError(
                        f"bad fault rule {part!r}: hang seconds < 0")
                prob = float(fields[3]) if len(fields) == 4 else 1.0
            else:
                if len(fields) == 4:
                    raise ValueError(
                        f"bad fault rule {part!r}: {kind} takes "
                        "probability as its arg, no 4th field")
                prob = arg
            if not 0.0 <= prob <= 1.0:
                raise ValueError(
                    f"bad fault rule {part!r}: probability {prob} "
                    "outside [0, 1]")
            rules.append(FaultRule(op, kind, arg, prob))
        return cls(rules, text)


class FaultInjector:
    """Seeded rule evaluator with per-op fire accounting.

    ``fire(op)`` walks the rules for *op* in declaration order: a
    ``hang`` rule that fires sleeps; an ``error``/``drop`` rule that
    fires raises :class:`InjectedFault` (ending the walk).  Fired
    injections are counted in ``fired`` and journaled to *recorder*
    so a chaos soak can assert exactly which faults landed.
    """

    def __init__(self, spec: FaultSpec, seed: int = 0,
                 recorder: Optional[Any] = None) -> None:
        self.spec = spec
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.recorder = recorder
        self.fired: Dict[str, int] = {}
        self.checked: Dict[str, int] = {}
        self._by_op: Dict[str, List[FaultRule]] = {}
        for r in spec.rules:
            self._by_op.setdefault(r.op, []).append(r)

    def _roll(self) -> float:
        with self._lock:  # one RNG stream, callers on many threads
            return self._rng.random()

    def _mark(self, d: Dict[str, int], key: str) -> None:
        with self._lock:
            d[key] = d.get(key, 0) + 1

    def fire(self, op: str) -> None:
        """Evaluate the rules for *op* (see class docstring)."""
        rules = self._by_op.get(op)
        self._mark(self.checked, op)
        if not rules:
            return
        for r in rules:
            if r.prob < 1.0 and self._roll() >= r.prob:
                continue
            self._mark(self.fired, f"{op}:{r.kind}")
            if self.recorder is not None:
                self.recorder.record("tpu_fault_injected", op=op,
                                     kind=r.kind, arg=r.arg)
            log.warning("fault injected: %s %s (arg=%g)",
                        op, r.kind, r.arg)
            if r.kind == "hang":
                time.sleep(r.arg)
            else:
                raise InjectedFault(op, r.kind)

    def fired_count(self, prefix: str = "") -> int:
        with self._lock:
            return sum(n for k, n in self.fired.items()
                       if k.startswith(prefix))


# The module-global arming switch.  None (the default, production
# state) makes every hook site a bare attribute check; tests and the
# chaos harness install/uninstall around each episode.
ACTIVE: Optional[FaultInjector] = None


def active() -> Optional[FaultInjector]:
    return ACTIVE


def install(spec_text: str, seed: int = 0,
            recorder: Optional[Any] = None
            ) -> Optional[FaultInjector]:
    """Parse and arm *spec_text*; empty/blank disarms.  Returns the
    installed injector (None when disarmed)."""
    global ACTIVE
    if not spec_text or not spec_text.strip():
        ACTIVE = None
        return None
    inj = FaultInjector(FaultSpec.parse(spec_text), seed=seed,
                        recorder=recorder)
    ACTIVE = inj
    log.warning("FAULT INJECTION ARMED (seed=%d): %s", seed,
                inj.spec.text)
    return inj


def uninstall() -> None:
    global ACTIVE
    ACTIVE = None


def install_from_env(recorder: Optional[Any] = None
                     ) -> Optional[FaultInjector]:
    """Arm from ``TPU_DP_FAULTS`` / ``TPU_DP_FAULT_SEED`` when set —
    the env path the DaemonSet and chaos subprocesses use."""
    spec = os.environ.get(ENV_FAULTS, "")
    if not spec:
        return None
    try:
        seed = int(os.environ.get(ENV_FAULT_SEED, "0"))
    except ValueError:
        log.error("bad %s; defaulting fault seed to 0", ENV_FAULT_SEED)
        seed = 0
    return install(spec, seed=seed, recorder=recorder)
