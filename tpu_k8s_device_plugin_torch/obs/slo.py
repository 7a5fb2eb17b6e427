"""SLO policies + goodput accounting: the fleet's headline number.

ROADMAP item 5 replaces "tokens/sec" with **goodput** — requests/sec
meeting their class's SLO — because raw throughput hides exactly the
failure modes the QoS/preemption/router machinery exists for (a server
shedding every interactive request can still post a great tokens/sec).
This module is the accounting core both layers share:

- :class:`SLOPolicy` — one request class's objective: an interactive
  TTFT target (``ttft_ms``), a batch completion deadline
  (``deadline_ms``), or both, plus the error-budget objective the
  burn-rate gauge is computed against.
- :func:`parse_slo_specs` — the ``--slo CLASS=ttft_ms[:deadline_ms]``
  CLI grammar (repeatable).
- :class:`SLOAccountant` — wired into the serving request lifecycle:
  every terminal request increments
  ``tpu_slo_requests_total{class,tenant,met}`` and feeds a rolling
  window from which scrape-time gauges are refreshed —
  ``tpu_slo_goodput_ratio{class}`` (fraction meeting the SLO over the
  window), ``tpu_slo_goodput_requests_per_second{class}`` (met
  requests/sec over the window) and
  ``tpu_slo_error_budget_burn_rate{class}`` (observed miss rate over
  the budgeted miss rate; 1.0 = burning exactly the budget).

Label values are BOUNDED here, by construction: request-supplied class
names map to a declared policy or to ``other`` (never a free-form
label value), and tenant names map to the declared tenant set or to
``other`` — the O1 lint rule enforces that ``tpu_slo_*`` families are
only ever defined through this module so the bound cannot be bypassed.

All ``tpu_slo_*`` families are defined HERE and only here.  Stdlib
only, like the rest of ``obs``.

The port's own copy of the JAX package's ``obs/slo.py`` (the port
imports nothing of that package): the same calls give the same
results.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Iterable, List, Optional, Tuple

from .core import Registry

# the label value every out-of-policy class or tenant collapses to:
# request bodies are attacker-controlled on the HTTP surface, and a
# free-form label value is a series-per-value memory leak
OTHER_LABEL = "other"

# tenant label value for requests that carry no tenant at all
DEFAULT_TENANT_LABEL = "default"

# fraction of requests that must meet their SLO before the error
# budget is burning faster than 1.0x
DEFAULT_OBJECTIVE = 0.99

# rolling window the goodput/burn-rate gauges are computed over
DEFAULT_WINDOW_S = 60.0


@dataclass(frozen=True)
class SLOPolicy:
    """One request class's SLO: a TTFT target and/or a completion
    deadline (at least one), plus the error-budget objective."""

    name: str
    ttft_ms: Optional[float] = None
    deadline_ms: Optional[float] = None
    objective: float = DEFAULT_OBJECTIVE

    def __post_init__(self) -> None:
        if self.ttft_ms is None and self.deadline_ms is None:
            raise ValueError(
                f"SLO class {self.name!r} needs a TTFT target and/or "
                "a completion deadline")
        if self.ttft_ms is not None and self.ttft_ms <= 0:
            raise ValueError(f"ttft_ms must be > 0 on {self.name!r}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0 on {self.name!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1) on {self.name!r}")

    def met(self, ttft_s: Optional[float], total_s: float) -> bool:
        """Did a request with this first-token / total latency meet
        the class SLO?  A missing TTFT (no token ever streamed)
        fails a TTFT target by definition."""
        if self.ttft_ms is not None:
            if ttft_s is None or ttft_s * 1000.0 > self.ttft_ms:
                return False
        if self.deadline_ms is not None \
                and total_s * 1000.0 > self.deadline_ms:
            return False
        return True


def default_slo_policies() -> Dict[str, SLOPolicy]:
    """The policy set a server runs with when no ``--slo`` is given:
    ``interactive`` (TTFT target — streaming requests default here)
    and ``batch`` (completion deadline — unary requests default
    here).  Deliberately generous: defaults must classify, not shed."""
    return {
        "interactive": SLOPolicy("interactive", ttft_ms=2500.0),
        "batch": SLOPolicy("batch", deadline_ms=60000.0),
    }


def parse_slo_specs(specs: Optional[Iterable[str]]
                    ) -> Dict[str, SLOPolicy]:
    """``CLASS=ttft_ms[:deadline_ms]`` (repeatable) -> policy map.
    ``ttft_ms`` of 0 disables the TTFT target (deadline-only class:
    ``batch=0:60000``); a missing/0 deadline leaves TTFT-only."""
    out: Dict[str, SLOPolicy] = {}
    for spec in specs or ():
        name, _, rest = spec.partition("=")
        if not name or not rest:
            raise ValueError(
                f"bad --slo {spec!r} (want CLASS=ttft_ms[:deadline_ms])")
        parts = rest.split(":")
        if len(parts) > 2:
            raise ValueError(f"bad --slo {spec!r}")
        try:
            ttft = float(parts[0])
            deadline = float(parts[1]) if len(parts) > 1 else 0.0
        except ValueError:
            raise ValueError(
                f"bad --slo {spec!r}: targets must be numbers (ms)")
        out[name] = SLOPolicy(
            name,
            ttft_ms=ttft if ttft > 0 else None,
            deadline_ms=deadline if deadline > 0 else None)
    return out


class SLOAccountant:
    """Per-class SLO accounting over one registry (thread-safe).

    ``record()`` runs on the request's terminal path (scheduler or
    handler thread): one counter increment and one deque append.  The
    rolling-window gauges are refreshed lazily at scrape time through
    the registry's collect hook, so idle servers pay nothing."""

    def __init__(self, registry: Registry,
                 policies: Optional[Dict[str, SLOPolicy]] = None,
                 tenants: Iterable[str] = (),
                 window_s: float = DEFAULT_WINDOW_S) -> None:
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        self.policies: Dict[str, SLOPolicy] = dict(
            policies if policies is not None else default_slo_policies())
        if not self.policies:
            raise ValueError("need at least one SLO class")
        # the bounded tenant label set: declared quota tenants plus the
        # no-tenant default ("*" is the quota TEMPLATE, not a tenant)
        self._tenants = {t for t in tenants if t and t != "*"}
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        # per class: rolling (t_mono, met) window + lifetime totals
        self._events: Dict[str, Deque[Tuple[float, bool]]] = {
            name: deque() for name in self._label_classes()}
        self._totals: Dict[str, List[int]] = {
            name: [0, 0] for name in self._label_classes()}  # [total, met]
        reg = registry
        self._m_requests = reg.counter(
            "tpu_slo_requests_total",
            "Terminal requests by SLO class, tenant, and whether the "
            "class SLO was met (class/tenant values are bounded: "
            "unknown names map to 'other').",
            ("class", "tenant", "met"))
        self._g_goodput = reg.gauge(
            "tpu_slo_goodput_ratio",
            "Fraction of requests meeting their class SLO over the "
            "rolling window (1.0 when the window is empty).",
            ("class",))
        self._g_goodput_rps = reg.gauge(
            "tpu_slo_goodput_requests_per_second",
            "Requests per second meeting their class SLO over the "
            "rolling window — the fleet's goodput headline.",
            ("class",))
        self._g_burn = reg.gauge(
            "tpu_slo_error_budget_burn_rate",
            "Observed SLO miss rate over the budgeted miss rate "
            "(1 - objective) in the rolling window; 1.0 = burning "
            "exactly the budget, >1 = eating into it.",
            ("class",))
        # materialize every class's children so the families render
        # (as zeros / 1.0 goodput) from boot — dashboards and the
        # smoke promlint see one schema whether traffic arrived or not
        for name in self._label_classes():
            self._g_goodput.labels(**{"class": name}).set(1.0)
            self._g_goodput_rps.labels(**{"class": name}).set(0.0)
            self._g_burn.labels(**{"class": name}).set(0.0)
        reg.on_collect(self._collect)

    def _label_classes(self) -> List[str]:
        return list(self.policies) + [OTHER_LABEL]

    # -- label bounding ------------------------------------------------------

    def bound_class(self, slo_class: Optional[str]) -> str:
        """A request-supplied class name -> bounded label value."""
        if slo_class and slo_class in self.policies:
            return slo_class
        return OTHER_LABEL

    def bound_tenant(self, tenant: Optional[str]) -> str:
        """A request-supplied tenant -> bounded label value."""
        if not tenant:
            return DEFAULT_TENANT_LABEL
        return tenant if tenant in self._tenants else OTHER_LABEL

    # -- write path ----------------------------------------------------------

    def record(self, slo_class: Optional[str], tenant: Optional[str],
               *, ttft_s: Optional[float], total_s: float, ok: bool,
               fallback: str = "interactive") -> bool:
        """Account one terminal request.  *slo_class* is the (possibly
        free-form) request-supplied class; a request that declared no
        class lands under *fallback* (the server derives it from the
        request shape), and unknown non-empty names land under the
        ``other`` label, evaluated against *fallback*'s policy.
        Non-ok outcomes never meet an SLO.  Returns met."""
        label = self.bound_class(slo_class if slo_class else fallback)
        policy = self.policies.get(
            label if label != OTHER_LABEL else fallback)
        if policy is None:  # fallback not declared either: first policy
            policy = next(iter(self.policies.values()))
        met = ok and policy.met(ttft_s, total_s)
        self._m_requests.labels(**{
            "class": label, "tenant": self.bound_tenant(tenant),
            "met": "true" if met else "false"}).inc()
        now = time.monotonic()
        with self._lock:
            q = self._events[label]
            q.append((now, met))
            self._prune_locked(q, now)
            tot = self._totals[label]
            tot[0] += 1
            if met:
                tot[1] += 1
        return met

    def _prune_locked(self, q: Deque[Tuple[float, bool]],
                      now: float) -> None:
        cutoff = now - self.window_s
        while q and q[0][0] < cutoff:
            q.popleft()

    # -- read paths ----------------------------------------------------------

    def _window_counts(self, label: str) -> Tuple[int, int]:
        now = time.monotonic()
        with self._lock:
            q = self._events[label]
            self._prune_locked(q, now)
            total = len(q)
            met = sum(1 for _, m in q if m)
        return total, met

    def _collect(self) -> None:
        """Scrape-time gauge refresh (registry collect hook)."""
        for label in self._label_classes():
            total, met = self._window_counts(label)
            ratio = met / total if total else 1.0
            self._g_goodput.labels(**{"class": label}).set(ratio)
            self._g_goodput_rps.labels(**{"class": label}).set(
                met / self.window_s)
            policy = self.policies.get(label)
            budget = 1.0 - (policy.objective if policy is not None
                            else DEFAULT_OBJECTIVE)
            self._g_burn.labels(**{"class": label}).set(
                (1.0 - ratio) / budget if total else 0.0)

    def summary(self) -> Dict[str, object]:
        """The fixed-schema goodput block /statz (and through it the
        router's /fleet/statz and the future autoscaler) reads —
        cheap, flat, no Prometheus text on the polling hot path."""
        classes: Dict[str, Dict[str, object]] = {}
        for label in self._label_classes():
            total, met = self._window_counts(label)
            with self._lock:
                life_total, life_met = self._totals[label]
            policy = self.policies.get(label)
            budget = 1.0 - (policy.objective if policy is not None
                            else DEFAULT_OBJECTIVE)
            ratio = met / total if total else 1.0
            classes[label] = {
                "ttft_ms": policy.ttft_ms if policy else None,
                "deadline_ms": policy.deadline_ms if policy else None,
                "objective": policy.objective if policy
                else DEFAULT_OBJECTIVE,
                "total": life_total,
                "met": life_met,
                "window_total": total,
                "window_met": met,
                "goodput_ratio": ratio,
                "goodput_rps": met / self.window_s,
                "burn_rate": (1.0 - ratio) / budget if total else 0.0,
            }
        return {"window_s": self.window_s, "classes": classes}
