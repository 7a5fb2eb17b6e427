"""Multi-window multi-burn-rate alerting over the in-process TSDB.

The Google SRE workbook's alerting chapter, dep-free: each ``--slo``
class derives a **page** rule (error-budget burn >= 14.4x over the
short AND the long window — fast enough to catch a collapse, two
windows so a single noisy scrape cannot page) and a **ticket** rule
(burn >= 1x over six hours — the budget is on track to be gone), and
operators add hand-written threshold rules from a ``--alert-rules``
JSON file.  Expressions are the :mod:`.tsdb` grammar, so every rule is
also a ``/debug/query`` you can run by hand.

Each rule owns one state machine::

    inactive -> pending -(for: dwell)-> firing -> resolved -> inactive

Every transition journals to the PR-4 flight recorder (event
``tpu_alert_transition`` with a ``severity`` attr — post-mortem dumps
sort and color on it) and the evaluator exports
``tpu_alert_state{alert,severity}`` (0=inactive 1=pending 2=firing
3=resolved), ``tpu_alert_transitions_total{alert,severity}`` and
``tpu_alert_evaluations_total``.  ``/alerts`` serves :meth:`status`;
replica ``/statz`` embeds :meth:`brief` so the router's cached poll
carries alert state fleet-wide with no extra fan-out.

Alert *names* become label values, so they are bounded by the rule set
(never request-controlled), same discipline as :mod:`.slo`.

The port's own copy of the JAX package's ``obs/alerts.py`` (the port
imports nothing of that package): the same calls give the same
results.
"""

from __future__ import annotations

import json
import logging
import re
import threading
from dataclasses import dataclass, field
from typing import (
    Callable,
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Tuple,
)

from .core import Registry
from .recorder import FlightRecorder
from .slo import SLOPolicy
from .tsdb import TSDB, Expr, format_duration, parse_expr

log = logging.getLogger(__name__)

# state machine positions (and their tpu_alert_state gauge coding)
STATE_INACTIVE = "inactive"
STATE_PENDING = "pending"
STATE_FIRING = "firing"
STATE_RESOLVED = "resolved"
STATE_VALUE: Dict[str, int] = {
    STATE_INACTIVE: 0, STATE_PENDING: 1, STATE_FIRING: 2,
    STATE_RESOLVED: 3,
}

# severity routing classes (page wakes a human, ticket waits for
# business hours, info is dashboard-only)
SEVERITY_PAGE = "page"
SEVERITY_TICKET = "ticket"
SEVERITY_INFO = "info"
SEVERITIES = (SEVERITY_PAGE, SEVERITY_TICKET, SEVERITY_INFO)

# the SRE-workbook burn-rate table (objective-independent):
# page when 2% of a 30d budget burns in 1h  -> 14.4x over 5m AND 1h
# ticket when burning exactly at budget     -> 1x over 6h
PAGE_BURN_RATE = 14.4
TICKET_BURN_RATE = 1.0
PAGE_SHORT_WINDOW_S = 300.0
PAGE_LONG_WINDOW_S = 3600.0
TICKET_WINDOW_S = 21600.0

# journal event name for every state transition
ALERT_TRANSITION_EVENT = "tpu_alert_transition"

# how long a resolved alert stays visible on /alerts before returning
# to inactive (an operator must be able to see what just resolved)
DEFAULT_RESOLVED_HOLD_S = 300.0

_ALERT_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_.:-]*$")
_OPS = (">", ">=", "<", "<=")


@dataclass(frozen=True)
class AlertCondition:
    """One ``expr op threshold`` clause; a rule fires only when every
    clause holds (multi-window AND)."""

    expr: str
    op: str = ">"
    threshold: float = 0.0

    def __post_init__(self) -> None:
        if self.op not in _OPS:
            raise ValueError(
                f"bad op {self.op!r} (want one of {_OPS})")
        parse_expr(self.expr)  # malformed rules fail at load, not 3am

    def holds(self, value: float) -> bool:
        if self.op == ">":
            return value > self.threshold
        if self.op == ">=":
            return value >= self.threshold
        if self.op == "<":
            return value < self.threshold
        return value <= self.threshold


@dataclass(frozen=True)
class AlertRule:
    """One alert: ANDed conditions, a ``for:`` dwell, a severity."""

    name: str
    conditions: Tuple[AlertCondition, ...]
    severity: str = SEVERITY_TICKET
    for_s: float = 0.0
    description: str = ""

    def __post_init__(self) -> None:
        if not _ALERT_NAME_RE.match(self.name):
            raise ValueError(f"bad alert name {self.name!r}")
        if not self.conditions:
            raise ValueError(f"alert {self.name!r} needs >= 1 condition")
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"bad severity {self.severity!r} on {self.name!r} "
                f"(want one of {SEVERITIES})")
        if self.for_s < 0:
            raise ValueError(f"for_s must be >= 0 on {self.name!r}")


def threshold_rule(name: str, expr: str, op: str, threshold: float, *,
                   for_s: float = 0.0,
                   severity: str = SEVERITY_TICKET,
                   description: str = "") -> AlertRule:
    """Single-condition convenience constructor."""
    return AlertRule(name, (AlertCondition(expr, op, threshold),),
                     severity=severity, for_s=for_s,
                     description=description)


def burn_rate_rules(policies: Mapping[str, SLOPolicy], *,
                    metric: str = "tpu_slo_error_budget_burn_rate",
                    label: str = "class",
                    window_scale: float = 1.0,
                    page_burn: float = PAGE_BURN_RATE,
                    ticket_burn: float = TICKET_BURN_RATE
                    ) -> List[AlertRule]:
    """Derive the SRE multi-window multi-burn-rate rule pair for every
    SLO class.  *metric* is the instantaneous burn gauge to smooth
    (the replica uses the accountant's gauge; the router points this
    at its fleet-aggregate bridge gauge).  *window_scale* shrinks the
    canonical 5m/1h/6h windows so CI and soak tests traverse the full
    state machine in seconds of wall time."""
    if window_scale <= 0:
        raise ValueError("window_scale must be > 0")
    short_w = format_duration(PAGE_SHORT_WINDOW_S * window_scale)
    long_w = format_duration(PAGE_LONG_WINDOW_S * window_scale)
    ticket_w = format_duration(TICKET_WINDOW_S * window_scale)
    rules: List[AlertRule] = []
    for name in sorted(policies):
        sel = f'{metric}{{{label}="{name}"}}'
        rules.append(AlertRule(
            f"slo_burn_page_{name}",
            (AlertCondition(f"avg_over_time({sel}[{short_w}])",
                            ">=", page_burn),
             AlertCondition(f"avg_over_time({sel}[{long_w}])",
                            ">=", page_burn)),
            severity=SEVERITY_PAGE,
            description=(
                f"SLO class {name!r} is burning error budget at >= "
                f"{page_burn}x over both {short_w} and {long_w} — at "
                "this rate a 30d budget is gone within hours."),
        ))
        rules.append(AlertRule(
            f"slo_burn_ticket_{name}",
            (AlertCondition(f"avg_over_time({sel}[{ticket_w}])",
                            ">=", ticket_burn),),
            severity=SEVERITY_TICKET,
            description=(
                f"SLO class {name!r} has burned at >= {ticket_burn}x "
                f"budget for {ticket_w}: on track to exhaust the "
                "window's error budget."),
        ))
    return rules


def burn_rate(total: float, missed: float, objective: float) -> float:
    """The burn-rate definition everything above applies: observed
    miss rate over the budgeted miss rate.  Exposed so tests can
    hand-compute windows against the rule thresholds."""
    if not 0.0 < objective < 1.0:
        raise ValueError("objective must be in (0, 1)")
    if total <= 0:
        return 0.0
    return (missed / total) / (1.0 - objective)


# -- --alert-rules JSON ------------------------------------------------------

def parse_alert_rules(text: str) -> List[AlertRule]:
    """Parse the ``--alert-rules`` JSON document::

        {"rules": [
          {"name": "queue_deep", "expr": "tpu_serve_queue_depth",
           "op": ">", "threshold": 100, "for_s": 60,
           "severity": "ticket", "description": "..."},
          {"name": "multi", "severity": "page", "for_s": 0,
           "conditions": [
             {"expr": "rate(tpu_serve_errors_total[1m])",
              "op": ">", "threshold": 0.5},
             {"expr": "rate(tpu_serve_errors_total[10m])",
              "op": ">", "threshold": 0.5}]}
        ]}

    Either a flat ``expr/op/threshold`` triple or an explicit
    ``conditions`` list; raises ValueError on anything malformed."""
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"alert rules: bad JSON: {e}") from e
    if not isinstance(doc, dict) or not isinstance(
            doc.get("rules"), list):
        raise ValueError('alert rules: want {"rules": [...]}')
    rules: List[AlertRule] = []
    for i, raw in enumerate(doc["rules"]):
        if not isinstance(raw, dict):
            raise ValueError(f"alert rules[{i}]: want an object")
        name = raw.get("name")
        if not isinstance(name, str):
            raise ValueError(f"alert rules[{i}]: missing name")
        conds: List[AlertCondition] = []
        if "conditions" in raw:
            if not isinstance(raw["conditions"], list):
                raise ValueError(f"alert {name!r}: conditions must "
                                 "be a list")
            for c in raw["conditions"]:
                if not isinstance(c, dict) or "expr" not in c:
                    raise ValueError(
                        f"alert {name!r}: each condition needs expr")
                conds.append(AlertCondition(
                    str(c["expr"]), str(c.get("op", ">")),
                    float(c.get("threshold", 0.0))))
        elif "expr" in raw:
            conds.append(AlertCondition(
                str(raw["expr"]), str(raw.get("op", ">")),
                float(raw.get("threshold", 0.0))))
        else:
            raise ValueError(
                f"alert {name!r}: needs expr or conditions")
        rules.append(AlertRule(
            name, tuple(conds),
            severity=str(raw.get("severity", SEVERITY_TICKET)),
            for_s=float(raw.get("for_s", 0.0)),
            description=str(raw.get("description", ""))))
    names = [r.name for r in rules]
    if len(set(names)) != len(names):
        raise ValueError("alert rules: duplicate rule names")
    return rules


def load_alert_rules(path: str) -> List[AlertRule]:
    with open(path, "r", encoding="utf-8") as f:
        return parse_alert_rules(f.read())


# -- evaluator ---------------------------------------------------------------

class _RuleState:
    __slots__ = ("state", "since", "pending_since", "firing_since",
                 "resolved_since", "value", "cond_values")

    def __init__(self) -> None:
        self.state = STATE_INACTIVE
        self.since = 0.0
        self.pending_since: Optional[float] = None
        self.firing_since: Optional[float] = None
        self.resolved_since: Optional[float] = None
        self.value: Optional[float] = None
        self.cond_values: List[Optional[float]] = []


@dataclass(frozen=True)
class _CompiledRule:
    rule: AlertRule
    exprs: Tuple[Expr, ...] = field(default=())


class AlertEvaluator:
    """Evaluate a fixed rule set against one TSDB on every tick.

    Registers itself as a TSDB tick hook, so a live surface needs only
    ``TSDB.start()``; tests drive ``tsdb.tick(now=...)`` (or
    :meth:`evaluate` directly) under a fake clock."""

    def __init__(self, tsdb: TSDB, rules: Iterable[AlertRule], *,
                 registry: Optional[Registry] = None,
                 recorder: Optional[FlightRecorder] = None,
                 resolved_hold_s: float = DEFAULT_RESOLVED_HOLD_S
                 ) -> None:
        self._tsdb = tsdb
        self._recorder = recorder
        self._resolved_hold_s = float(resolved_hold_s)
        self._lock = threading.Lock()
        # transition hooks (incident bundles subscribe here).
        # Transitions are queued under the lock and hooks fire AFTER
        # it releases — a subscriber may call back into status()/
        # firing() (which take the lock) without deadlocking, and a
        # slow subscriber can never stall rule evaluation itself.
        self._hooks: List[Callable[
            [AlertRule, str, str, float, Optional[float]], None]] = []
        self._pending_hooks: List[
            Tuple[AlertRule, str, str, float, Optional[float]]] = []
        self._rules: List[_CompiledRule] = []
        seen: Dict[str, bool] = {}
        for rule in rules:
            if rule.name in seen:
                raise ValueError(f"duplicate alert rule {rule.name!r}")
            seen[rule.name] = True
            self._rules.append(_CompiledRule(
                rule, tuple(parse_expr(c.expr)
                            for c in rule.conditions)))
        self._state: Dict[str, _RuleState] = {
            c.rule.name: _RuleState() for c in self._rules}
        reg = registry if registry is not None else tsdb.registry
        self._g_state = reg.gauge(
            "tpu_alert_state",
            "Alert state machine position by alert and severity "
            "(0=inactive, 1=pending, 2=firing, 3=resolved).",
            ("alert", "severity"))
        self._c_transitions = reg.counter(
            "tpu_alert_transitions_total",
            "Alert state-machine transitions by alert and severity "
            "(every transition also journals to the flight recorder).",
            ("alert", "severity"))
        self._c_evaluations = reg.counter(
            "tpu_alert_evaluations_total",
            "Alert rule evaluation passes run by this evaluator.")
        # materialize every rule's series at boot: dashboards and the
        # promlint smoke see one schema whether anything fired or not
        for c in self._rules:
            self._g_state.labels(
                alert=c.rule.name, severity=c.rule.severity).set(0.0)
        tsdb.add_tick_hook(self.evaluate)

    @property
    def rules(self) -> List[AlertRule]:
        return [c.rule for c in self._rules]

    def add_transition_hook(
            self, fn: Callable[
                [AlertRule, str, str, float, Optional[float]],
                None]) -> None:
        """Subscribe to state-machine transitions.  *fn* is called as
        ``fn(rule, state_from, state_to, at, value)`` after every
        transition, outside the evaluator lock; exceptions are logged
        and never reach rule evaluation."""
        with self._lock:
            self._hooks.append(fn)

    # -- evaluation ----------------------------------------------------------

    def _condition_value(self, expr: Expr, cond: AlertCondition,
                         at: float) -> Optional[float]:
        """The most-breaching value across matching series (any-series
        semantics: one bad replica class breaches the rule)."""
        results = self._tsdb.evaluate(expr, at=at)
        if not results:
            return None
        values = [v for _, v in results]
        return max(values) if cond.op in (">", ">=") else min(values)

    def evaluate(self, now: Optional[float] = None) -> None:
        at = self._tsdb.now() if now is None else float(now)
        self._c_evaluations.inc()
        with self._lock:
            for c in self._rules:
                self._evaluate_rule_locked(c, at)
            fired = self._pending_hooks
            self._pending_hooks = []
            hooks = list(self._hooks)
        # hooks run outside the lock (see __init__) — a subscriber may
        # read evaluator state and must not be able to wedge the tick
        for rule, old, new, t, value in fired:
            for fn in hooks:
                try:
                    fn(rule, old, new, t, value)
                except Exception:
                    log.exception(
                        "alert transition hook failed for %s",
                        rule.name)

    def _evaluate_rule_locked(self, c: _CompiledRule,
                              at: float) -> None:
        rule = c.rule
        st = self._state[rule.name]
        cond_values: List[Optional[float]] = []
        breach = True
        for expr, cond in zip(c.exprs, rule.conditions):
            val = self._condition_value(expr, cond, at)
            cond_values.append(val)
            if val is None or not cond.holds(val):
                breach = False
        st.cond_values = cond_values
        st.value = cond_values[0] if cond_values else None
        if breach:
            if st.state in (STATE_INACTIVE, STATE_RESOLVED):
                st.pending_since = at
                self._transition_locked(rule, st, STATE_PENDING, at)
            if st.state == STATE_PENDING and \
                    st.pending_since is not None and \
                    at - st.pending_since >= rule.for_s:
                st.firing_since = at
                self._transition_locked(rule, st, STATE_FIRING, at)
        else:
            if st.state == STATE_PENDING:
                self._transition_locked(rule, st, STATE_INACTIVE, at)
            elif st.state == STATE_FIRING:
                st.resolved_since = at
                self._transition_locked(rule, st, STATE_RESOLVED, at)
            elif st.state == STATE_RESOLVED and \
                    st.resolved_since is not None and \
                    at - st.resolved_since >= self._resolved_hold_s:
                self._transition_locked(rule, st, STATE_INACTIVE, at)

    def _transition_locked(self, rule: AlertRule, st: _RuleState,
                           new: str, at: float) -> None:
        old = st.state
        st.state = new
        st.since = at
        if new == STATE_INACTIVE:
            st.pending_since = None
            st.firing_since = None
            st.resolved_since = None
        self._g_state.labels(
            alert=rule.name, severity=rule.severity).set(
                float(STATE_VALUE[new]))
        self._c_transitions.labels(
            alert=rule.name, severity=rule.severity).inc()
        if self._recorder is not None:
            self._recorder.record(
                ALERT_TRANSITION_EVENT,
                alert=rule.name, severity=rule.severity,
                state_from=old, state_to=new, at=at,
                value=(st.value if st.value is not None else ""))
        self._pending_hooks.append((rule, old, new, at, st.value))

    # -- read paths ----------------------------------------------------------

    def firing(self, severity: Optional[str] = None) -> List[str]:
        """Names of currently-firing alerts, optionally by severity."""
        with self._lock:
            out: List[str] = []
            for c in self._rules:
                st = self._state[c.rule.name]
                if st.state != STATE_FIRING:
                    continue
                if severity is not None and \
                        c.rule.severity != severity:
                    continue
                out.append(c.rule.name)
            return out

    def status(self, now: Optional[float] = None) -> Dict[str, object]:
        """The ``GET /alerts`` payload: every rule with its machine
        position, condition values, and timing."""
        at = self._tsdb.now() if now is None else float(now)
        alerts: List[Dict[str, object]] = []
        counts = {s: 0 for s in STATE_VALUE}
        with self._lock:
            for c in self._rules:
                rule = c.rule
                st = self._state[rule.name]
                counts[st.state] += 1
                alerts.append({
                    "name": rule.name,
                    "severity": rule.severity,
                    "state": st.state,
                    "state_value": STATE_VALUE[st.state],
                    "since": st.since,
                    "for_s": rule.for_s,
                    "firing_since": st.firing_since,
                    "value": st.value,
                    "description": rule.description,
                    "conditions": [
                        {"expr": cond.expr, "op": cond.op,
                         "threshold": cond.threshold, "value": val}
                        for cond, val in zip(
                            rule.conditions,
                            st.cond_values or
                            [None] * len(rule.conditions))],
                })
        return {
            "now": at,
            "alerts": alerts,
            "firing": [a["name"] for a in alerts
                       if a["state"] == STATE_FIRING],
            "counts": counts,
        }

    def brief(self) -> Dict[str, object]:
        """Compact block for ``/statz`` embedding (the router's cached
        replica poll carries it fleet-wide for free)."""
        with self._lock:
            firing = []
            pending = 0
            for c in self._rules:
                st = self._state[c.rule.name]
                if st.state == STATE_FIRING:
                    firing.append({
                        "name": c.rule.name,
                        "severity": c.rule.severity,
                        "since": st.since,
                    })
                elif st.state == STATE_PENDING:
                    pending += 1
            return {
                "firing": firing,
                "pending": pending,
                "firing_page": sum(
                    1 for f in firing if f["severity"] == SEVERITY_PAGE),
            }

    def status_json(self, now: Optional[float] = None) -> str:
        return json.dumps(self.status(now), sort_keys=True)
