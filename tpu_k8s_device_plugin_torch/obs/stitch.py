"""Cross-process trace stitching: flight-recorder events -> span tree.

One trace-id crosses processes (client -> router -> replica ->
scheduler window): each hop continues the W3C ``traceparent`` as a
CHILD context, so every flight-recorder event carries (trace_id,
span_id, parent_id) and the events of one request — harvested from
live ``/debug/traces`` endpoints or post-mortem dump files — re-link
into one ordered tree.  This module is that re-linker, shared by the
router's fan-out stitcher and the ``tools/obs_query.py`` CLI:

- :func:`stitch` groups events by span-id, links spans via parent-id,
  and returns JSON-ready root nodes (events and children ordered by
  wall time — one clock per node's process, same host in practice),
- :func:`render_tree` draws the same tree as indented text for
  terminals.

Events predating the ``parent_id`` stamp (old dump files) still
stitch: they form parentless roots, ordered by time.  Stdlib only.

The port's own copy of the JAX package's ``obs/stitch.py`` (the port
imports nothing of that package): the same calls give the same
results.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def _as_float(v: object) -> float:
    return float(v) if isinstance(v, (int, float)) else 0.0


def _as_str(v: object) -> str:
    return v if isinstance(v, str) else ""


class _Node:
    __slots__ = ("span_id", "parent_id", "source", "events",
                 "children")

    def __init__(self, span_id: str) -> None:
        self.span_id = span_id
        self.parent_id = ""
        self.source = ""
        self.events: List[Dict[str, object]] = []
        self.children: List["_Node"] = []

    def t0(self) -> float:
        return min((_as_float(e.get("t_wall")) for e in self.events),
                   default=0.0)

    def to_dict(self) -> Dict[str, object]:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "source": self.source,
            "events": self.events,
            "children": [c.to_dict() for c in self.children],
        }


def stitch(events: List[Dict[str, object]]
           ) -> List[Dict[str, object]]:
    """Re-link one trace's *events* (dicts in the flight-recorder
    shape, possibly from several processes) into span-tree roots.
    Each node: ``{span_id, parent_id, source, events, children}``
    with events and children ordered by wall time."""
    nodes: Dict[str, _Node] = {}
    for ev in events:
        sid = _as_str(ev.get("span_id"))
        node = nodes.get(sid)
        if node is None:
            node = nodes[sid] = _Node(sid)
        node.events.append(ev)
        pid = _as_str(ev.get("parent_id"))
        if pid:
            node.parent_id = pid
        src = _as_str(ev.get("source"))
        if src:
            node.source = src
    roots: List[_Node] = []
    for node in nodes.values():
        node.events.sort(key=lambda e: _as_float(e.get("t_wall")))
        parent = nodes.get(node.parent_id) if node.parent_id else None
        if parent is not None and parent is not node:
            parent.children.append(node)
        else:
            roots.append(node)
    for node in nodes.values():
        node.children.sort(key=lambda n: n.t0())
    roots.sort(key=lambda n: n.t0())
    return [r.to_dict() for r in roots]


def event_severity(ev: Dict[str, object]) -> str:
    """An event's severity tag: top-level ``severity`` when present,
    else the ``severity`` attr alert-transition journal entries carry
   .  Empty string for everything unsevere."""
    sev = ev.get("severity")
    if isinstance(sev, str) and sev:
        return sev
    attrs = ev.get("attrs")
    if isinstance(attrs, dict):
        sev = attrs.get("severity")
        if isinstance(sev, str):
            return sev
    return ""


def flatten(tree: List[Dict[str, object]]) -> List[Dict[str, object]]:
    """Depth-first event list of a stitched tree — the causal order a
    test (or a grep) walks: a parent span's events come before its
    children's.  Events carrying a severity (alert transitions) gain
    a top-level ``severity`` key so downstream renderers and filters
    never dig through attrs."""
    out: List[Dict[str, object]] = []

    def walk(node: Dict[str, object]) -> None:
        evs = node.get("events")
        if isinstance(evs, list):
            for e in evs:
                if not isinstance(e, dict):
                    continue
                sev = event_severity(e)
                out.append({**e, "severity": sev} if sev else e)
        children = node.get("children")
        if isinstance(children, list):
            for c in children:
                if isinstance(c, dict):
                    walk(c)

    for root in tree:
        walk(root)
    return out


def render_tree(tree: List[Dict[str, object]],
                t_base: Optional[float] = None) -> str:
    """Indented text rendering of a stitched tree (the obs_query CLI's
    output).  Event times print relative to the trace's first event."""
    lines: List[str] = []
    if t_base is None:
        stamps = [_as_float(e.get("t_wall")) for e in flatten(tree)]
        t_base = min((s for s in stamps if s > 0), default=0.0)

    def walk(node: Dict[str, object], depth: int) -> None:
        pad = "  " * depth
        sid = _as_str(node.get("span_id")) or "(no span)"
        src = _as_str(node.get("source"))
        evs = node.get("events")
        n = len(evs) if isinstance(evs, list) else 0
        head = f"{pad}span {sid[:16]}"
        if src:
            head += f" [{src}]"
        lines.append(f"{head} ({n} events)")
        if isinstance(evs, list):
            for ev in evs:
                if not isinstance(ev, dict):
                    continue
                dt = _as_float(ev.get("t_wall")) - (t_base or 0.0)
                name = _as_str(ev.get("name"))
                attrs = ev.get("attrs")
                extra = ""
                if isinstance(attrs, dict):
                    dur = attrs.get("duration_s")
                    if isinstance(dur, (int, float)):
                        extra = f" duration_s={dur:.6f}"
                    out = attrs.get("outcome")
                    if isinstance(out, str):
                        extra += f" outcome={out}"
                sev = event_severity(ev)
                if sev:
                    extra += f" severity={sev}"
                lines.append(f"{pad}  +{dt:9.4f}s {name}{extra}")
        children = node.get("children")
        if isinstance(children, list):
            for c in children:
                if isinstance(c, dict):
                    walk(c, depth + 1)

    for root in tree:
        walk(root, 0)
    return "\n".join(lines)
