#!/usr/bin/env python3
"""promlint: validate Prometheus text-exposition output.  Stdlib only.

The port's own copy of the repository's ``tools/promlint.py`` (the
port's modules import nothing from outside its package): the smokes
run it over every /metrics body they scrape, so a
renderer regression — a counter without ``_total``, a family missing
``# HELP``, a histogram without its ``+Inf`` bucket — fails them
instead of silently breaking every dashboard query downstream.

Rules (the promlint subset that bit this repo's first metrics, plus
format-validity basics):

  N1  metric names match [a-zA-Z_:][a-zA-Z0-9_:]*
  N2  label names match [a-zA-Z_][a-zA-Z0-9_]* and don't start '__'
  T1  every sample's family has a '# TYPE' declared before samples
  H1  every sample's family has a non-empty '# HELP' before samples
  T2  TYPE is one of counter|gauge|histogram|summary|untyped
  T3  no duplicate TYPE/HELP for one family
  C1  counter names end in '_total'
  C2  '_total'-suffixed series are declared counter (no type drift)
  V1  sample values parse as floats (+Inf/-Inf/NaN allowed)
  D1  no duplicate series (same name + label set twice)
  B1  histogram families expose _bucket/_sum/_count
  B2  every _bucket carries 'le' and the '+Inf' bucket exists
  B3  bucket cumulative counts are non-decreasing, +Inf == _count

Exemplar rules (the OpenMetrics renderer carries trace-id exemplars,
and this linter gates them in CI):

  X1  no exemplars in the plain text exposition (they are an
      OpenMetrics-only construct; plain scrapers would choke)
  X2  exemplars only on histogram '_bucket' or counter '_total' lines
  X3  exemplar label set (the text inside '{...}') <= 128 chars
  X4  exemplar values parse ('# {labels} value [timestamp]')

Exposition mode: ``lint(text, openmetrics=None)`` auto-detects by the
trailing ``# EOF`` terminator (required in OpenMetrics, absent in the
plain format); pass True/False to pin it.

Usage:
  python -m tpu_k8s_device_plugin_torch.tools.promlint [--openmetrics] FILE
      [...]   # '-' = stdin
  from tpu_k8s_device_plugin_torch.tools.promlint import lint
"""

from __future__ import annotations

import math
import re
import sys
from typing import Dict, List, Tuple

_METRIC_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_TYPES = {"counter", "gauge", "histogram", "summary", "untyped"}
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _parse_labels(raw: str, line_no: int, errors: List[str]
                  ) -> Tuple[Dict[str, str], int, bool]:
    """Parse '{a="b",c="d"}' (escapes included); returns
    (labels, chars consumed, ok)."""
    labels: Dict[str, str] = {}
    i = 1
    while True:
        while i < len(raw) and raw[i] in ", ":
            i += 1
        if i < len(raw) and raw[i] == "}":
            return labels, i + 1, True
        m = re.match(r'([a-zA-Z_][a-zA-Z0-9_]*)="', raw[i:])
        if not m:
            errors.append(f"line {line_no}: malformed label block {raw!r}")
            return labels, i, False
        name = m.group(1)
        if name.startswith("__"):
            errors.append(
                f"line {line_no}: reserved label name {name!r} (N2)")
        i += m.end()
        buf = []
        while i < len(raw):
            c = raw[i]
            if c == "\\":
                nxt = raw[i + 1:i + 2]
                if nxt not in ("\\", '"', "n"):
                    errors.append(
                        f"line {line_no}: bad escape '\\{nxt}' in label "
                        f"value")
                buf.append({"\\": "\\", '"': '"', "n": "\n"}.get(
                    nxt, nxt))
                i += 2
            elif c == '"':
                i += 1
                break
            else:
                buf.append(c)
                i += 1
        else:
            errors.append(f"line {line_no}: unterminated label value")
            return labels, i, False
        if name in labels:
            errors.append(
                f"line {line_no}: duplicate label {name!r} in one series")
        labels[name] = "".join(buf)


def _base_family(name: str, types: Dict[str, str]) -> str:
    """Histogram/summary samples declare TYPE under the base name."""
    for suffix in _HIST_SUFFIXES + ("_created",):
        if name.endswith(suffix):
            base = name[: -len(suffix)]
            if base in types:
                return base
    return name


_EXEMPLAR_MAX_LABEL_CHARS = 128


def _lint_exemplar(name: str, raw: str, line_no: int,
                   errors: List[str]) -> None:
    """Validate one exemplar tail (the text after ' # ') against the
    X-rules; *name* is the sample's metric name."""
    if not (name.endswith("_bucket") or name.endswith("_total")):
        errors.append(
            f"line {line_no}: exemplar on {name!r} (only _bucket/"
            "_total lines may carry exemplars) (X2)")
    m = re.match(r"^\{(.*)\}\s+(\S+)(?:\s+(\S+))?\s*$", raw)
    if not m:
        errors.append(
            f"line {line_no}: malformed exemplar {raw!r} (X4)")
        return
    labelset, value, ts = m.groups()
    # OpenMetrics: total exemplar label characters (names + values)
    # bounded at 128 so scrape buffers stay predictable
    if len(labelset) > _EXEMPLAR_MAX_LABEL_CHARS:
        errors.append(
            f"line {line_no}: exemplar label set is {len(labelset)} "
            f"chars, over the {_EXEMPLAR_MAX_LABEL_CHARS} bound (X3)")
    for raw_num, what in ((value, "value"), (ts, "timestamp")):
        if raw_num is None:
            continue
        try:
            float(raw_num)
        except ValueError:
            errors.append(
                f"line {line_no}: unparseable exemplar {what} "
                f"{raw_num!r} (X4)")


def lint(text: str, openmetrics=None) -> List[str]:
    """Lint one exposition body; returns a list of error strings
    (empty = clean).  *openmetrics* None auto-detects the mode from
    the trailing ``# EOF`` terminator."""
    if openmetrics is None:
        openmetrics = text.rstrip("\n").endswith("# EOF")
    errors: List[str] = []
    helps: Dict[str, str] = {}
    types: Dict[str, str] = {}
    seen_series: set = set()
    # family -> {label-key-minus-le -> [(le, value)]}, plus _sum/_count
    hist_parts: Dict[str, Dict[str, set]] = {}
    hist_buckets: Dict[Tuple[str, Tuple], List[Tuple[float, float]]] = {}
    hist_counts: Dict[Tuple[str, Tuple], float] = {}

    for line_no, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) < 4 or not parts[3].strip():
                errors.append(f"line {line_no}: empty HELP text (H1)")
                continue
            name = parts[2]
            if name in helps:
                errors.append(
                    f"line {line_no}: duplicate HELP for {name} (T3)")
            helps[name] = parts[3]
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                errors.append(f"line {line_no}: malformed TYPE line")
                continue
            _, _, name, kind = parts
            if kind not in _TYPES:
                errors.append(
                    f"line {line_no}: unknown TYPE {kind!r} (T2)")
            if name in types:
                errors.append(
                    f"line {line_no}: duplicate TYPE for {name} (T3)")
            types[name] = kind
            if kind == "counter" and not name.endswith("_total"):
                errors.append(
                    f"line {line_no}: counter {name!r} must end in "
                    "'_total' (C1)")
            continue
        if line.startswith("#"):
            continue  # arbitrary comments are legal
        # -- sample line ---------------------------------------------------
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)", line)
        if not m:
            errors.append(f"line {line_no}: malformed sample {line!r} (N1)")
            continue
        name = m.group(1)
        rest = line[m.end():]
        labels: Dict[str, str] = {}
        if rest.startswith("{"):
            labels, consumed, ok = _parse_labels(rest, line_no, errors)
            if not ok:
                continue
            rest = rest[consumed:]
        exemplar = None
        if " # " in rest:
            # OpenMetrics exemplar tail: '<value> [ts] # {labels} v [ts]'
            rest, exemplar = rest.split(" # ", 1)
            if not openmetrics:
                errors.append(
                    f"line {line_no}: exemplar in plain-text "
                    "exposition (OpenMetrics only) (X1)")
            _lint_exemplar(name, exemplar.strip(), line_no, errors)
        value_parts = rest.split()
        if not value_parts:
            errors.append(f"line {line_no}: sample has no value (V1)")
            continue
        raw_val = value_parts[0]
        try:
            value = (math.inf if raw_val == "+Inf"
                     else -math.inf if raw_val == "-Inf"
                     else float(raw_val))
        except ValueError:
            errors.append(
                f"line {line_no}: unparseable value {raw_val!r} (V1)")
            continue
        family = _base_family(name, types)
        if family not in types:
            errors.append(
                f"line {line_no}: sample {name} has no # TYPE (T1)")
        if family not in helps:
            errors.append(
                f"line {line_no}: sample {name} has no # HELP (H1)")
        kind = types.get(family)
        if name.endswith("_total") and kind not in (None, "counter"):
            errors.append(
                f"line {line_no}: {name} ends in _total but family "
                f"{family} is {kind} (C2)")
        series_key = (name, tuple(sorted(labels.items())))
        if series_key in seen_series:
            errors.append(
                f"line {line_no}: duplicate series {name}"
                f"{dict(labels)} (D1)")
        seen_series.add(series_key)
        if kind == "histogram":
            hist_parts.setdefault(family, {"_bucket": set(),
                                           "_sum": set(), "_count": set()})
            for suffix in _HIST_SUFFIXES:
                if name == family + suffix:
                    child = tuple(sorted(
                        (k, v) for k, v in labels.items() if k != "le"))
                    hist_parts[family][suffix].add(child)
                    if suffix == "_bucket":
                        if "le" not in labels:
                            errors.append(
                                f"line {line_no}: {name} without "
                                "'le' (B2)")
                        else:
                            le = (math.inf if labels["le"] == "+Inf"
                                  else float(labels["le"]))
                            hist_buckets.setdefault(
                                (family, child), []).append((le, value))
                    elif suffix == "_count":
                        hist_counts[(family, child)] = value
                    break
            else:
                if name == family:
                    errors.append(
                        f"line {line_no}: bare sample {name} on a "
                        "histogram family (B1)")

    for family, parts in hist_parts.items():
        for suffix in _HIST_SUFFIXES:
            if not parts[suffix]:
                errors.append(f"{family}: missing {family}{suffix} (B1)")
        for child in parts["_bucket"]:
            buckets = sorted(hist_buckets.get((family, child), []))
            if not buckets:
                continue
            if buckets[-1][0] != math.inf:
                errors.append(
                    f"{family}{dict(child)}: no '+Inf' bucket (B2)")
                continue
            cum = [v for _, v in buckets]
            if any(b > a for a, b in zip(cum[1:], cum)):
                errors.append(
                    f"{family}{dict(child)}: bucket counts decrease (B3)")
            count = hist_counts.get((family, child))
            if count is not None and count != buckets[-1][1]:
                errors.append(
                    f"{family}{dict(child)}: _count {count} != +Inf "
                    f"bucket {buckets[-1][1]} (B3)")
    return errors


def main(argv: List[str]) -> int:
    openmetrics = None
    if argv and argv[0] == "--openmetrics":
        openmetrics = True
        argv = argv[1:]
    paths = argv or ["-"]
    failed = False
    for path in paths:
        if path == "-":
            text, label = sys.stdin.read(), "<stdin>"
        else:
            with open(path, "r", encoding="utf-8") as f:
                text, label = f.read(), path
        errors = lint(text, openmetrics=openmetrics)
        for e in errors:
            print(f"{label}: {e}")
        failed = failed or bool(errors)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
