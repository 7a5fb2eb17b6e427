"""Grammar-constrained decoding support (vLLM's guided decoding).

A grammar is compiled AHEAD of decoding into a token-level DFA —
``table[state, token] -> next state`` (-1 rejects; the additive logit
mask is DERIVED from reject entries, never stored) — and the DFA state
is one more row of the decode step's static buffers.  Constrained
generation then costs one ``[S, V]`` row gather per step inside the
SAME captured decode step as unconstrained decoding: no per-token host
round-trip, no Python in the loop (the xgrammar/outlines token-bitmask
idea, expressed as arrays).  Runs the DFA *forces* (single legal
continuation) commit through the engine's structural jump-ahead
(``ServingEngine.jump_round``) in one multi-token extend.

Pipeline:

1. ``regex_to_dfa(pattern)`` — a small regex subset (literals, ``|``,
   ``*`` ``+`` ``?``, ``(...)``, ``[a-z]`` classes, ``.``) compiled
   via Thompson NFA + subset construction over the byte alphabet.
   ``json_value_regex`` / ``json_object_regex`` / ``schema_to_regex``
   lower JSON constraints (RFC 8259-strict; compact output for
   schemas) into the subset; ``token_bytes_of`` maps a tokenizer's
   vocabulary to byte strings.
2. ``token_dfa(dfa, token_bytes, eos_id)`` — the char DFA is closed
   over the vocabulary (vectorized [N, V] walks), trimmed to
   co-accessible states, and dead-end-checked; ``eos`` is allowed
   exactly in ACCEPTING states (structural completion gates the
   stop).

Engines hold a REGISTRY of these (``ServingEngine(grammar=...)`` or
``register_grammar()``); requests opt in with ``admit(grammar=gid)``
(``True`` = grammar 0).  This module is a copy of the JAX
package's, so both engines compile a pattern to the same tables.
"""

from __future__ import annotations

import re as _re
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

_REJECT = -1


# -- char-level regex -> DFA -------------------------------------------------

@dataclass(frozen=True)
class CharDfa:
    """Byte-alphabet DFA: table [n_states, 256] int32 (-1 = reject),
    state 0 initial, ``accepting`` a bool per state."""

    table: np.ndarray
    accepting: np.ndarray


class _Nfa:
    """Thompson construction: states are ints, transitions are
    (state, byte) -> set[state], plus epsilon edges."""

    def __init__(self):
        self.eps: Dict[int, set] = {}
        self.edges: Dict[Tuple[int, int], set] = {}
        self.n = 0

    def new(self) -> int:
        s = self.n
        self.n += 1
        return s

    def add_eps(self, a: int, b: int) -> None:
        self.eps.setdefault(a, set()).add(b)

    def add(self, a: int, byte: int, b: int) -> None:
        self.edges.setdefault((a, byte), set()).add(b)


def _parse(pattern: str):
    """Recursive-descent parse into an AST of
    ('lit', bytes) | ('class', frozenset) | ('cat', [..]) |
    ('alt', [..]) | ('star'|'plus'|'opt', node)."""
    pos = 0

    def error(msg):
        raise ValueError(f"regex error at {pos}: {msg} in {pattern!r}")

    def parse_alt():
        nonlocal pos
        branches = [parse_cat()]
        while pos < len(pattern) and pattern[pos] == "|":
            pos += 1
            branches.append(parse_cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def parse_cat():
        nonlocal pos
        items = []
        while pos < len(pattern) and pattern[pos] not in "|)":
            items.append(parse_repeat())
        return ("cat", items)

    def parse_repeat():
        nonlocal pos
        atom = parse_atom()
        while pos < len(pattern) and pattern[pos] in "*+?":
            op = {"*": "star", "+": "plus", "?": "opt"}[pattern[pos]]
            pos += 1
            atom = (op, atom)
        return atom

    def parse_atom():
        nonlocal pos
        c = pattern[pos]
        if c == "(":
            pos += 1
            inner = parse_alt()
            if pos >= len(pattern) or pattern[pos] != ")":
                error("unclosed group")
            pos += 1
            return inner
        if c == "[":
            pos += 1
            negate = pos < len(pattern) and pattern[pos] == "^"
            if negate:
                pos += 1
            chars = set()
            while pos < len(pattern) and pattern[pos] != "]":
                ch = pattern[pos]
                if ch == "\\":
                    pos += 1
                    ch = pattern[pos]
                if (pos + 2 < len(pattern) and pattern[pos + 1] == "-"
                        and pattern[pos + 2] != "]"):
                    lo, hi = ord(ch), ord(pattern[pos + 2])
                    chars.update(range(lo, hi + 1))
                    pos += 3
                else:
                    chars.add(ord(ch))
                    pos += 1
            if pos >= len(pattern):
                error("unclosed class")
            pos += 1
            if negate:
                chars = set(range(256)) - chars
            return ("class", frozenset(chars))
        if c == ".":
            pos += 1
            return ("class", frozenset(range(256)))
        if c == "\\":
            pos += 1
            if pos >= len(pattern):
                error("trailing backslash")
            ch = pattern[pos]
            pos += 1
            table = {"n": 10, "t": 9, "r": 13, "d": None, "s": None}
            if ch == "d":
                return ("class", frozenset(range(48, 58)))
            if ch == "s":
                return ("class", frozenset({9, 10, 13, 32}))
            return ("lit", bytes([table.get(ch) or ord(ch)]))
        if c in "*+?|)":
            error(f"unexpected {c!r}")
        pos += 1
        return ("lit", c.encode("utf-8"))

    ast = parse_alt()
    if pos != len(pattern):
        error("trailing input")
    return ast


def _build_nfa(node, nfa: _Nfa) -> Tuple[int, int]:
    """Returns (entry, exit) state pair for *node*."""
    kind = node[0]
    if kind == "lit":
        prev = nfa.new()
        entry = prev
        for b in node[1]:
            nxt = nfa.new()
            nfa.add(prev, b, nxt)
            prev = nxt
        return entry, prev
    if kind == "class":
        a, b = nfa.new(), nfa.new()
        for byte in node[1]:
            nfa.add(a, byte, b)
        return a, b
    if kind == "cat":
        if not node[1]:
            s = nfa.new()
            return s, s
        entry, cur = _build_nfa(node[1][0], nfa)
        for item in node[1][1:]:
            a, b = _build_nfa(item, nfa)
            nfa.add_eps(cur, a)
            cur = b
        return entry, cur
    if kind == "alt":
        entry, exit_ = nfa.new(), nfa.new()
        for br in node[1]:
            a, b = _build_nfa(br, nfa)
            nfa.add_eps(entry, a)
            nfa.add_eps(b, exit_)
        return entry, exit_
    if kind in ("star", "plus", "opt"):
        a, b = _build_nfa(node[1], nfa)
        entry, exit_ = nfa.new(), nfa.new()
        nfa.add_eps(entry, a)
        nfa.add_eps(b, exit_)
        if kind in ("star", "opt"):
            nfa.add_eps(entry, exit_)
        if kind in ("star", "plus"):
            nfa.add_eps(b, a)
        return entry, exit_
    raise AssertionError(kind)


def regex_to_dfa(pattern: str) -> CharDfa:
    """Compile the regex subset into a byte-alphabet DFA (full-match
    semantics: accepting states mean the WHOLE input so far matches)."""
    nfa = _Nfa()
    entry, exit_ = _build_nfa(_parse(pattern), nfa)

    def closure(states: FrozenSet[int]) -> FrozenSet[int]:
        out = set(states)
        work = list(states)
        while work:
            s = work.pop()
            for t in nfa.eps.get(s, ()):
                if t not in out:
                    out.add(t)
                    work.append(t)
        return frozenset(out)

    start = closure(frozenset({entry}))
    ids: Dict[FrozenSet[int], int] = {start: 0}
    rows: List[np.ndarray] = []
    accepting: List[bool] = []
    work = [start]
    while work:
        cur = work.pop()
        i = ids[cur]
        while len(rows) <= i:
            rows.append(np.full(256, _REJECT, np.int32))
            accepting.append(False)
        accepting[i] = exit_ in cur
        row = rows[i]
        for byte in range(256):
            tgt = set()
            for s in cur:
                tgt.update(nfa.edges.get((s, byte), ()))
            if not tgt:
                continue
            nxt = closure(frozenset(tgt))
            if nxt not in ids:
                ids[nxt] = len(ids)
                work.append(nxt)
            row[byte] = ids[nxt]
    table = np.stack([rows[i] for i in range(len(ids))])
    acc = np.asarray([accepting[i] for i in range(len(ids))], bool)
    return CharDfa(table=table, accepting=acc)


# -- char DFA -> token DFA ---------------------------------------------------

@dataclass(frozen=True)
class TokenDfa:
    """Token-level automaton for an engine: ``table [N, V]`` int32
    next-state (-1 = token rejected in that state), start state 0.
    ``eos`` is allowed exactly in accepting states (a self-loop, so
    its entry is >= 0).  The table is the ONLY stored array — the
    additive logit mask is fully derived from reject entries, and
    storing it would double the footprint (~1.4 GB for a JSON grammar
    at a 128k vocab) per cached pattern."""

    table: np.ndarray
    start: int = 0

    @property
    def mask(self) -> np.ndarray:
        """[N, V] float32 additive logit mask (0 allowed / -1e9
        rejected), derived on demand — diagnostics and tests only;
        the engine derives the same mask in-step from the table."""
        return np.where(self.table >= 0, 0.0, -1e9).astype(np.float32)


def token_dfa(dfa: CharDfa, token_bytes: List[bytes],
              eos_id: int) -> TokenDfa:
    """Close the char DFA over the vocabulary: token t from state s
    lands where walking t's bytes lands (or rejects).  Tokens mapping
    to b"" (special ids) are rejected everywhere except ``eos``, which
    is allowed exactly in accepting states."""
    n_states = len(dfa.table)
    V = len(token_bytes)
    # vectorized closure: walk EVERY (state, token) pair one byte
    # position at a time with [N, V] gathers — max-token-length numpy
    # passes instead of an O(N * V * len) Python loop (decisive for
    # real 100k+ vocabs against a few-thousand-state JSON grammar)
    max_b = max((len(bs) for bs in token_bytes), default=0)
    bytes_mat = np.full((V, max(max_b, 1)), -1, np.int64)
    for t, bs in enumerate(token_bytes):
        if t == eos_id or not bs:
            continue  # specials/eos reject everywhere (masked below)
        bytes_mat[t, :len(bs)] = list(bs)
    cur = np.tile(np.arange(n_states, dtype=np.int32)[:, None], (1, V))
    for p in range(max_b):
        bp = bytes_mat[:, p]
        has = (bp >= 0)[None, :]
        step = dfa.table[np.maximum(cur, 0),
                         np.maximum(bp, 0)[None, :]]
        cur = np.where(has, np.where(cur >= 0, step, _REJECT), cur)
    cur[:, bytes_mat[:, 0] < 0] = _REJECT
    table = np.ascontiguousarray(cur.astype(np.int32))
    if 0 <= eos_id < V:
        for s in np.flatnonzero(dfa.accepting):
            table[s, eos_id] = s  # self-loop; generation retires at eos
    # trim to co-accessible states: a token step into a state from
    # which NO accepting state is token-reachable would trap the
    # generation (decoding forever with eos masked, or hitting a
    # dead end later) — reject those transitions up front, exactly
    # like outlines' FSM reduction
    # reverse-adjacency BFS (one O(N*V) edge collection + O(edges)
    # walk) instead of a forward fixed point, whose iteration count is
    # the DFA diameter — quadratic for chain grammars like long
    # literal enums
    rev: List[List[int]] = [[] for _ in range(n_states)]
    for s in range(n_states):
        row = table[s]
        for t in np.unique(row[row >= 0]):
            rev[int(t)].append(s)
    live = dfa.accepting.copy()
    work = [int(s) for s in np.flatnonzero(live)]
    while work:
        t = work.pop()
        for s in rev[t]:
            if not live[s]:
                live[s] = True
                work.append(s)
    trap = (table >= 0) & ~live[np.maximum(table, 0)]
    table[trap] = _REJECT
    # dead-end guard over states actually REACHABLE from the start
    # (unreachable char-DFA states legitimately have no token cover):
    # a reachable state where nothing (incl. eos) is allowed would
    # force garbage tokens through the mask
    reach = np.zeros(n_states, bool)
    reach[0] = True
    work = [0]
    while work:
        s = work.pop()
        row = table[s]
        for t in np.unique(row[row >= 0]):
            if not reach[t]:
                reach[t] = True
                work.append(int(t))
    dead = (table < 0).all(axis=1) & reach
    if dead.any():
        raise ValueError(
            f"grammar has dead-end states {np.flatnonzero(dead).tolist()}"
            " (no token or eos allowed); widen the pattern or the "
            "vocabulary")
    return TokenDfa(table=table, start=0)


# -- served-grammar helpers --------------------------------------------------
#
# A serving front door compiles per-request constraints through
# these: a `guided_regex` pattern is used verbatim; `guided_json` /
# OpenAI `response_format` lowers to a bounded-depth JSON regex (a
# regular-language approximation of JSON — the standard trick for
# DFA-based guided decoding, since true JSON nesting is not regular).

_JSON_WS = r"\s*"
# RFC 8259-strict lowering (under-constraining would let "guided JSON"
# emit unparseable output): string chars exclude raw control bytes,
# escapes are the legal set only, integers forbid leading zeros
_JSON_CTRL = "".join(chr(c) for c in range(0x20))
_JSON_HEX = "[0-9a-fA-F]"
_JSON_STRING = ('"([^"\\\\' + _JSON_CTRL + ']|\\\\(["\\\\/bfnrt]'
                f"|u{_JSON_HEX}{_JSON_HEX}{_JSON_HEX}{_JSON_HEX}))*\"")
_JSON_NUMBER = r"-?(0|[1-9]\d*)(\.\d+)?([eE][+-]?\d+)?"
_JSON_SCALAR = (f"({_JSON_STRING}|{_JSON_NUMBER}"
                "|true|false|null)")


def json_value_regex(depth: int = 3) -> str:
    """Regex for a JSON value with nesting bounded at *depth* (0 =
    scalars only).  OpenAI ``response_format={"type": "json_object"}``
    maps here: the model may emit any JSON object up to the depth
    bound."""
    if depth < 0:
        raise ValueError("depth must be >= 0")
    val = _JSON_SCALAR
    for _ in range(depth):
        pair = f"{_JSON_STRING}{_JSON_WS}:{_JSON_WS}{val}"
        obj = (f"\\{{{_JSON_WS}({pair}({_JSON_WS},{_JSON_WS}{pair})*)?"
               f"{_JSON_WS}\\}}")
        arr = (f"\\[{_JSON_WS}({val}({_JSON_WS},{_JSON_WS}{val})*)?"
               f"{_JSON_WS}\\]")
        val = f"({_JSON_SCALAR}|{obj}|{arr})"
    return val


def json_object_regex(depth: int = 3) -> str:
    """Regex for a JSON OBJECT (not a bare scalar/array) with member
    values nested up to ``depth - 1`` — the OpenAI
    ``response_format={"type": "json_object"}`` contract, which
    promises an object, not any JSON value."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    val = json_value_regex(depth - 1)
    pair = f"{_JSON_STRING}{_JSON_WS}:{_JSON_WS}{val}"
    return (f"\\{{{_JSON_WS}({pair}({_JSON_WS},{_JSON_WS}{pair})*)?"
            f"{_JSON_WS}\\}}")


def _regex_escape(text: str) -> str:
    """Escape *text* for the module's regex subset (literal match)."""
    return "".join(
        "\\" + c if c in "\\()[]{}*+?|." else c for c in text)


def schema_to_regex(schema: dict, depth: int = 3,
                    ws: str = "") -> str:
    """Lower a JSON-schema SUBSET to a regex: ``type`` of string /
    integer / number / boolean / null, ``enum`` of scalars, ``array``
    with ``items``, and ``object`` with ``properties`` (all properties
    required, emitted in declaration order — the shape constrained
    decoding guarantees, mirroring vLLM's guided_json ordering).
    Unsupported keywords raise ValueError so callers 400 instead of
    silently under-constraining.

    *ws* is the separator-whitespace regex fragment.  The default is
    COMPACT output (no whitespace — OpenAI structured-output style):
    compactness makes the schema's literal skeleton (braces, keys,
    colons, commas) single-choice at every DFA state, which is exactly
    what the engine's structural jump-ahead (``jump_round``) commits
    in one extend; pass ``ws=r"\\s*"`` for lenient spacing."""
    if not isinstance(schema, dict):
        raise ValueError("schema must be a JSON object")
    # reject keywords whose absence from the lowering could make the
    # OUTPUT violate the schema (minimum, pattern, maxLength, ...):
    # silent under-constraining is exactly what the 400 path exists to
    # prevent.  Keys that only ever OVER-constrain relative to our
    # all-properties/declaration-order contract (required,
    # additionalProperties) or are annotations are safe to ignore.
    unsafe = set(schema) - {
        "type", "enum", "items", "properties", "required",
        "additionalProperties", "title", "description", "default",
        "$schema", "examples",
    }
    if unsafe:
        raise ValueError(
            f"unsupported schema keywords {sorted(unsafe)}: the "
            "served subset cannot enforce them, and ignoring them "
            "would silently under-constrain the output")
    if "enum" in schema:
        import json as _json

        opts = []
        for v in schema["enum"]:
            if v is None or isinstance(v, (bool, str, int, float)):
                # JSON-encode FIRST (quotes/backslashes in strings
                # must come out as \" / \\ escape sequences, or the
                # DFA would force unparseable output), then escape
                # the encoding for the regex subset
                opts.append(_regex_escape(_json.dumps(v)))
            else:
                raise ValueError(f"unsupported enum value {v!r}")
        return "(" + "|".join(opts) + ")"
    t = schema.get("type")
    if t == "string":
        return _JSON_STRING
    if t == "integer":
        return r"-?(0|[1-9]\d*)"  # RFC 8259: no leading zeros
    if t == "number":
        return _JSON_NUMBER
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "array":
        item = (schema_to_regex(schema["items"], depth, ws)
                if "items" in schema else json_value_regex(depth))
        return (f"\\[{ws}({item}({ws},{ws}{item})*)?"
                f"{ws}\\]")
    if t == "object":
        props = schema.get("properties")
        if not props:
            if schema.get("additionalProperties") is False:
                # no properties + additionalProperties false admits
                # ONLY the empty object; falling through to
                # json_object_regex would permit arbitrary members —
                # exactly the silent under-constraining the unsafe-
                # keyword 400 path exists to prevent (ADVICE r5)
                return f"\\{{{ws}\\}}"
            # a schemaless object is still an OBJECT, never a scalar
            return json_object_regex(max(depth, 1))
        import json as _json

        pairs = []
        for name, sub in props.items():
            key = _regex_escape(_json.dumps(name))
            pairs.append(
                f"{key}{ws}:{ws}"
                + schema_to_regex(sub, depth, ws))
        body = f"{ws},{ws}".join(pairs)
        return f"\\{{{ws}{body}{ws}\\}}"
    raise ValueError(
        f"unsupported schema {schema!r}: the served subset covers "
        "type string/integer/number/boolean/null/array/object and "
        "scalar enum")


def _gpt2_byte_decoder() -> Dict[str, int]:
    """The GPT-2 byte-level BPE printable-unicode <-> byte table
    (public algorithm from the GPT-2 tokenizer; every byte-level
    tokenizer since reuses it)."""
    bs = (list(range(33, 127)) + list(range(161, 173))
          + list(range(174, 256)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def token_bytes_of(tokenizer, vocab_size: Optional[int] = None
                   ) -> List[bytes]:
    """Best-effort per-token byte strings for *tokenizer* (the input
    ``token_dfa`` needs): handles sentencepiece ``▁``-space and
    ``<0xHH>`` byte-fallback tokens, GPT-2-style byte-level BPE
    surface forms, and plain vocab entries; special tokens (and ids
    past the tokenizer's size, for padded model vocabs) map to ``b""``
    so the DFA rejects them everywhere.  This is the same
    token-to-bytes dance outlines/xgrammar do for vLLM's guided
    decoding."""
    try:
        size = len(tokenizer)
    except TypeError:
        size = None  # minimal tokenizers (test fakes) are unsized
    V = vocab_size if vocab_size is not None else size
    if V is None:
        raise ValueError(
            "tokenizer has no __len__; pass vocab_size explicitly")
    specials = set(getattr(tokenizer, "all_special_ids", None) or ())
    convert = getattr(tokenizer, "convert_ids_to_tokens", None)
    byte_dec = _gpt2_byte_decoder()
    out: List[bytes] = []
    for i in range(V):
        if i in specials or (size is not None and i >= size):
            out.append(b"")
            continue
        s = convert(i) if convert is not None else None
        if not isinstance(s, str):
            out.append(tokenizer.decode([i]).encode("utf-8"))
            continue
        m = _re.fullmatch(r"<0x([0-9A-Fa-f]{2})>", s)
        if m:
            out.append(bytes([int(m.group(1), 16)]))
        elif "▁" in s:  # sentencepiece's ▁ word-boundary space
            out.append(s.replace("▁", " ").encode("utf-8"))
        elif all(c in byte_dec for c in s):
            out.append(bytes(byte_dec[c] for c in s))
        else:
            out.append(s.encode("utf-8"))
    return out
