"""The port's HTTP front door (``workloads/server.py``) against the JAX
package's, on the CPU.

One JAX ``EngineServer`` and one port ``EngineServer`` serve the same
tiny f32 decoder (vocab 128, d_model 64, 4 heads, 2 layers, d_ff 128,
``max_len`` 128, initialised by JAX from ``PRNGKey(0)`` and converted
with ``convert.params_from_jax``), each over a 2-slot paged engine with
eos 0, windows of 3 and a byte tokenizer with a chat template.  Every
scenario of ``tests/test_server.py`` posts the same payload to both and
holds the port's answer to the reference's: greedy ids, finish reasons
and text identical, logprobs within 1e-4, status codes and error
bodies equal.  Streams are compared as what they carry (the ids, the
text deltas joined, the terminal event), since a window's frame
boundaries depend on timing.  Sampled requests draw the port's own
counter-hash noise, so they are held to the reference's shape and to
their own reproducibility, not to its ids.

Port-only cases cover what needs the engine's internals (priority
order, the n > 1 head, shutdown drains), the stop contract of
``test_stop_match_ids_agree_with_text`` (which the reference fails),
and a prefill-only export that must leave the scheduler idle.
"""

import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin.workloads import server as jserver
from tpu_k8s_device_plugin.workloads.inference import make_decoder
from tpu_k8s_device_plugin.workloads.serving import ServingEngine as JEngine
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.workloads import inference as tinf
from tpu_k8s_device_plugin_torch.workloads import server as tserver
from tpu_k8s_device_plugin_torch.workloads.serving import ServingEngine

CFG = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128)
MAX_LEN = 128
EOS = 0
TB = [bytes([i]) if i else b"" for i in range(CFG["vocab"])]
LP_TOL = 1e-4


class _ByteTok:
    """1 byte == 1 token; ids < 128 fit the vocab."""

    def encode(self, s, **kw):
        return list(s.encode("latin-1"))

    def decode(self, ids, **kw):
        return bytes(int(t) % 256 for t in ids).decode("latin-1")

    def apply_chat_template(self, messages, tokenize=False,
                            add_generation_prompt=True):
        text = "".join(f"<{m['role']}>{m['content']}" for m in messages)
        return text + ("<assistant>" if add_generation_prompt else "")


@pytest.fixture(scope="module")
def models():
    jm = make_decoder(**CFG, max_len=MAX_LEN, dtype=jnp.float32)
    tokens = jnp.zeros((1, 8), jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8))
    params = jm.init(jax.random.PRNGKey(0), tokens, pos)["params"]
    tm = tinf.make_decoder(**CFG, max_len=MAX_LEN, dtype=torch.float32,
                           device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return (jm, params), tm


def _servers(models, **kw):
    (jm, params), tm = models
    ekw = dict(n_slots=2, logprobs_k=2, eos_id=EOS, kv_paging=True)
    skw = dict(max_new_tokens=8, window=3, tokenizer=_ByteTok(),
               token_bytes=TB)
    skw.update(kw)
    out = {"jax": jserver.EngineServer(JEngine(jm, params, **ekw), **skw),
           "torch": tserver.EngineServer(
               ServingEngine(tm, device="cpu", **ekw), **skw)}
    for srv in out.values():
        srv.start(host="127.0.0.1", port=0)
    return out


@pytest.fixture(scope="module")
def pair(models):
    srvs = _servers(models)
    yield srvs
    for srv in srvs.values():
        srv.stop()


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        data = None if body is None else (
            body if isinstance(body, (bytes, str)) else json.dumps(body))
        conn.request(method, path, data,
                     headers or {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.headers), resp.read()
    finally:
        conn.close()


def _close(a, b, path="$"):
    """Equal, with floats within LP_TOL."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)) \
            and abs(a - b) <= LP_TOL, f"{path}: {a} != {b}"
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), \
            f"{path}: keys {sorted(a)} != {sorted(b)}"
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), \
            f"{path}: {a} != {b}"
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def _strip(obj):
    """An OpenAI body without its per-request ``id`` and ``created``."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _native_view(status, raw):
    """What a /generate answer carries: the streamed ids (window frames
    and per-token events alike) by copy, the per-token events, the text
    deltas joined by copy, and the terminal (or only) event."""
    events = [json.loads(line) for line in raw.splitlines() if line.strip()]
    ids, text, per_token = {}, {}, []
    for e in events[:-1]:
        i = e.get("index", 0)
        if "tokens" in e:
            ids.setdefault(i, []).extend(e["tokens"])
        if "token" in e:
            ids.setdefault(i, []).append(e["token"])
            per_token.append(e)
        if "text" in e:
            text[i] = text.get(i, "") + e["text"]
    return dict(status=status, ids=ids, text=text, per_token=per_token,
                final=events[-1] if events else None)


def _sse_view(status, raw):
    """What an SSE answer carries: every chunk's choices joined by index
    (text or delta content, finish reasons, roles), the usage chunk and
    the terminal marker."""
    lines = [ln[6:] for ln in raw.decode().splitlines()
             if ln.startswith("data: ")]
    chunks = [json.loads(d) for d in lines if d != "[DONE]"]
    text, reasons, roles, usage, errors = {}, {}, {}, [], []
    for c in chunks:
        if "error" in c:
            errors.append(c)
            continue
        usage.append(c.get("usage", "absent"))
        for ch in c["choices"]:
            i = ch["index"]
            part = ch.get("text", ch.get("delta", {}).get("content", ""))
            text[i] = text.get(i, "") + (part or "")
            if ch.get("finish_reason"):
                reasons.setdefault(i, []).append(ch["finish_reason"])
            if "role" in ch.get("delta", {}):
                roles[i] = ch["delta"]["role"]
    objects = sorted({c.get("object") for c in chunks if "object" in c})
    return dict(status=status, text=text, reasons=reasons, roles=roles,
                usage=[u for u in usage if u not in (None, "absent")],
                errors=errors, objects=objects,
                done=bool(lines) and lines[-1] == "[DONE]")


def _error_view(raw):
    """An error body's shape: its keys, the OpenAI error type, the code.
    (The message may come from the engine, whose wording is the
    port's own.)"""
    body = json.loads(raw)
    err = body.get("error")
    return dict(keys=sorted(body), code=body.get("code"),
                type=err.get("type") if isinstance(err, dict) else None)


def _view(path, body, status, raw):
    if status != 200:
        return dict(status=status, body=_error_view(raw))
    if path == "/generate":
        return _native_view(status, raw)
    if body.get("stream"):
        return _sse_view(status, raw)
    return dict(status=status, body=_strip(json.loads(raw)))


def _both(pair, path, body):
    """The same request to both servers -> {side: view}."""
    return {tag: _view(path, body, *(lambda r: (r[0], r[2]))(
        _request(srv.port, "POST", path, body)))
        for tag, srv in pair.items()}


def _msgs(content="hi"):
    return [{"role": "user", "content": content}]


PROMPT = [3, 14, 15, 92, 65]
# the same prompt as text: its greedy continuation is
# [2, 82, 100, 89, 82, 86, 4, 86], "\x02RdYRV\x04V" (where "ab" only
# repeats one token), so stop strings land inside it
PSTR = "".join(map(chr, PROMPT))
LONG = list(range(1, 40))

# (name, path, body): greedy or deterministic requests, same answer
SCENARIOS = [
    ("stream", "/generate", {"tokens": PROMPT, "max_new_tokens": 8}),
    ("unary", "/generate", {"tokens": PROMPT, "stream": False}),
    ("per_token", "/generate", {"tokens": PROMPT, "per_token": True}),
    ("logprobs", "/generate", {"tokens": [5, 9, 3], "max_new_tokens": 4,
                               "logprobs": 2}),
    ("logprobs_unary", "/generate", {"tokens": [5, 9, 3], "logprobs": 1,
                                     "stream": False}),
    ("prompt_logprobs", "/generate", {"tokens": [5, 9, 3, 7],
                                      "max_new_tokens": 3,
                                      "prompt_logprobs": 2,
                                      "stream": False}),
    ("prompt_logprobs_n2", "/generate", {"tokens": LONG,
                                         "max_new_tokens": 2,
                                         "prompt_logprobs": 1, "n": 2,
                                         "stream": False}),
    ("stop_ids", "/generate", {"tokens": PROMPT, "stop": [104, 100]}),
    ("n2_greedy", "/generate", {"tokens": LONG, "max_new_tokens": 3,
                                "n": 2, "stream": False}),
    ("n2_stream", "/generate", {"tokens": PROMPT, "max_new_tokens": 4,
                                "n": 2}),
    ("penalties", "/generate", {"tokens": PROMPT, "presence_penalty": 0.5,
                                "frequency_penalty": 0.3,
                                "repetition_penalty": 1.3,
                                "stream": False}),
    ("logit_bias", "/generate", {"tokens": PROMPT,
                                 "logit_bias": {"97": 4.0, "98": 2.5},
                                 "stream": False}),
    ("min_tokens_stop_id", "/generate", {"tokens": PROMPT, "min_tokens": 3,
                                         "stop": [82]}),
    ("priority_slo_tenant", "/generate", {"tokens": PROMPT, "priority": 3,
                                          "slo_class": "interactive",
                                          "tenant": "acme"}),
    ("ignore_eos", "/generate", {"tokens": PROMPT, "ignore_eos": True,
                                 "max_new_tokens": 6}),
    ("guided_regex", "/generate", {"tokens": [1, 2, 3],
                                   "guided_regex": "(ab|cd)+e",
                                   "max_new_tokens": 8,
                                   "stream": False}),
    ("guided_choice", "/generate", {"prompt": "pick: ",
                                    "guided_choice": ["yes", "no"],
                                    "stream": False}),
    ("guided_json_schema", "/generate", {
        "prompt": "{", "max_new_tokens": 16, "stream": False,
        "guided_json": {"type": "object",
                        "properties": {"a": {"type": "integer"}},
                        "required": ["a"]}}),
    ("prompt_string", "/generate", {"prompt": "ab", "stream": False}),
    ("text_stream", "/generate", {"prompt": "ab"}),
    ("text_per_token", "/generate", {"prompt": "ab", "per_token": True}),
    ("stop_string", "/generate", {"prompt": PSTR, "stop": ["dY", "qq"],
                                  "stream": False}),
    ("stop_string_stream", "/generate", {"prompt": PSTR,
                                         "stop": ["YR", "qq"]}),
    ("stop_string_per_token", "/generate", {"prompt": PSTR,
                                            "stop": ["V\x04V"],
                                            "per_token": True}),
    ("mixed_stops", "/generate", {"prompt": PSTR, "stop": [86, "dY"],
                                  "stream": False}),
    ("mixed_stops_id_first", "/generate", {"prompt": PSTR,
                                           "stop": [100, "RV"]}),
    ("min_tokens_stop_string", "/generate", {"prompt": PSTR,
                                             "stop": ["R"],
                                             "min_tokens": 3,
                                             "stream": False}),
    ("min_tokens_stop_string_stream", "/generate", {"prompt": PSTR,
                                                    "stop": ["R"],
                                                    "min_tokens": 2}),
    ("detokenize_ids", "/generate", {"tokens": PROMPT, "detokenize": True,
                                     "stream": False}),
    # errors: the status and the body
    ("bad_empty", "/generate", {"tokens": []}),
    ("bad_type", "/generate", {"tokens": "abc"}),
    ("bad_bool_token", "/generate", {"tokens": [1, True]}),
    ("bad_too_long", "/generate", {"tokens": list(range(1, 130))}),
    ("bad_too_long_unary", "/generate", {"tokens": list(range(1, 130)),
                                         "stream": False}),
    ("bad_n", "/generate", {"tokens": [1, 2], "n": 0}),
    ("bad_logprobs_cap", "/generate", {"tokens": [1, 2], "logprobs": 9,
                                       "stream": False}),
    ("bad_stop", "/generate", {"tokens": [1, 2], "stop": "x"}),
    ("bad_min_tokens", "/generate", {"tokens": [1, 2], "min_tokens": 9}),
    ("bad_both_prompts", "/generate", {"tokens": [1], "prompt": "a"}),
    ("bad_two_guides", "/generate", {"tokens": [1], "guided_regex": "a",
                                     "guided_choice": ["b"]}),
    ("bad_regex", "/generate", {"tokens": [1], "guided_regex": "(a"}),
    ("bad_logit_bias", "/generate", {"tokens": [1],
                                     "logit_bias": {"x": 1}}),
    # OpenAI completions and chat
    ("oai_basic", "/v1/completions", {"model": "tiny", "prompt": "ab",
                                      "temperature": 0, "max_tokens": 8}),
    ("oai_token_array_stop", "/v1/completions", {
        "prompt": PROMPT, "temperature": 0, "max_tokens": 8,
        "stop": "dY"}),
    ("oai_sse_stop", "/v1/completions", {
        "prompt": PSTR, "temperature": 0, "max_tokens": 8,
        "stop": ["YR"], "stream": True}),
    ("oai_sse", "/v1/completions", {"prompt": "ab", "temperature": 0,
                                    "max_tokens": 8, "stream": True}),
    ("oai_echo", "/v1/completions", {"prompt": "ab", "temperature": 0,
                                     "max_tokens": 8, "echo": True}),
    ("oai_echo_sse_usage", "/v1/completions", {
        "prompt": "ab", "temperature": 0, "max_tokens": 8,
        "stream": True, "echo": True,
        "stream_options": {"include_usage": True}}),
    ("oai_echo_logprobs", "/v1/completions", {
        "prompt": "ab", "temperature": 0, "max_tokens": 4, "echo": True,
        "logprobs": 1}),
    ("oai_logprobs_0", "/v1/completions", {
        "prompt": "ab", "temperature": 0, "max_tokens": 4, "logprobs": 0}),
    ("oai_logprobs_2", "/v1/completions", {
        "prompt": "ab", "temperature": 0, "max_tokens": 4, "logprobs": 2}),
    ("oai_penalties_bias", "/v1/completions", {
        "prompt": "ab", "temperature": 0, "max_tokens": 6,
        "presence_penalty": 0.4, "frequency_penalty": 0.2,
        "logit_bias": {"99": 3.0}, "min_tokens": 2, "user": "u1",
        "service_tier": "batch"}),
    ("oai_json_object", "/v1/completions", {
        "prompt": "{", "temperature": 0, "max_tokens": 12,
        "response_format": {"type": "json_object"}}),
    ("oai_guided_regex", "/v1/completions", {
        "prompt": "x", "temperature": 0, "max_tokens": 8,
        "guided_regex": "(ab|cd)+e"}),
    ("oai_bad_stream_logprobs", "/v1/completions", {
        "prompt": "ab", "logprobs": 2, "stream": True}),
    ("oai_bad_stream_options", "/v1/completions", {
        "prompt": "ab", "max_tokens": 2,
        "stream_options": {"include_usage": True}}),
    ("oai_bad_prompt", "/v1/completions", {"prompt": 5}),
    ("oai_bad_response_format", "/v1/completions", {
        "prompt": "ab", "response_format": {"type": "yaml"}}),
    ("chat_unary", "/v1/chat/completions", {
        "model": "tiny", "messages": _msgs(), "temperature": 0,
        "max_tokens": 6}),
    ("chat_sse", "/v1/chat/completions", {
        "messages": _msgs(), "temperature": 0, "max_tokens": 6,
        "stream": True}),
    ("chat_logprobs_false", "/v1/chat/completions", {
        "messages": _msgs(), "temperature": 0, "max_tokens": 4,
        "logprobs": False}),
    ("chat_logprobs_true", "/v1/chat/completions", {
        "messages": _msgs(), "temperature": 0, "max_tokens": 4,
        "logprobs": True, "top_logprobs": 2}),
    ("chat_bad_echo", "/v1/chat/completions", {
        "messages": _msgs(), "echo": True}),
    ("chat_bad_messages", "/v1/chat/completions", {"messages": "hi"}),
]


@pytest.mark.parametrize("name,path,body", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_port_answers_as_reference(pair, name, path, body):
    got = _both(pair, path, body)
    _close(got["torch"], got["jax"])
    if got["jax"]["status"] == 200 and path == "/generate":
        final = got["jax"]["final"]
        assert final.get("done") is True
        choices = final.get("choices", [final])
        for c in choices:
            # the streamed surfaces agree with the final arrays
            if body.get("stream", True):
                assert got["jax"]["ids"][c.get("index", 0)] == c["tokens"]


@pytest.mark.parametrize("body", [
    {"tokens": [5, 9, 3], "max_new_tokens": 4, "n": 3, "temperature": 1.0,
     "top_k": 16},
    {"tokens": [5, 17, 3], "max_new_tokens": 5, "temperature": 1.0,
     "top_k": 16, "seed": 42, "stream": False},
    {"prompt": "ab", "max_tokens": 5, "temperature": 0.9, "seed": 3,
     "n": 2, "top_p": 0.9},
], ids=["n3_sampled", "seeded", "oai_sampled_n2"])
def test_sampled_answers_keep_reference_shape(pair, body):
    """Sampled draws are the port's own: each answer has the reference's
    shape (choices, lengths, indexes, finish reasons), a seeded request
    repeats itself exactly, and sampled siblings diverge."""
    path = "/v1/completions" if "prompt" in body else "/generate"
    first = _both(pair, path, body)
    again = _both(pair, path, body)

    def shape(v):
        fin = v.get("final") or v.get("body")
        chs = fin.get("choices", [fin])
        return [(c.get("index", 0), c["finish_reason"],
                 len(c["tokens"]) if "tokens" in c else len(c["text"]))
                for c in chs]

    assert shape(first["torch"]) == shape(first["jax"])
    if "seed" in body:
        _close(again["torch"], first["torch"])
    else:
        fin = first["torch"]["final"]
        assert len({tuple(c["tokens"]) for c in fin["choices"]}) > 1


# the port's scheduler's families that the reference has no counterpart
# of: the splice-to-first-token wait and the prompt tokens extended
PORT_ONLY_SAMPLES = {
    f"tpu_serve_first_token_wait_seconds{s}"
    for s in ("_bucket", "_sum", "_count")} | {
    "tpu_serve_prefill_chunk_tokens_total"}


@pytest.mark.parametrize("path", [
    "/healthz", "/stats", "/statz", "/metrics", "/alerts",
    "/debug/query?expr=rate(tpu_serving_requests_served_total[2s])",
    "/debug/query?expr=rate(", "/debug/traces", "/debug/events?since=x",
    "/debug/pprof?seconds=1&format=folded", "/debug/pprof?format=junk",
    "/debug/profile?seconds=1", "/debug/profile?seconds=x", "/nope"])
def test_get_surfaces_match_reference(pair, path):
    """Each GET surface answers with the reference's status and content
    type, and its JSON with the reference's keys (values that count
    traffic or time differ); /metrics carries the reference's families
    and, beyond them, only the port's own (``PORT_ONLY_SAMPLES``)."""
    got = {tag: _request(srv.port, "GET", path)
           for tag, srv in pair.items()}
    (js, jh, jb), (ts, th, tb) = got["jax"], got["torch"]
    assert ts == js and th.get("Content-Type") == jh.get("Content-Type")
    if path == "/metrics":
        from tpu_k8s_device_plugin import obs as jobs

        def names(body):
            return {n for n, _, _ in jobs.parse_exposition(body.decode())}

        assert names(tb) == names(jb) | PORT_ONLY_SAMPLES
    elif jh.get("Content-Type") == "application/json" and js == 200:
        jd, td = json.loads(jb), json.loads(tb)
        assert set(td) == set(jd)
        if path == "/statz":
            for k in ("migrations", "shed", "kv_tiers", "goodput",
                      "alerts"):
                assert set(td[k]) == set(jd[k]), k
    elif js != 200:
        assert tb == jb or json.loads(tb).keys() == json.loads(jb).keys()


def test_traces_and_headers_match_reference(pair):
    """A traceparent is continued: the answer echoes its trace id, the
    OpenAI id is ``cmpl-<trace id>``, and /debug/traces holds the same
    kinds of events for the request on both servers."""
    tid = "4bf92f3577b34da6a3ce929d0e0e4736"
    hdr = {"Content-Type": "application/json",
           "traceparent": f"00-{tid}-00f067aa0ba902b7-01"}
    kinds = {}
    for tag, srv in pair.items():
        status, headers, raw = _request(
            srv.port, "POST", "/v1/completions",
            {"prompt": "ab", "temperature": 0, "max_tokens": 4}, hdr)
        assert status == 200 and headers["X-Trace-Id"] == tid
        assert headers["traceparent"].startswith(f"00-{tid}-")
        assert json.loads(raw)["id"] == f"cmpl-{tid}"
        _, _, body = _request(srv.port, "GET",
                              f"/debug/traces?trace_id={tid}")
        kinds[tag] = {e["name"] for e in json.loads(body)["events"]}
    assert kinds["torch"] == kinds["jax"]
    assert {"tpu_serve_admit", "tpu_serve_request"} <= kinds["torch"]


# -- pure helpers: the port's and the reference's, on the same inputs -----

class _Utf8ByteTok:
    def decode(self, ids):
        return bytes(ids).decode("utf-8", errors="replace")


@pytest.mark.parametrize("text", ["héllo ✓ wörld", "plain ascii", "日本語"])
def test_detok_state_matches_reference(text):
    ids = list(text.encode("utf-8"))
    trail = {}
    for tag, mod in (("jax", jserver), ("torch", tserver)):
        st = mod._DetokState()
        steps = []
        for n in range(1, len(ids) + 1):
            st.feed(_Utf8ByteTok(), ids, n)
            steps.append((st.text, list(st.cum), st.prefix_off,
                          st.read_off))
        trail[tag] = steps
    assert trail["torch"] == trail["jax"]
    assert trail["torch"][-1][0] == text


@pytest.mark.parametrize("text,stops,scanned", [
    ("abcXYdef", ["XY"], 4), ("abcXYdef", ["XY"], 8),
    ("xABxyABz", ["AB"], 4), ("aaaa", ["aa"], 0), ("aaaa", ["aa"], 2),
    ("hello world", ["wor", "lo w"], 0), ("abc", ["zz"], 0),
    ("xyzxyz", ["yzx", "zx"], 3)])
def test_find_stop_and_holdback_match_reference(text, stops, scanned):
    got = {}
    for tag, mod in (("jax", jserver), ("torch", tserver)):
        st = mod._DetokState()
        st.text = text
        st.cum = list(range(len(text) + 1))
        got[tag] = (mod._find_stop(st, stops, scanned),
                    mod._holdback(text, stops),
                    mod._tokens_frame([1, 2, 3], 1, 2),
                    mod._tokens_frame([7], 0, 1), mod._usage(3, 4))
    assert got["torch"] == got["jax"]


# -- the port alone --------------------------------------------------------

def _tsolo(tm, prompt, n_steps):
    out, _ = tinf.greedy_generate(tm, np.asarray(prompt, np.int32)[None],
                                  n_steps)
    return np.asarray(out)[0].tolist()


def test_stop_match_ids_agree_with_text(models):
    """The stop contract of ``tests/test_server.py`` (ADVICE's third
    finding), held on the port: tokens run through the match-completing
    token, text is cut at the match start, and both come from the same
    match -- the first one that completes past the ``min_tokens``
    floor, found in the oracle's text."""
    _, tm = models
    srv = tserver.EngineServer(
        ServingEngine(tm, n_slots=2, logprobs_k=2, device="cpu"),
        max_new_tokens=8, window=3, tokenizer=_ByteTok())
    srv.start(host="127.0.0.1", port=0)
    try:
        tok = _ByteTok()
        text = tok.decode(_tsolo(tm, tok.encode("ab"), 8))
        stop = text[3:5]
        # the oracle: the first occurrence completing after token 2
        start = next(p for p in range(len(text))
                     if text.startswith(stop, p) and p + len(stop) > 2)
        keep = start + len(stop)
        status, _, raw = _request(srv.port, "POST", "/generate", {
            "prompt": "ab", "stop": [stop], "stream": False,
            "min_tokens": 2})
        ev = json.loads(raw)
        assert status == 200 and ev["finish_reason"] == "stop"
        assert len(ev["tokens"]) == keep        # through the completing one
        assert ev["text"] == text[:start]       # cut at the match start
        assert tok.decode(ev["tokens"]) == ev["text"] + stop
    finally:
        srv.stop()


def test_prefill_only_export_leaves_scheduler_idle(models):
    """A prefill-only request is answered with the migrate payload, and
    the scheduler then idles (it used to keep the exported ticket as
    waiting for its first step and spin)."""
    from tpu_k8s_device_plugin_torch.workloads import migrate

    _, tm = models
    srv = tserver.EngineServer(
        ServingEngine(tm, n_slots=2, kv_paging=True, device="cpu"),
        max_new_tokens=8, window=3)
    srv.start(host="127.0.0.1", port=0)
    try:
        status, headers, raw = _request(srv.port, "POST", "/generate", {
            "tokens": LONG, "prefill_only": True, "stream": False})
        assert status == 200
        assert headers["Content-Type"] == migrate.MIGRATE_CONTENT_TYPE
        assert migrate.load_payload(raw)["budget"] == 8
        deadline = time.monotonic() + 5
        while srv._sched.busy() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not srv._sched.busy()
        assert srv.statz()["migrations"] == {"out": 1, "in": 0}
    finally:
        srv.stop()


def test_priority_order_and_multi_completion_head(models):
    """Higher priority admits first, FIFO within a level; a strictly
    higher-priority arrival takes the slot from a partially admitted
    n > 1 request's remaining copies."""
    _, tm = models
    srv = tserver.EngineServer(ServingEngine(tm, n_slots=1, device="cpu"),
                               max_new_tokens=4)
    lo = srv._parse_request({"tokens": [1, 2], "priority": 0})
    hi = srv._parse_request({"tokens": [3, 4], "priority": 7})
    srv._enqueue(lo)
    srv._enqueue(hi)
    srv._admit_pending()
    assert hi.admitted == 1 and lo.admitted == 0
    assert srv.stats()["pending_requests"] == 1

    eng = ServingEngine(tm, n_slots=1, device="cpu")
    srv = tserver.EngineServer(eng, max_new_tokens=2, window=1)
    low = srv._parse_request({"tokens": [1, 2], "max_new_tokens": 2,
                              "n": 3})
    srv._enqueue(low)
    srv._admit_pending()
    assert low.admitted == 1 and srv._head is low
    hi = srv._parse_request({"tokens": [3, 4], "priority": 5})
    srv._enqueue(hi)
    eng.run(5)
    for slot, (req, idx) in list(srv._running.items()):
        srv._emit(slot, req, idx, eng.output(slot))
    srv._admit_pending()
    assert hi.admitted == 1 and low.admitted == 1
    assert srv._head is None and len(srv._pending) == 1


def test_resume_into_the_last_slot_defers_fresh_admissions(models):
    """A migrated checkpoint that resumes into the last free slot ends
    that round of intake: the fresh request queued behind it waits for a
    slot, and is not rejected with the engine's "no free slots"."""
    _, tm = models
    donor = ServingEngine(tm, n_slots=1, kv_paging=True, device="cpu")
    slot = donor.admit([1, 2, 3, 4], ignore_eos=True)
    donor.step()
    state = donor.preempt(slot)
    srv = tserver.EngineServer(
        ServingEngine(tm, n_slots=1, kv_paging=True, device="cpu"),
        max_new_tokens=8)
    moved = srv._parse_request({"tokens": [1, 2, 3, 4],
                                "ignore_eos": True})
    srv._attach_migration(moved, state, 8)
    srv._enqueue(moved)
    fresh = srv._parse_request({"tokens": [5, 6], "max_new_tokens": 4})
    srv._enqueue(fresh)
    srv._admit_pending()
    assert list(srv._running.values()) == [(moved, 0)]
    assert fresh.admitted == 0 and fresh.events.empty()
    assert srv.stats()["pending_requests"] == 1


def test_stop_drains_inflight_and_rejects_engine_budget(models):
    _, tm = models
    with pytest.raises(ValueError, match="per-request"):
        tserver.EngineServer(ServingEngine(tm, n_slots=1, max_new_tokens=4,
                                           device="cpu"))
    srv = tserver.EngineServer(ServingEngine(tm, n_slots=1, device="cpu"),
                               max_new_tokens=100, window=2)
    srv.start(host="127.0.0.1", port=0)
    result = {}

    def client():
        result["r"] = _request(srv.port, "POST", "/generate",
                               {"tokens": [1, 2, 3],
                                "max_new_tokens": 100})

    t = threading.Thread(target=client)
    t.start()
    deadline = time.monotonic() + 30
    while not srv._running and time.monotonic() < deadline:
        time.sleep(0.01)
    srv.stop()
    t.join(timeout=30)
    assert not t.is_alive()
    status, _, raw = result["r"]
    events = [json.loads(line) for line in raw.splitlines() if line]
    assert status == 200 and "error" in events[-1]


def test_parse_request_defaults():
    class FakeSrv(tserver.EngineServer):
        def __init__(self):
            self.default_max_new = 64
            self.max_events = 256

    req = FakeSrv()._parse_request({"tokens": [1, 2]})
    assert isinstance(req, tserver._Request)
    assert req.max_new_tokens == 64
    assert req.temperature == 0.0 and req.top_p == 1.0


def test_debug_profile_writes_a_trace(models, tmp_path):
    """/debug/profile captures a ``torch.profiler`` chrome trace into
    --profile-dir (CPU activities here), single-flight, bounded; the
    scheduler thread's phases show in it as ``serve.*`` ranges (an
    idle server waits under ``serve.idle``)."""
    _, tm = models
    srv = tserver.EngineServer(ServingEngine(tm, n_slots=1, device="cpu"),
                               max_new_tokens=4, profile_dir=str(tmp_path))
    srv.start(host="127.0.0.1", port=0)
    try:
        status, _, raw = _request(srv.port, "GET",
                                  "/debug/profile?seconds=0.2")
        out = json.loads(raw)
        assert status == 200 and out["profile_dir"] == str(tmp_path)
        with open(out["trace"]) as f:
            events = json.load(f)["traceEvents"]
        assert "serve.idle" in {e.get("name") for e in events}
        status, _, _ = _request(srv.port, "GET",
                                "/debug/profile?seconds=61")
        assert status == 400
        with srv._profile_lock:
            status, _, _ = _request(srv.port, "GET",
                                    "/debug/profile?seconds=0.1")
            assert status == 409
        assert "tpu_serve_profile_captures_total 1" in srv.render_metrics()
    finally:
        srv.stop()


def test_failed_capture_surfaces_as_the_requests_error(models):
    """No silent fallback: a decode window whose step capture fails
    crashes the iteration, the request riding it answers 503 with the
    error, the supervisor restarts the loop and the next request is
    served."""
    _, tm = models
    eng = ServingEngine(tm, n_slots=1, device="cpu")
    real, calls = eng.scan_dispatch, []

    def dispatch(*args, **kw):
        calls.append(args)
        if len(calls) == 1:
            raise RuntimeError("CUDA graph capture failed")
        return real(*args, **kw)

    eng.scan_dispatch = dispatch
    srv = tserver.EngineServer(eng, max_new_tokens=4, window=2)
    srv.start(host="127.0.0.1", port=0)
    try:
        status, _, raw = _request(srv.port, "POST", "/generate",
                                  {"tokens": [1, 2, 3], "stream": False})
        assert status == 503 and "crashed" in json.loads(raw)["error"]
        status, _, raw = _request(srv.port, "POST", "/generate",
                                  {"tokens": [1, 2, 3], "stream": False})
        assert status == 200 and len(json.loads(raw)["tokens"]) == 4
        assert srv._m_sched_crashes.value == 1 and srv.healthy()
        events = [e["name"] for e in srv.recorder.events()]
        assert "tpu_serve_scheduler_crash" in events
    finally:
        srv.stop()
