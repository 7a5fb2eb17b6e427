"""``apc_hit_share.chat``: the prefix cache's share of the prompt tokens
admitted in the window, on a synthetic record and on a tiny chat run."""

import pytest

from gpubench import spec


def _req(first, prompt_len, reused):
    return dict(rid=0, due=0.0, pull=0.0, first=first, done=None, times=[],
                prompt_len=prompt_len, reused=reused, n_out=1, caller=-1)


def test_share_of_the_windows_admissions():
    read = spec.reader("apc_hit_share.chat")
    run = dict(kind="serve", t0=10.0, t1=20.0, requests=[
        _req(9.0, 1000, 1000),       # first token before the window
        _req(12.0, 300, 256),
        _req(15.0, 100, 0),
        _req(20.0, 600, 256),        # the window's last instant counts
        _req(None, 500, 0),          # still admitting
        _req(21.0, 400, 400),        # after the window
    ])
    assert read(run) == pytest.approx(100.0 * 512 / 1000)
    run["requests"] = run["requests"][:1]
    assert read(run) is None
    assert read(dict(kind="train")) is None


def test_a_tiny_chat_run_reuses_its_system_prompts(tiny_tree):
    import torch

    from gpubench import serve

    cfg = spec.config("tiny", spec.benchmark())
    rec = serve.run(cfg, spec.mix("tchat"), 2**31 + 5, 1.5, False,
                    torch.device("cpu"), 0.0)
    share = spec.reader("apc_hit_share.chat")(rec)
    assert share is not None and 0.0 < share < 100.0
