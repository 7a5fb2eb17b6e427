"""The port's checkpoint/resume on torch state dicts, on the CPU.

Mirrors tests/test_checkpoint.py: the restored trajectory equals the
uninterrupted one, within one process and across a SIGKILL (save in a
subprocess that kills itself, restore in a fresh one); torn step dirs
are skipped; a crashed save leaves no step dir; multi-process saves
share one tmp dir and only rank 0 commits; a restored tree quantizes
and serves.  Then against the JAX package: a checkpoint the reference
wrote, restored there and converted, loads through the port's
``load_checkpoint_params`` into weights bit-equal to the reference's
(bf16, int8, int4) and greedy ids equal to its decoder's in f32; and the
server CLI's ``--checkpoint``.

Run as ``python tests/test_torch_checkpoint.py <mode> <base_dir>
<out_json> <threads>``, the file is the subprocess worker of the
cross-process test (imports neither JAX nor the JAX package):

  train-crash   2 train steps, save step_2, print "saved", SIGKILL itself
  resume        restore the latest checkpoint in a fresh process, 3 more
                steps, write the losses to <out_json>
"""

import functools
import json
import os
import shutil
import signal
import subprocess
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import torch_gloo_ranks  # noqa: E402

from tpu_k8s_device_plugin_torch.workloads import checkpoint as ckpt_mod  # noqa: E402,E501
from tpu_k8s_device_plugin_torch.workloads import llama  # noqa: E402
from tpu_k8s_device_plugin_torch.workloads.bench_serving import (  # noqa: E402,E501
    load_checkpoint_params,
    random_init_,
)
from tpu_k8s_device_plugin_torch.workloads.checkpoint import (  # noqa: E402
    latest_step,
    list_steps,
    optimizer_template,
    restore_checkpoint,
    save_checkpoint,
)
from tpu_k8s_device_plugin_torch.workloads.transformer import (  # noqa: E402
    lm_train_step,
    synthetic_lm_batch,
)

CFG = llama.TINY_LLAMA


def _setup():
    """TINY_LLAMA in f32 with random weights from seed 0, Adam(1e-3) and
    one batch of 4 x 16 tokens from seed 0 (the worker builds the
    same)."""
    model = llama.train_model(CFG, dtype=torch.float32, device="cpu")
    random_init_(model, 0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator()
    gen.manual_seed(0)
    batch = synthetic_lm_batch(gen, 4, 16, CFG.vocab)
    return model, opt, batch


def _state(model, opt):
    return {"params": model.state_dict(), "opt_state": opt.state_dict()}


def _template(model, opt):
    return {"params": model.state_dict(),
            "opt_state": optimizer_template(opt)}


def _resume(model, opt, restored):
    model.load_state_dict(restored["params"])
    opt.load_state_dict(restored["opt_state"])


def _run(model, opt, batch, n):
    return [float(lm_train_step(model, opt, *batch)) for _ in range(n)]


def _assert_params_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_resume_trajectory_identical(tmp_path):
    model, opt, batch = _setup()
    losses = _run(model, opt, batch, 5)
    # interrupted: 2 steps, save, "crash", restore into a fresh model
    model2, opt2, _ = _setup()
    _run(model2, opt2, batch, 2)
    save_checkpoint(str(tmp_path), 2, _state(model2, opt2))
    del model2, opt2
    model3, opt3, _ = _setup()
    _resume(model3, opt3,
            restore_checkpoint(str(tmp_path),
                               template=_template(model3, opt3)))
    np.testing.assert_array_equal(np.asarray(losses[2:]),
                                  np.asarray(_run(model3, opt3, batch, 3)))


def test_latest_and_gc(tmp_path):
    model, _, _ = _setup()
    params = model.state_dict()
    for s in (1, 3, 7):
        save_checkpoint(str(tmp_path), s, {"params": params})
    assert list_steps(str(tmp_path)) == [1, 3, 7]
    assert latest_step(str(tmp_path)) == 7
    save_checkpoint(str(tmp_path), 9, {"params": params}, keep_last=2)
    assert list_steps(str(tmp_path)) == [7, 9]
    restored = restore_checkpoint(str(tmp_path),
                                  template={"params": params})
    _assert_params_equal(restored["params"], params)


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"))
    model, _, _ = _setup()
    save_checkpoint(str(tmp_path), 2, {"params": model.state_dict()})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), step=5,
                           template={"params": model.state_dict()})


def test_cross_process_crash_resume(tmp_path):
    # the claim is CROSS-process: one interpreter trains and is
    # SIGKILLed right after the save (no atexit, no cleanup — a
    # preempted pod), a second fresh interpreter restores and
    # continues, and the trajectory must equal an uninterrupted run
    base = str(tmp_path / "ckpts")
    out = str(tmp_path / "resumed.json")
    args = [sys.executable, os.path.abspath(__file__)]
    threads = str(torch.get_num_threads())
    crash = subprocess.run(args + ["train-crash", base, out, threads],
                           capture_output=True, text=True, timeout=300)
    assert crash.returncode == -signal.SIGKILL, crash.stderr
    assert "saved" in crash.stdout
    resume = subprocess.run(args + ["resume", base, out, threads],
                            capture_output=True, text=True, timeout=300)
    assert resume.returncode == 0, resume.stderr
    with open(out) as f:
        data = json.load(f)
    assert data["start_step"] == 2
    # oracle: the uninterrupted 5-step run, in THIS process
    model, opt, batch = _setup()
    losses = _run(model, opt, batch, 5)
    np.testing.assert_array_equal(np.asarray(losses[2:]),
                                  np.asarray(data["losses"]))


def test_torn_checkpoints_skipped_not_fatal(tmp_path):
    """Torn/partial step dirs — an interrupted external copy, a
    truncated marker, an empty dir, truncated payloads — are SKIPPED by
    latest_step/list_steps/restore_checkpoint, never raised on; the
    newest WHOLE checkpoint wins."""
    model, _, _ = _setup()
    params = model.state_dict()
    for s in (1, 3):
        save_checkpoint(str(tmp_path), s, {"params": params})
    assert latest_step(str(tmp_path)) == 3

    # torn variant 1: an empty step dir (mkdir happened, nothing else)
    os.makedirs(tmp_path / "step_5")
    # torn variant 2: a truncated copy — every file cut to 1 byte,
    # the commit marker included (rsync died early)
    shutil.copytree(tmp_path / "step_3", tmp_path / "step_7")
    for root, _, files in os.walk(tmp_path / "step_7"):
        for name in files:
            with open(os.path.join(root, name), "r+b") as f:
                f.truncate(1)

    assert list_steps(str(tmp_path)) == [1, 3]
    assert latest_step(str(tmp_path)) == 3
    restored = restore_checkpoint(str(tmp_path),
                                  template={"params": params})
    _assert_params_equal(restored["params"], params)

    # torn variant 3: marker intact but payloads truncated — the marker
    # records their sizes, so the dir is torn as well
    shutil.copytree(tmp_path / "step_3", tmp_path / "step_9")
    for root, _, files in os.walk(tmp_path / "step_9"):
        for name in files:
            if name == ckpt_mod._METADATA:
                continue
            with open(os.path.join(root, name), "r+b") as f:
                f.truncate(1)
    assert list_steps(str(tmp_path)) == [1, 3]
    restored = restore_checkpoint(str(tmp_path),
                                  template={"params": params})
    _assert_params_equal(restored["params"], params)
    # an EXPLICIT step still addresses exactly what was asked for
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), step=4,
                           template={"params": params})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), step=9,
                           template={"params": params})


def test_restore_falls_back_over_unloadable_steps(tmp_path):
    """A structurally whole step that still fails — a payload that does
    not load at its recorded size, or a tree that is not the template's
    — makes the newest-first restore fall back to the next older step;
    an explicit step raises instead."""
    model, _, _ = _setup()
    params = model.state_dict()
    save_checkpoint(str(tmp_path), 1, {"params": params})
    # a newer step of another tree: its keys differ from the template's
    save_checkpoint(str(tmp_path), 2, {"params": {"w": torch.ones(3)}})
    # a newer step whose payload's last bytes (the zip directory) are
    # zeroed: the size holds, the load fails
    shutil.copytree(tmp_path / "step_1", tmp_path / "step_3")
    payload = tmp_path / "step_3" / ckpt_mod._payload_name(0)
    size = payload.stat().st_size
    with open(payload, "r+b") as f:
        f.seek(size - 64)
        f.write(bytes(64))
    assert list_steps(str(tmp_path)) == [1, 2, 3]
    step, restored = ckpt_mod.restore_latest(
        str(tmp_path), template={"params": params})
    assert step == 1
    _assert_params_equal(restored["params"], params)
    with pytest.raises(Exception):
        restore_checkpoint(str(tmp_path), step=3)
    with pytest.raises(ValueError, match="missing"):
        restore_checkpoint(str(tmp_path), step=2,
                           template={"params": params})
    # a shape or a dtype that differs raises as well
    bad = dict(params)
    bad["final_norm.scale"] = torch.ones(3)
    with pytest.raises(ValueError, match="final_norm.scale"):
        restore_checkpoint(str(tmp_path), step=1, template={"params": bad})
    bad["final_norm.scale"] = params["final_norm.scale"].to(torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        restore_checkpoint(str(tmp_path), step=1, template={"params": bad})


def test_save_commits_atomically(tmp_path, monkeypatch):
    """A crash mid-save must leave no step dir at all (the temp dir is
    the only casualty, swept by the next save) — the commit is the
    final rename."""
    model, _, _ = _setup()
    params = model.state_dict()
    real_write = ckpt_mod._write_payload
    calls = {"n": 0}

    def exploding_write(path, state):
        calls["n"] += 1
        real_write(path, state)
        raise RuntimeError("SIGKILL stand-in after the tree write")

    monkeypatch.setattr(ckpt_mod, "_write_payload", exploding_write)
    with pytest.raises(RuntimeError, match="SIGKILL stand-in"):
        save_checkpoint(str(tmp_path), 4, {"params": params})
    monkeypatch.setattr(ckpt_mod, "_write_payload", real_write)
    assert calls["n"] == 1
    assert list_steps(str(tmp_path)) == []
    assert not any(
        name.startswith("step_") for name in os.listdir(tmp_path)
    ), "no torn step dir may survive a crashed save"

    # the next save sweeps any leftover temp dir and lands whole
    (tmp_path / f"{ckpt_mod._TMP_PREFIX}orphan").mkdir()
    save_checkpoint(str(tmp_path), 4, {"params": params})
    assert list_steps(str(tmp_path)) == [4]
    assert not any(
        name.startswith(ckpt_mod._TMP_PREFIX)
        for name in os.listdir(tmp_path)
    ), "orphaned temp dirs must be swept"


def test_multihost_save_shares_tmp_and_gates_commit(tmp_path,
                                                    monkeypatch):
    """Multi-process saves (every rank on one shared volume): every
    process must write into ONE deterministic tmp dir, and only process
    0 may sweep orphans, commit the rename, and garbage-collect — a
    non-primary rank doing any of those would tear peers' in-flight
    saves."""
    model, _, _ = _setup()
    params = model.state_dict()
    barriers = []
    monkeypatch.setattr(ckpt_mod, "_process_count", lambda: 2)
    monkeypatch.setattr(ckpt_mod, "_barrier",
                        lambda name: barriers.append(name))
    orphan = tmp_path / f"{ckpt_mod._TMP_PREFIX}orphan"
    orphan.mkdir()

    # rank 1: writes its payload into the shared tmp name, nothing else
    monkeypatch.setattr(ckpt_mod, "_process_index", lambda: 1)
    save_checkpoint(str(tmp_path), 4, {"params": params}, keep_last=1)
    assert (tmp_path / f"{ckpt_mod._TMP_PREFIX}4").is_dir(), \
        "non-primary must write into the deterministic shared tmp dir"
    assert (tmp_path / f"{ckpt_mod._TMP_PREFIX}4"
            / ckpt_mod._payload_name(1)).is_file()
    assert not (tmp_path / "step_4").exists(), \
        "only process 0 commits the rename"
    assert orphan.is_dir(), "only process 0 sweeps orphans"
    assert barriers, "multi-process saves must fence on barriers"

    # rank 0: sweeps, commits, GCs
    monkeypatch.setattr(ckpt_mod, "_process_index", lambda: 0)
    save_checkpoint(str(tmp_path), 4, {"params": params}, keep_last=1)
    assert list_steps(str(tmp_path)) == [4]
    assert not orphan.exists()
    assert not any(
        name.startswith(ckpt_mod._TMP_PREFIX)
        for name in os.listdir(tmp_path)
    )


def test_quantize_after_restore_serves(tmp_path):
    # the serving handoff: restore a trained tree, quantize, decode
    from tpu_k8s_device_plugin_torch.workloads.inference import (
        greedy_generate, quantize_lm_params)

    model, _, _ = _setup()
    save_checkpoint(str(tmp_path), 0, {"params": model.state_dict()})
    restored = restore_checkpoint(
        str(tmp_path), template={"params": model.state_dict()})
    qp = quantize_lm_params(restored["params"])
    dec = llama.decoder(CFG, dtype=torch.float32, quantized=True,
                        max_len=32, device="cpu")
    dec.load_state_dict(qp)
    out, _ = greedy_generate(dec, [[1, 2, 3]], 4)
    assert tuple(out.shape) == (1, 4)


def test_shardings_raise_naming_item_6(tmp_path):
    """``shardings=`` (item 6.1) restores each leaf onto a mesh's
    placement, here the (1, 1) mesh of a gloo group of this process
    alone (``tests/test_torch_parallel.py`` holds the reference's two
    mesh restores on 8 ranks); ``load_checkpoint_params``'s ``mesh``
    (item 6.4, no longer raising) restores this rank's pieces of the
    serving model on a model axis of that one rank: every leaf equal to
    the meshless restore's, each projection ending in its collective
    (``tests/test_torch_tp_serving.py`` restores onto 2 ranks)."""
    from tpu_k8s_device_plugin_torch.workloads import parallel
    from tpu_k8s_device_plugin_torch.workloads.inference import (
        greedy_generate)
    from tpu_k8s_device_plugin_torch.workloads.transformer import (
        make_lm_mesh)

    model, _, _ = _setup()
    state = model.state_dict()
    with torch_gloo_ranks.solo_group():
        mesh = parallel.make_mesh(device="cpu")
        shardings = {"params": parallel.tree_shardings(mesh, state)}
        save_checkpoint(str(tmp_path), 0, {"params": state},
                        shardings=shardings)
        for step in (None, 0):
            restored = restore_checkpoint(str(tmp_path), step=step,
                                          template={"params": state},
                                          shardings=shardings)
            for key, value in state.items():
                assert torch.equal(restored["params"][key], value), key
        lm_mesh = make_lm_mesh(seq=1, model=1, expert=1, device="cpu")
        _, split = load_checkpoint_params("tiny", 64, False, str(tmp_path),
                                          device="cpu", mesh=lm_mesh)
        _, whole = load_checkpoint_params("tiny", 64, False, str(tmp_path),
                                          device="cpu")
        got, want = dict(split.named_parameters()), whole.state_dict()
        assert split.tp_size == 1 and got.keys() == want.keys()
        assert all(torch.equal(got[k], v) for k, v in want.items())
        assert split.block_0.out_proj.tp_mode == "row"
        assert torch.equal(
            greedy_generate(split, [[1, 2, 3]], 4)[0],
            greedy_generate(whole, [[1, 2, 3]], 4)[0])


def test_save_drains_the_device_first(tmp_path, monkeypatch):
    """The state is copied to the host only after the devices its
    tensors live on have synchronised, not by the copy's side effect;
    a CPU-only tree synchronises nothing."""
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)
    save_checkpoint(str(tmp_path), 0, {"w": torch.ones(2)})
    assert seen == []
    meta = json.loads((tmp_path / "step_0" / ckpt_mod._METADATA)
                      .read_text())
    assert meta["format"] == ckpt_mod._FORMAT_VERSION and meta["step"] == 0
    assert meta["leaves"] == [{"key": "w", "shape": [2],
                               "dtype": "float32"}]
    assert meta["payloads"] == {ckpt_mod._payload_name(0): (
        tmp_path / "step_0" / ckpt_mod._payload_name(0)).stat().st_size}


def test_restore_places_tensors_on_the_template_device(tmp_path):
    """Restored tensors land on the template tensor's device (a ``meta``
    template's restore onto the CPU); without a template, onto the CPU;
    the optimizer template is the state a step makes, and the real
    optimizer is not touched."""
    model, opt, batch = _setup()
    tmpl = optimizer_template(opt)
    assert opt.state_dict()["state"] == {}
    assert sorted(tmpl["state"][0]) == ["exp_avg", "exp_avg_sq", "step"]
    assert tmpl["state"][0]["exp_avg"].device.type == "meta"
    _run(model, opt, batch, 1)
    save_checkpoint(str(tmp_path), 1, _state(model, opt))
    restored = restore_checkpoint(str(tmp_path),
                                  template=_template(model, opt))
    assert restored["opt_state"]["state"][0]["exp_avg"].device.type == "cpu"
    assert restored["opt_state"]["param_groups"] == \
        opt.state_dict()["param_groups"]
    assert torch.equal(restored["opt_state"]["state"][0]["exp_avg"],
                       opt.state_dict()["state"][0]["exp_avg"])
    assert all(t.device.type == "cpu"
               for t in restore_checkpoint(str(tmp_path))["params"]
               .values())


def test_load_checkpoint_params_serves_real_weights(tmp_path):
    """The serving CLI's --checkpoint path: restore a train-layout
    checkpoint, (optionally) quantize on load, and decode — the bf16
    restore must reproduce the SOURCE weights' tokens exactly, and the
    quantized rungs must build the quantized layouts."""
    from tpu_k8s_device_plugin_torch.workloads.inference import (
        greedy_generate)

    train = llama.train_model(CFG, device="cpu")
    random_init_(train, 7)
    save_checkpoint(str(tmp_path), 3, {"params": train.state_dict()})
    source = llama.decoder(CFG, max_len=64, device="cpu")
    source.load_state_dict(train.state_dict())

    cfg, model = load_checkpoint_params("tiny", 64, False, str(tmp_path),
                                        device="cpu")
    assert cfg == CFG and model.quantized is False
    _assert_params_equal(model.state_dict(), source.state_dict())
    want, _ = greedy_generate(source, [[5, 17, 3]], 6)
    got, _ = greedy_generate(model, [[5, 17, 3]], 6)
    assert got.tolist() == want.tolist()

    for q in (True, "int4"):
        _, qmodel = load_checkpoint_params("tiny", 64, q, str(tmp_path),
                                           step=3, device="cpu")
        assert qmodel.quantized == q
        out, _ = greedy_generate(qmodel, [[5, 17, 3]], 4)
        assert tuple(out.shape) == (1, 4)


# --- against the JAX package -------------------------------------------

KINDS = {"bf16": False, "int8": True, "int4": "int4"}


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    """A checkpoint the reference wrote (TINY_LLAMA train-layout f32
    params from PRNGKey(7), its own save_checkpoint), restored with the
    reference, converted, and saved with the port's save_checkpoint:
    ``(reference dir, port dir)``."""
    import jax
    import jax.numpy as jnp

    from tpu_k8s_device_plugin.workloads import checkpoint as jckpt
    from tpu_k8s_device_plugin.workloads import llama as jllama
    from tpu_k8s_device_plugin_torch.convert import params_from_jax

    ref_dir = str(tmp_path_factory.mktemp("ref_ckpt"))
    port_dir = str(tmp_path_factory.mktemp("port_ckpt"))
    train = jllama.train_model(jllama.TINY_LLAMA)
    tokens = jnp.zeros((1, 8), jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8))
    params = train.init(jax.random.PRNGKey(7), tokens, pos)["params"]
    jckpt.save_checkpoint(ref_dir, 3, {"params": params})
    restored = jckpt.restore_checkpoint(
        ref_dir, template={"params": jax.eval_shape(lambda: params)})
    save_checkpoint(port_dir, 3,
                    {"params": params_from_jax(restored["params"])})
    return ref_dir, port_dir


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_load_checkpoint_params_matches_reference(reference_checkpoint,
                                                  kind, monkeypatch):
    """The port's load_checkpoint_params of the converted checkpoint
    gives the reference's load_checkpoint_params weights, converted, bit
    for bit (bf16 decoder; int8 and int4 quantized after the restore on
    both sides), and in f32 the reference decoder's greedy ids."""
    import jax.numpy as jnp

    from tpu_k8s_device_plugin.workloads import bench_serving as jbench
    from tpu_k8s_device_plugin.workloads import inference as jinf
    from tpu_k8s_device_plugin.workloads import llama as jllama
    from tpu_k8s_device_plugin_torch.convert import params_from_jax
    from tpu_k8s_device_plugin_torch.workloads.inference import (
        greedy_generate)

    ref_dir, port_dir = reference_checkpoint
    q = KINDS[kind]
    _, _, jparams = jbench.load_checkpoint_params("tiny", 64, q, ref_dir)
    want = llama.decoder(CFG, max_len=64, quantized=q, device="cpu")
    want.load_state_dict(params_from_jax(jparams))
    _, model = load_checkpoint_params("tiny", 64, q, port_dir, device="cpu")
    _assert_params_equal(model.state_dict(), want.state_dict())

    prompt = [[5, 17, 3, 200, 41]]
    jdec = jllama.decoder(jllama.TINY_LLAMA, max_len=64, quantized=q,
                          dtype=jnp.float32)
    jids, _ = jinf.greedy_generate(jdec, jparams, jnp.asarray(prompt), 8)
    # the same load into an f32 decoder
    monkeypatch.setattr(llama, "decoder", functools.partial(
        llama.decoder, dtype=torch.float32))
    _, model32 = load_checkpoint_params("tiny", 64, q, port_dir,
                                        device="cpu")
    ids, _ = greedy_generate(model32, prompt, 8)
    assert ids.tolist() == np.asarray(jids).tolist()


@pytest.mark.parametrize("quant", [[], ["--quantized"], ["--int4"]],
                         ids=["bf16", "int8", "int4"])
def test_server_cli_serves_a_checkpoint(tmp_path, monkeypatch, quant):
    """``server.main(["--checkpoint", DIR])`` builds its engine on the
    restored weights (quantized after the restore with --quantized /
    --int4); a missing checkpoint and --checkpoint-step without
    --checkpoint are usage errors."""
    from tpu_k8s_device_plugin_torch.workloads import server as tserver

    train = llama.train_model(CFG, device="cpu")
    random_init_(train, 3)
    save_checkpoint(str(tmp_path), 5, {"params": train.state_dict()})
    built = {}

    class Started(Exception):
        pass

    def start(self, host, port):
        built["engine"] = self.engine
        raise Started

    monkeypatch.setattr(tserver.EngineServer, "start", start)
    base = ["--config", "tiny", "--device", "cpu", "--max-len", "64"]
    with pytest.raises(Started):
        tserver.main(base + quant + ["--checkpoint", str(tmp_path),
                                     "--checkpoint-step", "5"])
    eng = built["engine"]
    q = {"--quantized": True, "--int4": "int4"}.get(
        quant[0] if quant else None, False)
    _, want = load_checkpoint_params("tiny", 64, q, str(tmp_path),
                                     device="cpu")
    _assert_params_equal(eng.model.state_dict(), want.state_dict())
    s = eng.admit([1, 2, 3])
    eng.step()
    assert len(eng.output(s)) >= 2
    for bad in (["--checkpoint", str(tmp_path / "none")],
                ["--checkpoint", str(tmp_path), "--checkpoint-step", "4"],
                ["--checkpoint-step", "5"]):
        with pytest.raises(SystemExit) as e:
            tserver.main(base + quant + bad)
        assert e.value.code == 2


def _worker() -> None:
    mode, base, out, threads = sys.argv[1:5]
    torch.set_num_threads(int(threads))
    model, opt, batch = _setup()
    if mode == "train-crash":
        _run(model, opt, batch, 2)
        save_checkpoint(base, 2, _state(model, opt))
        print("saved", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)  # no clean shutdown at all
    elif mode == "resume":
        start = latest_step(base)
        _resume(model, opt,
                restore_checkpoint(base, template=_template(model, opt)))
        losses = _run(model, opt, batch, 3)
        with open(out, "w") as f:
            json.dump({"start_step": start, "losses": losses}, f)
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    _worker()
