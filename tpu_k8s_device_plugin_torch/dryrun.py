"""The multi-device dry run: every parallel path of the port, one small
step each, on a process group of n ranks.

The counterpart of the repo root's ``__graft_entry__.dryrun_multichip``
(the JAX package's, which runs on n devices of one process): here every
rank of a ``torch.distributed`` group that the caller has initialised
calls :func:`dryrun_multichip`, and it runs, in the reference's order,

- one step of the data x model AlexNet (``workloads.parallel``);
- ring attention over every rank, einsum and flash, contiguous and
  zig-zag, the flash ring's gradients (K4 with its lse forward, K5 and
  K6 in their f32-output mode backward on CUDA);
- one step of the data x expert x seq x model LM (``make_lm_train_step``)
  with expert-parallel MoE FFNs where 8 ranks allow it;
- the GPipe pipeline of transformer blocks;
- tensor-parallel serving on the model axis: the engine exact against
  the single-device engine, the feature surface (prefix caching, sampling
  with penalties and ``min_p``, stop ids, logprobs, ``run_scan``),
  speculative decoding, LoRA adapters, int4 weights, the engine's
  speculative rounds and grammar-constrained decoding with
  ``jump_round``, each against its single-device run.

Rank 0 returns the one line that names each check (the others return it
too); a check that fails raises.  Shapes are the reference's, with head
dims of 16 where the flash kernels run (they take 16..128).

    python -m tpu_k8s_device_plugin_torch.dryrun --ranks 4 --device cpu

starts 4 ranks on gloo; under torchrun's environment each process is its
rank (NCCL on CUDA, one device a rank).
"""

from __future__ import annotations

import argparse
import os
import time

import torch


def _timed(fn, *args, sync) -> float:
    """Mean seconds of 5 calls after one warm call."""
    fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(5):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / 5


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


@torch.no_grad()
def _serving(device, model_par: int, f32, n_ranks: int) -> dict:
    """The tensor-parallel serving checks; what the line reports."""
    from .workloads import llama
    from .workloads.bench_serving import random_init_
    from .workloads.grammar import regex_to_dfa, token_dfa
    from .workloads.inference import (
        attach_lora,
        greedy_generate,
        make_decoder,
        quantize_lm_params_int4,
        shard_decoder,
    )
    from .workloads.serving import ServingEngine
    from .workloads.speculative import speculative_generate
    from .workloads.transformer import make_lm_mesh

    mesh = make_lm_mesh(seq=1, model=model_par, expert=1, device=device)
    srv_model = llama.decoder(llama.TINY_LLAMA, dtype=f32, max_len=64,
                              device=device)
    random_init_(srv_model, 11)
    prompt = [5, 17, 3, 70, 2]
    plain = ServingEngine(srv_model, n_slots=2, chunk=4, device=device)
    tp = ServingEngine(srv_model, n_slots=2, mesh=mesh, chunk=4,
                       device=device)
    sp, st = plain.admit(prompt), tp.admit(prompt)
    plain.run(4)
    tp.run(4)
    _check(plain.output(sp) == tp.output(st),
           "TP serving diverged from the single-device engine")
    tp.run_scan(4)
    info = {"steps": tp.stats()["tp_steps"], "replays": tp.graph_replays}

    feat = ServingEngine(srv_model, n_slots=2, mesh=mesh, chunk=4,
                         logprobs_k=3, auto_prefix_min=4, device=device)
    shared = [5, 17, 3, 70, 2, 9, 14, 21]
    f0 = feat.admit(shared + [33], stop=[7])
    f1 = feat.admit(shared + [44], temperature=0.9, top_k=16, top_p=0.9,
                    min_p=0.05, presence_penalty=0.5,
                    frequency_penalty=0.5, logprobs=2)
    _check(feat.stats()["prefix_cache_hits"] == 1, "TP APC missed")
    feat.run_scan(4)
    _check(len(feat.output(f0)) >= 1, "TP feature surface emitted nothing")
    lps = feat.token_logprobs(f1)
    _check(len(lps) == len(feat.output(f1))
           and all(len(top) == 2 for _, top in lps), "TP logprobs")

    spec_prompt = [5, 17, 3, 70]

    def decoder(seed, **kw):
        dims = dict(vocab=96, d_model=64, n_heads=4, n_layers=2, d_ff=128)
        dims.update(kw)
        m = make_decoder(max_len=64, dtype=f32, device=device, **dims)
        if seed is not None:
            random_init_(m, seed)
        return m

    tgt = decoder(0)
    drf = decoder(1, d_model=32, n_heads=2, n_layers=1, d_ff=64)
    want = greedy_generate(tgt, torch.tensor([spec_prompt]), 6)[0][0]
    want = [int(t) for t in want]
    spec_toks, accept = speculative_generate(
        shard_decoder(tgt, mesh), shard_decoder(drf, mesh), spec_prompt, 6,
        gamma=3)
    _check([int(t) for t in spec_toks] == want,
           "TP speculative decode diverged from single-device greedy")

    lora = decoder(None, n_adapters=2, lora_rank=4)
    lora.load_state_dict(attach_lora(tgt.state_dict(), lora, seed=2))
    lora_eng = ServingEngine(lora, n_slots=2, mesh=mesh, chunk=4,
                             max_new_tokens=6, device=device)
    l0 = lora_eng.admit(spec_prompt, adapter=1)
    l1 = lora_eng.admit(spec_prompt)
    lora_eng.run(8)
    _check(lora_eng.output(l0) == want and lora_eng.output(l1) == want,
           "TP fresh LoRA adapter is not a no-op")

    int4 = decoder(None, quantized="int4")
    int4.load_state_dict(quantize_lm_params_int4(tgt.state_dict()))
    i_plain = ServingEngine(int4, n_slots=1, chunk=4, device=device)
    i_tp = ServingEngine(int4, n_slots=1, mesh=mesh, chunk=4, device=device)
    i0, i1 = i_plain.admit(spec_prompt), i_tp.admit(spec_prompt)
    i_plain.run(5)
    i_tp.run(5)
    _check(i_plain.output(i0) == i_tp.output(i1),
           "TP int4 serving diverged from the single-device int4 engine")

    spec_eng = ServingEngine(tgt, n_slots=2, mesh=mesh, chunk=4,
                             max_new_tokens=6, draft=drf, gamma=3,
                             device=device)
    e0 = spec_eng.admit(spec_prompt)
    spec_eng.run_spec(8)
    _check(spec_eng.output(e0) == want,
           "TP engine speculative rounds diverged from greedy")

    table = [bytes([i]) if i else b"" for i in range(96)]
    pattern = "(AB|CD)+E"
    dfa = regex_to_dfa(pattern)
    gram_eng = ServingEngine(tgt, n_slots=2, mesh=mesh, chunk=4,
                             max_new_tokens=8, eos_id=0,
                             grammar=token_dfa(dfa, table, eos_id=0),
                             device=device)
    g0 = gram_eng.admit(spec_prompt, grammar=True)
    gram_eng.run_scan(4)
    gram_eng.run_scan(4)

    def in_grammar() -> bool:
        cur = 0
        for b in bytes(t for t in gram_eng.output(g0) if t):
            cur = int(dfa.table[cur, b])
            if cur < 0:
                return False
        return True

    _check(in_grammar(), "TP grammar-constrained decode left the grammar")
    if gram_eng.forced_pending():
        _check(gram_eng.jump_round() is not None and in_grammar(),
               "TP jump_round left the grammar")
    info["accept"] = accept
    return info


def dryrun_multichip(n_ranks: int, device=None) -> str:
    """Run every check on the default group (every rank calls this; its
    size must be *n_ranks*) on *device* (the current CUDA device unless
    ``"cpu"`` is given); the line naming each check, on every rank.
    Tensor-parallel serving reports its steps' mode: captured as CUDA
    graphs over NCCL, op by op over gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from .workloads import alexnet, parallel, transformer
    from .workloads import ring_attention as ra
    from .workloads.bench_serving import random_init_
    from .workloads.pipeline import make_pipeline, stack_layer_params

    if not dist.is_initialized():
        raise RuntimeError("dryrun_multichip needs an initialised "
                           "torch.distributed group")
    n = dist.get_world_size()
    if n != n_ranks:
        raise ValueError(f"need {n_ranks} ranks, the group has {n}")
    device = transformer.resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    f32 = torch.float32
    gen = torch.Generator().manual_seed(0)

    # the data x model AlexNet
    mesh = parallel.make_mesh(device=device)
    batch = parallel.mesh_shape(mesh)["data"] * 2
    model, opt = alexnet.create_train_state(
        seed=0, image_size=64, num_classes=16, learning_rate=0.01,
        dtype=f32, device=device)
    step, _, _, (img_sh, lbl_sh) = parallel.make_sharded_train_step(
        model, opt, mesh)
    images = torch.randn(batch, 64, 64, 3, generator=gen)
    labels = torch.randint(0, 16, (batch,), generator=gen)
    loss = float(step(img_sh.local(images.to(device)),
                      lbl_sh.local(labels.to(device))))
    _check(torch.isfinite(torch.tensor(loss)), f"non-finite loss {loss}")

    # ring attention over every rank: T split n ways
    shape = (2, 8 * n, 2, 16)
    q, k, v = (torch.randn(shape, generator=gen).to(device)
               for _ in range(3))
    ring_fn, sh = ra.make_ring_attention(None, causal=True)
    ql, kl, vl = (sh.scatter(x) for x in (q, k, v))
    attn = sh.gather(ring_fn(ql, kl, vl))
    _check(bool(torch.isfinite(attn).all()), "ring attention not finite")
    flash_fn, _ = ra.make_ring_attention(None, causal=True, impl="flash")
    _check(torch.allclose(sh.gather(flash_fn(ql, kl, vl)), attn, atol=1e-4),
           "flash ring differs from the einsum ring")
    leaves = [x.clone().requires_grad_() for x in (ql, kl, vl)]
    grads = torch.autograd.grad((flash_fn(*leaves) ** 2).sum(), leaves)
    _check(all(bool(torch.isfinite(g).all()) for g in grads),
           "flash ring gradients not finite")
    zz_fn, _ = ra.make_ring_attention(None, causal=True, layout="zigzag")
    qz, kz, vz = (sh.scatter(ra.zigzag_permute(x, n)) for x in (q, k, v))
    attn_zz = ra.zigzag_unpermute(sh.gather(zz_fn(qz, kz, vz)), n)
    _check(torch.allclose(attn_zz, attn, atol=2e-5),
           "zig-zag ring differs from the contiguous ring")
    t_contig = _timed(ring_fn, ql, kl, vl, sync=sync)
    t_zigzag = _timed(zz_fn, qz, kz, vz, sync=sync)

    # the data x expert x seq x model LM
    seq_par = 2 if n % 4 == 0 else 1
    model_par = 2 if n % 2 == 0 else 1
    expert_par = 2 if n % 8 == 0 else 1
    lm_mesh = transformer.make_lm_mesh(seq=seq_par, model=model_par,
                                       expert=expert_par, device=device)
    sizes = parallel.mesh_shape(lm_mesh)
    lm_step, lm_state, lm_place = transformer.make_lm_train_step(
        lm_mesh, vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
        seq_axis="seq" if seq_par > 1 else None,
        n_experts=2 * expert_par,
        batch=2 * sizes["data"] * sizes["expert"], seq_len=16 * seq_par)
    lm_loss = float(lm_step(*lm_place(*lm_state["batch"])))
    _check(torch.isfinite(torch.tensor(lm_loss)),
           f"non-finite LM loss {lm_loss}")
    if expert_par > 1:
        up = dict(lm_state["model"].named_parameters())[
            "block_0.moe.experts_up"]
        _check(up.shape[0] == 2, "expert stack not split on the expert axis")

    # GPipe: 2 blocks a stage over a data x pipe mesh
    pipe_par = 4 if n % 4 == 0 else 2 if n % 2 == 0 else 1
    pp_mesh = DeviceMesh(device.type, torch.arange(n).reshape(
        n // pipe_par, pipe_par), mesh_dim_names=("data", "pipe"))
    blk = transformer.Block(32, 4, 64, dtype=f32, device=device)
    per_layer = []
    for i in range(2 * pipe_par):
        random_init_(blk, 7 + i)
        per_layer.append({k: p.detach().clone()
                          for k, p in blk.named_parameters()})
    mb, T = 2 * (n // pipe_par), 16

    def block_layer(p, x):
        pos = torch.arange(x.shape[1], dtype=torch.int32,
                           device=x.device).expand(x.shape[:2])
        return torch.func.functional_call(blk, p, (x, pos))

    x0 = torch.randn(pipe_par, mb, T, 32, generator=gen).to(device)
    pp_apply, pp_params, pp_in = make_pipeline(
        pp_mesh, block_layer, stack_layer_params(per_layer))
    with torch.no_grad():
        pp_out = pp_apply(pp_params, pp_in.local(x0))
    _check(bool(torch.isfinite(pp_out).all()), "pipeline output not finite")

    srv = _serving(device, model_par, f32, n)
    sync()
    return (
        f"dryrun_multichip OK: mesh={parallel.mesh_shape(mesh)} "
        f"batch={batch} loss={loss:.4f}; ring attention over {n} ranks "
        f"seq={shape[1]} OK (einsum+flash impls, flash fwd+bwd); causal "
        f"step time contiguous={t_contig * 1e3:.2f}ms "
        f"zigzag={t_zigzag * 1e3:.2f}ms ({t_contig / t_zigzag:.2f}x); LM "
        f"dp+ep+sp+tp over {sizes} n_experts={2 * expert_par} "
        f"loss={lm_loss:.4f} OK; pipeline over "
        f"{parallel.mesh_shape(pp_mesh)} ({2 * pipe_par} blocks, "
        f"{pipe_par} stages) OK; TP serving engine over model={model_par} "
        f"exact vs single-device OK (steps {srv['steps']}, "
        f"{srv['replays']} graph replays); TP serving feature surface "
        f"(APC hit, sampled+penalties+min_p, stop, logprobs, run_scan) OK; "
        f"TP spec-decode exact vs greedy (accept={srv['accept']:.2f}) OK; "
        f"TP multi-LoRA (fresh-adapter no-op + mixed batch) OK; TP int4 "
        f"exact vs single-device OK; TP engine spec-decode rounds exact vs "
        f"greedy OK; TP grammar-constrained scan + jump_round stay "
        f"in-grammar OK")


def _rank(rank: int, n: int, port: int, device: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n)
    try:
        line = dryrun_multichip(n, device)
        if rank == 0:
            print(line, flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    """CLI: ``--ranks N`` processes on gloo (``--device cpu``), or, under
    torchrun's environment, this process as its rank (NCCL on CUDA)."""
    p = argparse.ArgumentParser(prog="dryrun")
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; cpu for gloo ranks)")
    args = p.parse_args(argv)
    if "RANK" in os.environ:
        import torch.distributed as dist

        cuda = args.device in (None, "cuda")
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if cuda else "gloo")
        try:
            line = dryrun_multichip(dist.get_world_size(), args.device)
            if dist.get_rank() == 0:
                print(line, flush=True)
        finally:
            dist.destroy_process_group()
        return 0
    if args.device not in ("cpu",):
        p.error("without torchrun's environment the ranks run on the CPU: "
                "pass --device cpu")
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(args.ranks, port, args.device), nprocs=args.ranks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
