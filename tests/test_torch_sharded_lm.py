"""The sharded LM over torch.distributed, on the CPU over gloo.

Worlds of 2 ranks (meshes 2x1 and 1x2) and of 4 (2x2), each rank a
process of this file (``python tests/test_torch_sharded_lm.py RANK WORLD
INIT_FILE OUT_DIR``), spawned with a ``file://`` store and a hard timeout
as ``tests/test_torch_distributed.py`` spawns its worlds.  At ``reduced()``
size:

* training: olmo-1b (with remat) and mixtral-8x22b (4 experts, top 2,
  capacity factor 1.25, which drops copies), olmo-1b with one KV head
  and with 3 heads, and arctic-480b (mixtral's MoE plus a dense residual
  MLP, whose d_ff the model axis splits), train 2 steps through
  ``launch/train.py``'s ``train(mesh=...)`` with compression none and
  delta; each loss is within 1e-5 relative of the one-device run's (the
  test process runs it), every leaf of μ and ν within 1e-5 of its max
  |value|, and every parameter within 1e-5 of its leaf's max |value|.  Where the model axis
  splits the layers' products (1x2, 2x2: ``models/tp.py``) their sums
  run in another order, and Adam's first step moves a weight by lr·g /
  (|g| + eps): an element whose first gradient is not zero but lies below
  float32's rounding floor of its leaf's sums (``NOISE_FLOOR`` of the
  leaf's max |g|, the one-device run's first step) moves by a share of lr
  that rounding decides.  olmo-1b's ``units.b0_dense.mlp.w_gate[0, 56,
  33]`` is one: a first gradient of 3.1e-8 against the leaf's max of
  6.4e-2, where the one-device run through ``attention_ref`` in place of
  the flash op's plain version already puts the weight after two steps
  4.1e-6 from the flash path's, and the 1x2 mesh 1.4e-5 (1e-5 of the
  leaf's max: 5.7e-6); 3 to 7 elements a case lie there.  On those meshes
  such an element is held within 1e-5 of its leaf's max plus the most
  that AdamW's two updates can move it when each step's gradient moves by
  the Δg that the μ check admits (``_adam_bound``); every other element
  within 1e-5 of its leaf's max.
  Each rank reports the plan (which parts split, whether the KV heads
  split or each rank computes them) and the block of ``wq`` it computes
  with: H·Dh/M columns where M divides the heads.  Every rank's block of
  each parameter, μ and ν holds exactly numel / prod(sizes of the axes
  its spec names); one step given a hook that wraps
  ``make_gather_fn(mesh)`` gives the loss of the step's own gather, and
  the hook is called a layer at a time (again in remat's recomputation);
  at a capacity factor of E / k one step of mixtral through the a2a
  dispatch (EP, or TP on 1x2 with E = 3) gives sort's loss and first
  moment; a 1x2 run's checkpoint (whole tensors, rank 0 writes) resumes
  sharded and on one device to the straight run's losses;
* prefill on 1x2 with the attention, MLP and head split (llama3-8b with
  its KV heads split, and with one KV head that both ranks compute): the
  last logits, the cache and 4 teacher-forced decode steps from it against
  one device's; the vocab-parallel loss against ``cross_entropy`` with
  and without label smoothing, labels masked;
* the sort and one-hot dispatches on a batch split over "data" (2x2, at a
  capacity factor of 0.5) equal to the whole batch's on each rank's rows,
  the load-balancing terms summing to the whole batch's loss;
* ``reshard_tree``: a parameter tree moved 4x1 -> 2x2 -> 1x4 over the
  same 4 ranks keeps every whole value bit for bit;
* flash decoding on 2x2, the cache's slots sharded over "model" and its
  rows over "data": 4 teacher-forced steps within 1e-5 relative of the
  full decode, for llama3-8b (dense) and recurrentgemma-2b (its local
  attention's ring of 16 slots wrapped); the prefill through the ZeRO-3
  hook on parameters stored sharded within 1e-5 of the plain prefill;
* MoE's a2a dispatch in EP mode (2x2, E = 4) and TP mode (1x2, E = 3) at
  a capacity factor of 0.25, where copies drop, against the reference's
  a2a run once in a subprocess with 4 forced host devices on the same
  numpy-seeded inputs (nothing in ``repro`` changed): the same rows
  dropped whole, outputs within 1e-5 of max |y|, and the gradients of
  sum(y * w) with respect to x, the router and the expert weights within
  1e-4 of each one's max |g|.  EP takes its expert weights as DTensors,
  TP as whole tensors (each rank takes its block).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 120
MESHES = {2: ["2x1", "1x2"], 4: ["2x2"]}   # world -> its meshes
TRAIN_ARCHS = ["olmo-1b", "mixtral-8x22b"]
# Reduced configs whose heads the model axis of 2 splits otherwise: one KV
# head (each rank computes it for its query heads), and 3 heads (the
# attention replicated; the MLP and the head split); and arctic-480b, whose
# MoE blocks add a dense residual with its d_ff split.
TP_CASES = {"olmo-1b-kv1": ("olmo-1b", dict(n_kv_heads=1)),
            "olmo-1b-h3": ("olmo-1b", dict(n_heads=3, n_kv_heads=3)),
            "arctic-480b": ("arctic-480b", {})}
COMPRESSIONS = ["none", "delta"]
TRAIN = dict(steps=2, seq_len=16, global_batch=8, microbatches=2, lr=3e-3)
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5
DECODE_ARCHS = ["llama3-8b", "recurrentgemma-2b"]
DECODE = dict(batch=2, prompt=20, steps=4, max_len=32)
DECODE_RTOL = 1e-5
A2A = {"ep": dict(mesh="2x2", experts=4), "tp": dict(mesh="1x2", experts=3)}
A2A_SHAPE = (4, 16)          # B, T
A2A_CAPACITY = 0.25
Y_TOL = 1e-5
GRAD_TOL = 1e-4
# Prefill on 1x2 (llama3-8b reduced: KV heads split, and one KV head that
# both ranks compute), then teacher-forced decode from its cache.
TP_PREFILL = dict(batch=2, prompt=20, steps=4, max_len=32,
                  cases={"kv4": {}, "kv1": {"n_kv_heads": 1}})
TP_RTOL = 1e-5
VOCAB_LOSS_RTOL = 1e-6
# A first gradient below this share of its leaf's max |g| is float32's
# rounding of the products' sums (module docstring).
NOISE_FLOOR = 1e-6


def _mesh_shape(name: str) -> tuple:
    return tuple(int(x) for x in name.split("x"))


def _cfg(arch: str):
    from repro_torch.configs import get_arch
    return get_arch(arch).reduced()


def _train_cfg(name: str):
    """olmo-1b (and its TP_CASES) trains with remat (each layer gathered
    again in its recomputation), mixtral-8x22b without."""
    import dataclasses
    arch, changes = TP_CASES.get(name, (name, {}))
    return dataclasses.replace(_cfg(arch), remat=arch == "olmo-1b",
                               **changes)


def _a2a_cfg(mode: str, get_arch):
    import dataclasses
    return dataclasses.replace(get_arch("mixtral-8x22b").reduced(),
                               n_experts=A2A[mode]["experts"],
                               capacity_factor=A2A_CAPACITY)


def _a2a_inputs(mode: str) -> dict:
    """The a2a case's inputs from a numpy seed: x, the cotangent w, the
    MoE weights."""
    from repro_torch.configs import get_arch
    cfg = _a2a_cfg(mode, get_arch)
    g = np.random.default_rng(11 if mode == "ep" else 12)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    b, t = A2A_SHAPE

    def draw(*shape, scale=1.0):
        return (g.standard_normal(shape) * scale).astype(np.float32)
    return {"x": draw(b, t, d), "w": draw(b, t, d),
            "router": draw(d, e, scale=d ** -0.5),
            "w_gate": draw(e, d, f, scale=d ** -0.5),
            "w_up": draw(e, d, f, scale=d ** -0.5),
            "w_down": draw(e, f, d, scale=f ** -0.5)}


# ---------------------------------------------------------------------------
# The rank's side.
# ---------------------------------------------------------------------------

def _train_cases(mesh_name, out_dir, rank) -> dict:
    import math

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import axis_size, make_mesh
    from repro_torch.launch.train import train
    from repro_torch.train import train_step as tts
    from repro_torch.train.optimizer import AdamWConfig

    out = {}
    mesh = make_mesh(_mesh_shape(mesh_name), ("data", "model"), "cpu")

    def blocks_ok(tensors: dict, specs: dict) -> list:
        bad = []
        for name, t in tensors.items():
            axes = {a for e in specs[name] if e is not None
                    for a in ((e,) if isinstance(e, str) else e)}
            want = t.numel() // math.prod(axis_size(mesh, a) for a in axes)
            if sharding.local(t).numel() != want:
                bad.append(f"{name}: {sharding.local(t).numel()} of "
                           f"{t.numel()} (want {want})")
        return bad

    for arch in TRAIN_ARCHS + list(TP_CASES):
        cfg = _train_cfg(arch)
        tp = sharding.tp_of(cfg, mesh)
        for comp in COMPRESSIONS:
            res = train(cfg, TRAIN["steps"], seq_len=TRAIN["seq_len"],
                        global_batch=TRAIN["global_batch"], lr=TRAIN["lr"],
                        microbatches=TRAIN["microbatches"],
                        compression=comp, ckpt_every=0, mesh=mesh_name,
                        device="cpu", log=lambda *_: None)
            st = res.state
            specs = sharding.tree_specs(st.params, mesh)
            leaf_specs = sharding.leaf_specs(st.params, mesh)
            bad = blocks_ok(dict(st.params.named_parameters()), specs)
            bad += blocks_ok(st.opt.mu, leaf_specs)
            bad += blocks_ok(st.opt.nu, leaf_specs)
            sharded = sum(sharding.local(p).numel() < p.numel()
                          for p in st.params.parameters())
            stacked = tts.stacked_params(st.params)
            moments = {f"{key}/{k}": sharding.full(v) for key, tree in
                       (("mu", st.opt.mu), ("nu", st.opt.nu))
                       for k, v in tree.items()}
            if rank == 0:
                np.savez(Path(out_dir, f"train_{mesh_name}_{arch}_{comp}"
                                       f".npz"),
                         **{k: v.float().numpy() for k, v in
                            {**stacked, **moments}.items()})
            # The block of wq that this rank computes with.
            wq = tuple(sharding.tp_local(
                "dense", "attn.wq", sharding.gathered_layout(
                    st.params.layers[0].attn.wq), tp).shape)
            out[f"train/{mesh_name}/{arch}/{comp}"] = {
                "losses": res.losses, "blocks_bad": bad,
                "sharded_params": int(sharded),
                "plan": None if tp is None else tp.plan.record(),
                "kv": None if tp is None else tp.plan.kv,
                "wq_block": list(wq)}
        if arch not in TRAIN_ARCHS:
            continue

        # One step with and without a ZeRO-3 hook given, from one state;
        # the given hook counts its calls.
        batch = TokenPipeline(cfg.vocab, TRAIN["seq_len"],
                              TRAIN["global_batch"],
                              device="cpu").batch_at(0)
        losses, hints = {}, []

        def counted(obj, hint, gather=sharding.make_gather_fn(mesh)):
            hints.append(hint)
            return gather(obj, hint)
        for hooked in (False, True):
            tcfg = tts.TrainConfig(
                adamw=AdamWConfig(lr=TRAIN["lr"], warmup_steps=10,
                                  total_steps=TRAIN["steps"]),
                microbatches=TRAIN["microbatches"],
                gather_fn=counted if hooked else None)
            state = tts.shard_train_state(tts.init_train_state(
                cfg, tcfg, torch.Generator().manual_seed(0), "cpu"), mesh)
            _, metrics = tts.make_train_step(cfg, tcfg)(state, batch)
            losses[hooked] = float(metrics["loss"])
        losses["hints"] = {h: hints.count(h) for h in set(hints)}
        out[f"gather/{mesh_name}/{arch}"] = losses

    if mesh_name == "1x2":
        # A checkpoint of whole tensors at step 2 (rank 0 writes), and a
        # sharded resume from it to step 4.
        ckpt = str(Path(out_dir, "ckpt_1x2"))
        kw = dict(seq_len=TRAIN["seq_len"], global_batch=TRAIN["global_batch"],
                  lr=TRAIN["lr"], microbatches=TRAIN["microbatches"],
                  mesh=mesh_name, device="cpu", log=lambda *_: None,
                  ckpt_dir=ckpt)
        cfg = _train_cfg("olmo-1b")
        train(cfg, 2, ckpt_every=2, **kw)
        res = train(cfg, 4, ckpt_every=0, resume=True, **kw)
        out["resume/1x2"] = {"start": res.start_step, "losses": res.losses}

    # MoE training through the a2a dispatch (EP; TP on 1x2, E = 3) at a
    # capacity factor of E / k, where neither dispatch drops a copy: one
    # step equals the sort dispatch's.
    import dataclasses
    cfg = dataclasses.replace(_cfg("mixtral-8x22b"),
                              n_experts=3 if mesh_name == "1x2" else 4)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    steps = {}
    for strategy in ("sort", "a2a"):
        tcfg = tts.TrainConfig(
            adamw=AdamWConfig(lr=TRAIN["lr"], warmup_steps=10,
                              total_steps=TRAIN["steps"]),
            microbatches=TRAIN["microbatches"], moe_strategy=strategy)
        state = tts.shard_train_state(tts.init_train_state(
            cfg, tcfg, torch.Generator().manual_seed(0), "cpu"), mesh)
        state, metrics = tts.make_train_step(cfg, tcfg)(state, batch)
        steps[strategy] = (float(metrics["loss"]), {
            k: sharding.full(v) for k, v in state.opt.mu.items()})
    (loss_s, ms), (loss_a, ma) = steps["sort"], steps["a2a"]
    out[f"a2a_train/{mesh_name}"] = {
        "losses": [loss_s, loss_a],
        "mu_err": max(float((ma[k] - ms[k]).abs().max()
                            / ms[k].abs().max()) for k in ms)}
    return out


def _reshard_case(world) -> dict:
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tt
    from repro_torch.runtime import elastic
    from repro_torch.train.train_step import nest, stacked_params

    cfg = _cfg("olmo-1b")
    params = tt.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    tree = nest(stacked_params(params))

    def spec_fn(t, mesh):
        return sharding.tree_specs(t, mesh, "params")

    def flat(t, prefix=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items()
                    for k2, v2 in flat(v, f"{prefix}/{k}").items()}
        return {prefix: t}

    want = flat(tree)
    out, cur = {}, tree
    for shape in ((4, 1), (2, 2), (1, 4)):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        cur = elastic.reshard_tree(cur, mesh, spec_fn)
        got = flat(cur)
        same = all(torch.equal(sharding.full(got[k]), want[k]) for k in want)
        sharded = sum(sharding.local(got[k]).numel() < want[k].numel()
                      for k in want)
        out[f"reshard/{shape[0]}x{shape[1]}"] = {"same": same,
                                                 "sharded": int(sharded)}
    return out


def _decode_cases(rank) -> dict:
    import copy

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh, set_mesh
    from repro_torch.models import transformer as tt

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    d = mesh.get_local_rank("data")
    out = {}
    B, P_, n, L = (DECODE[k] for k in ("batch", "prompt", "steps",
                                      "max_len"))
    rows = slice(d * B // 2, (d + 1) * B // 2)
    for arch in DECODE_ARCHS:
        cfg = _cfg(arch)
        params = tt.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        tokens = TokenPipeline(cfg.vocab, P_ + n, B, seed=4,
                               device="cpu").batch_at(0)["tokens"]
        logits, cache = tt.prefill_forward(cfg, params, tokens[:, :P_], L)
        # The prefill with the ZeRO-3 hook on parameters stored sharded.
        stored = sharding.shard_params(copy.deepcopy(params), mesh)
        with torch.no_grad():
            hooked, _ = tt.prefill_forward(
                cfg, stored, tokens[:, :P_], L,
                gather_fn=sharding.make_gather_fn(mesh))
        shard = sharding.shard_cache(copy.deepcopy(cache), mesh, cfg)
        full, flash = [], []
        with torch.no_grad(), set_mesh(mesh):
            for i in range(P_, P_ + n):
                pos = torch.tensor(i)
                full.append(tt.decode_step(cfg, params, tokens[:, i:i + 1],
                                           cache, pos)[0])
                flash.append(tt.decode_step(cfg, params,
                                            tokens[rows, i:i + 1], shard,
                                            pos, flash_decode=True)[0])
        full = torch.cat(full, 1)[rows]
        flash = torch.cat(flash, 1)
        slots = shard["layers"][-1 if arch == "llama3-8b" else 2]["attn"][
            "k"].shape[2]
        out[f"decode/{arch}"] = {
            "err": float((full - flash).abs().max() / full.abs().max()),
            "local_slots": int(slots),
            "prefill_err": float((hooked - logits).abs().max()
                                 / logits.abs().max())}
    return out


def _tp_prefill_cases() -> dict:
    """Prefill through the hook on parameters stored on 1x2 (attention,
    MLP and head split over "model"), against one device's prefill: the
    last logits, each layer's cache (K/V heads gathered whole), then
    TP_PREFILL["steps"] teacher-forced decode steps from each cache."""
    import copy
    import dataclasses

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tt

    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    hook = sharding.make_gather_fn(mesh)
    B, P_, n, L = (TP_PREFILL[k] for k in ("batch", "prompt", "steps",
                                          "max_len"))
    out = {}
    for name, changes in TP_PREFILL["cases"].items():
        cfg = dataclasses.replace(_cfg("llama3-8b"), **changes)
        params = tt.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        stored = sharding.shard_params(copy.deepcopy(params), mesh)
        tokens = TokenPipeline(cfg.vocab, P_ + n, B, seed=4,
                               device="cpu").batch_at(0)["tokens"]
        with torch.no_grad():
            want, cache = tt.prefill_forward(cfg, params, tokens[:, :P_], L)
            got, tcache = tt.prefill_forward(cfg, stored, tokens[:, :P_], L,
                                             gather_fn=hook)
            leaves = [(c["attn"][k], t["attn"][k]) for c, t in zip(
                cache["layers"], tcache["layers"]) for k in ("k", "v",
                                                              "pos")]
            full, split = [], []
            for i in range(P_, P_ + n):
                pos = torch.tensor(i)
                full.append(tt.decode_step(cfg, params, tokens[:, i:i + 1],
                                           cache, pos)[0])
                split.append(tt.decode_step(cfg, stored,
                                            tokens[:, i:i + 1], tcache, pos,
                                            gather_fn=hook)[0])
        full, split = torch.cat(full, 1), torch.cat(split, 1)
        plan = sharding.tp_of(cfg, mesh).plan
        out[f"tp_prefill/{name}"] = {
            "kv": plan.kv, "attention": plan.attention,
            "logits_err": float((got - want).abs().max()
                                / want.abs().max()),
            "same_layout": all(a.shape == b.shape and a.dtype == b.dtype
                               for a, b in leaves),
            "pos_equal": all(torch.equal(a, b) for a, b in leaves[2::3]),
            "layer0_equal": all(torch.equal(a, b) for a, b in leaves[:2]),
            "cache_err": max(float((a - b).abs().max() / a.abs().max())
                             for a, b in leaves if a.is_floating_point()),
            "decode_err": float((split - full).abs().max()
                                / full.abs().max())}
    return out


def _vocab_loss_case() -> dict:
    """The vocab-parallel loss on 1x2 (each rank's half of the vocab)
    against ``cross_entropy`` on the whole logits, with and without label
    smoothing, a quarter of the labels masked: the loss and the gradient
    of the rank's logits."""
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import train_step as tts
    cfg = _cfg("olmo-1b")
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    tp = sharding.tp_of(cfg, mesh)
    start, n = tp.plan.block(cfg.vocab, tp.index)
    g = torch.Generator().manual_seed(5)
    logits = torch.randn(4, 16, cfg.vocab, generator=g) * 4
    labels = torch.randint(0, cfg.vocab, (4, 16), generator=g,
                           dtype=torch.int32)
    labels[torch.rand(4, 16, generator=g) < 0.25] = -1
    out = {}
    for smoothing in (0.0, 0.1):
        whole = logits.clone().requires_grad_()
        want = tts.cross_entropy(whole, labels, smoothing)
        (gw,) = torch.autograd.grad(want, [whole])
        part = logits[..., start:start + n].clone().requires_grad_()
        nll, count = tts._nll_sum(part, labels, smoothing, tp)
        got = nll / count
        (gp,) = torch.autograd.grad(got, [part])
        out[f"vocab_loss/{smoothing}"] = {
            "err": abs(float(got) - float(want)) / abs(float(want)),
            "grad_err": float((gp - gw[..., start:start + n]).abs().max()
                              / gw.abs().max()),
            "masked": int((labels < 0).sum())}
    return out


def _a2a_case(mode, out_dir, rank) -> dict:
    from torch.distributed.tensor import Replicate

    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh, set_mesh
    from repro_torch.models import moe

    cfg = _a2a_cfg(mode, get_arch)
    inp = {k: torch.from_numpy(v) for k, v in _a2a_inputs(mode).items()}
    mesh = make_mesh(_mesh_shape(A2A[mode]["mesh"]), ("data", "model"),
                     "cpu")
    dsize = mesh.size(0)
    d = mesh.get_local_rank("data")
    b = A2A_SHAPE[0] // dsize
    params = moe.MoE(cfg, "cpu")
    weights = {}
    for name in ("w_gate", "w_up", "w_down"):
        w = inp[name]
        if mode == "ep":       # stored whole on every rank, as DTensors
            w = sharding.distribute(w, mesh, [Replicate(), Replicate()])
        weights[name] = w.requires_grad_(True)
    router = inp["router"].clone().requires_grad_(True)
    x = inp["x"][d * b:(d + 1) * b].clone().requires_grad_(True)
    with set_mesh(mesh):
        y, _ = moe.moe_ffn(cfg, _Weights(router, weights), x, "a2a")
    loss = torch.sum(y * inp["w"][d * b:(d + 1) * b])
    gx, gr, *gw = torch.autograd.grad(
        loss, [x, router] + [weights[k] for k in ("w_gate", "w_up",
                                                  "w_down")])
    # Whole gradients: x's rows and the router's sum over the data axis
    # (each model rank holds them whole); the expert weights' DTensors
    # are whole, whole tensors hold this rank's block and sum over all.
    if dsize > 1:
        parts = [torch.empty_like(gx) for _ in range(dsize)]
        dist.all_gather(parts, gx.contiguous(), group=mesh.get_group("data"))
        gx = torch.cat(parts)
        dist.all_reduce(gr, group=mesh.get_group("data"))
    gw = [g.full_tensor() if sharding.is_dtensor(g) else g for g in gw]
    if mode == "tp":
        for g in gw:
            dist.all_reduce(g)
    ys = [torch.empty_like(y) for _ in range(dsize)]
    if dsize > 1:
        dist.all_gather(ys, y.contiguous(), group=mesh.get_group("data"))
    else:
        ys = [y]
    if rank == 0:
        np.savez(Path(out_dir, f"a2a_{mode}.npz"),
                 y=torch.cat(ys).detach().numpy(), x=gx.numpy(),
                 router=gr.numpy(),
                 **{k: g.numpy() for k, g in zip(("w_gate", "w_up",
                                                   "w_down"), gw)})
    return {f"a2a/{mode}": True}


def _split_dispatch_case() -> dict:
    """The sort and one-hot dispatches and the load-balancing loss on a
    batch split over the data axis of 2x2 against the whole batch on one
    rank (mixtral reduced at capacity factor 0.5: half the copies
    drop)."""
    import dataclasses

    from repro_torch.launch.mesh import make_mesh, set_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tt
    cfg = dataclasses.replace(_cfg("mixtral-8x22b"), capacity_factor=0.5)
    ffn = tt.init_params(cfg, torch.Generator().manual_seed(2),
                         "cpu").layers[0].ffn
    x = torch.randn(4, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rows = slice(2 * mesh.get_local_rank("data"),
                 2 * mesh.get_local_rank("data") + 2)
    out = {}
    with torch.no_grad():
        for strategy in ("sort", "onehot"):
            y, aux = moe.moe_ffn(cfg, ffn, x, strategy)
            with set_mesh(mesh, batch_split=True):
                y_l, aux_l = moe.moe_ffn(cfg, ffn, x[rows], strategy)
            out[f"split/{strategy}"] = {
                "err": float((y_l - y[rows]).abs().max() / y.abs().max()),
                "aux": [float(aux_l) * 2, float(aux)],
                "dropped": int((y.reshape(64, -1).abs().amax(-1) == 0)
                               .sum())}
    return out


class _Weights:
    """An MoE's weights as ``moe_ffn`` reads them."""

    def __init__(self, router, experts):
        self.router = router
        self.w_gate = experts["w_gate"]
        self.w_up = experts["w_up"]
        self.w_down = experts["w_down"]


def _rank_main(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_shard_group
    torch.set_num_threads(1)
    init_shard_group("gloo", f"file://{init_file}", world_size=world,
                     rank=rank)
    out, walls = {}, {}
    try:
        for mesh_name in MESHES[world]:
            t0 = time.perf_counter()
            out.update(_train_cases(mesh_name, out_dir, rank))
            walls[f"train/{mesh_name}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if world == 4:
            out.update(_reshard_case(world))
            out.update(_decode_cases(rank))
            out.update(_split_dispatch_case())
            out.update(_a2a_case("ep", out_dir, rank))
        else:
            out.update(_a2a_case("tp", out_dir, rank))
            out.update(_tp_prefill_cases())
            out.update(_vocab_loss_case())
        walls["rest"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    out["walls"] = walls
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


# ---------------------------------------------------------------------------
# The harness.
# ---------------------------------------------------------------------------

def spawn(world: int, tmp: Path, timeout: float = SPAWN_TIMEOUT_S) -> list:
    """Run ``world`` ranks of this file; -> each rank's findings.  Every
    rank is killed, and the test fails, once ``timeout`` seconds pass."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + os.environ.get("PYTHONPATH", "").split(
            os.pathsep)), OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(rank), str(world),
             str(tmp / "pg_init"), str(tmp)],
            stdout=log, stderr=subprocess.STDOUT, env=env))
        log.close()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tails = "".join(
        f"\n--- rank {r} (exit {p.returncode}) ---\n"
        + (tmp / f"rank{r}.log").read_text()[-3000:]
        for r, p in enumerate(procs) if p.returncode != 0)
    if tails:
        pytest.fail(f"world {world}: a rank failed or timed out{tails}")
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """world -> (each rank's findings, the world's directory), each world
    spawned once, when a test first asks for it."""
    cache = {}

    def get(world: int):
        if world not in cache:
            tmp = tmp_path_factory.mktemp(f"sharded{world}")
            cache[world] = (spawn(world, tmp), tmp)
        return cache[world]
    return get


def _world_of(mesh_name: str) -> int:
    return next(w for w, names in MESHES.items() if mesh_name in names)


TRAIN_MESHES = [m for names in MESHES.values() for m in names]


@pytest.fixture(scope="module")
def one_device():
    """{(arch, compression): (losses, stacked parameters, μ and ν, each
    leaf's first gradient |g| (from one step's ν))} of the one-device
    run."""
    from repro_torch.launch.train import train
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import stacked_params
    b2 = AdamWConfig().b2
    out = {}
    for arch in TRAIN_ARCHS + list(TP_CASES):
        for comp in COMPRESSIONS:
            runs = [train(_train_cfg(arch), steps, seq_len=TRAIN["seq_len"],
                          global_batch=TRAIN["global_batch"], lr=TRAIN["lr"],
                          microbatches=TRAIN["microbatches"],
                          compression=comp, ckpt_every=0, device="cpu",
                          log=lambda *_: None)
                    for steps in (TRAIN["steps"], 1)]
            res = runs[0]
            out[arch, comp] = (res.losses, {
                k: v.float().numpy()
                for k, v in stacked_params(res.state.params).items()}, {
                f"{key}/{k}": v.numpy() for key, tree in
                (("mu", res.state.opt.mu), ("nu", res.state.opt.nu))
                for k, v in tree.items()}, {
                k: np.sqrt(v.numpy() / (1 - b2))
                for k, v in runs[1].state.opt.nu.items()})
    return out


_REF_A2A = """
import sys, dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.models.moe import moe_ffn

mode, experts, mesh_name, cf, src, dst = sys.argv[1:7]
inp = dict(np.load(src))
cfg = dataclasses.replace(get_arch("mixtral-8x22b").reduced(),
                          n_experts=int(experts), capacity_factor=float(cf))
shape = tuple(int(v) for v in mesh_name.split("x"))
mesh = jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[
    :shape[0] * shape[1]],
    axis_types=(jax.sharding.AxisType.Auto,) * 2)
params = {k: jnp.asarray(inp[k]) for k in ("router", "w_gate", "w_up",
                                           "w_down")}
w = jnp.asarray(inp["w"])
jax.sharding.set_mesh(mesh)
with mesh:
    x = jax.device_put(jnp.asarray(inp["x"]),
                       NamedSharding(mesh, P("data", None, None)))

    def loss(p, x):
        y, _ = moe_ffn(cfg, p, x, "a2a")
        return jnp.sum(y * w), y
    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
np.savez(dst, y=np.asarray(y), x=np.asarray(gx),
         **{k: np.asarray(v) for k, v in gp.items()})
print("REF_A2A_OK")
"""


@pytest.fixture(scope="module")
def reference_a2a(tmp_path_factory):
    """{mode: the reference's a2a output and gradients}, one subprocess
    with 4 forced host devices a mode."""
    tmp = tmp_path_factory.mktemp("ref_a2a")
    out = {}
    for mode, case in A2A.items():
        src, dst = tmp / f"in_{mode}.npz", tmp / f"out_{mode}.npz"
        np.savez(src, **_a2a_inputs(mode))
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu")
        run = subprocess.run(
            [sys.executable, "-c", _REF_A2A, mode, str(case["experts"]),
             case["mesh"], str(A2A_CAPACITY), str(src), str(dst)],
            env=env, capture_output=True, text=True, timeout=300)
        assert run.returncode == 0 and "REF_A2A_OK" in run.stdout, \
            run.stderr[-3000:]
        out[mode] = dict(np.load(dst))
    return out


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("comp", COMPRESSIONS)
@pytest.mark.parametrize("arch", TRAIN_ARCHS + list(TP_CASES))
@pytest.mark.parametrize("mesh_name", TRAIN_MESHES)
def test_sharded_training_equals_one_device(worlds, one_device, mesh_name,
                                            arch, comp):
    found, tmp = worlds(_world_of(mesh_name))
    want_losses, want_params, want_moments, first_g = \
        one_device[arch, comp]
    cfg = _train_cfg(arch)
    m = _mesh_shape(mesh_name)[1]
    key = f"train/{mesh_name}/{arch}/{comp}"
    for r, f in enumerate(found):
        got = f[key]
        assert got["blocks_bad"] == [], (r, got["blocks_bad"])
        assert got["sharded_params"] > 0, r
        for a, b in zip(got["losses"], want_losses):
            assert abs(a - b) <= LOSS_RTOL * abs(b), (r, got["losses"],
                                                       want_losses)
        # The plan: on "model" of 2 the MLP and head split, and the
        # attention by whole heads where 2 divides them; wq's block the
        # rank's H / M heads.
        heads = cfg.n_heads // m if cfg.n_heads % m == 0 else cfg.n_heads
        assert got["wq_block"] == [cfg.d_model, heads * cfg.hd], got
        if m == 1:
            assert got["plan"] is None
        else:
            assert got["plan"] == {
                "attention": "split" if heads < cfg.n_heads else
                "replicated", "kv": "split" if cfg.n_kv_heads % m == 0
                else "replicated", "mlp": "split", "head": "split"}, got
            assert got["kv"] == ("replicated" if heads == cfg.n_heads else
                                 "split" if cfg.n_kv_heads % m == 0 else
                                 "computed")
    saved = dict(np.load(tmp / f"train_{mesh_name}_{arch}_{comp}.npz"))
    params = {k: v for k, v in saved.items() if "/" not in k}
    assert set(params) == set(want_params)
    for name, want in want_moments.items():
        err = np.abs(saved[name] - want).max()
        assert err <= PARAM_TOL * np.abs(want).max(), (name, err)
    # Every parameter; where the model axis splits products, the elements
    # whose first gradient lies below the noise floor within what AdamW
    # makes of the gradients' rounding (module docstring).
    for name, want in want_params.items():
        err = np.abs(params[name] - want)
        bound = np.full(want.shape, PARAM_TOL * np.abs(want).max())
        if m > 1:
            g = first_g[name].reshape(want.shape)
            floor = (g > 0) & (g < NOISE_FLOOR * g.max())
            bound[floor] += _adam_bound(
                g[floor], want_moments[f"mu/{name}"].reshape(want.shape)[
                    floor], want_moments[f"nu/{name}"].reshape(
                    want.shape)[floor], np.abs(want_moments[
                        f"mu/{name}"]).max())
        assert np.all(err <= bound), (name, err.max(),
                                      float((err / bound).max()))


def _adam_bound(g1, mu, nu, mu_max) -> np.ndarray:
    """The most that AdamW's two updates (``TRAIN``) move each element
    when each step's gradient moves by at most Δg = PARAM_TOL · ``mu_max``
    / (1 - b1), the change of one step's gradient that the μ check admits
    (``mu_max`` the leaf's max |μ|): ``g1`` = |the first gradient|, ``mu``
    and ``nu`` after step 2 (one device's), of the elements.  Step 1 moves
    an element by lr_1·g/(|g| + eps), which rises with g, so its change
    over |δ| <= Δg is the larger at the two ends; step 2 by lr_2·m̂/(√v̂ +
    eps), where m̂ (a mean of the two gradients) and √v̂ (their root mean
    square, weights summing to 1) each move by at most Δg, so its change
    is the largest at the four corners.  Weight decay's share (lr·wd
    times the weights' own difference) is left in PARAM_TOL."""
    import torch

    from repro_torch.launch.train import WARMUP_STEPS
    from repro_torch.train.optimizer import AdamWConfig, lr_schedule
    cfg = AdamWConfig(lr=TRAIN["lr"], warmup_steps=WARMUP_STEPS,
                      total_steps=TRAIN["steps"])
    lr1, lr2 = (float(lr_schedule(cfg, torch.tensor(s))) for s in (1, 2))
    g1, mu, nu = (np.asarray(a, np.float64) for a in (g1, mu, nu))
    dg = PARAM_TOL * float(mu_max) / (1 - cfg.b1)

    def f(g):
        return g / (np.abs(g) + cfg.eps)
    step1 = np.maximum(f(g1 + dg) - f(g1), f(g1) - f(g1 - dg))
    m_hat = mu / (1 - cfg.b1 ** 2)
    r_hat = np.sqrt(nu / (1 - cfg.b2 ** 2))
    u = m_hat / (r_hat + cfg.eps)
    step2 = np.max([np.abs((m_hat + a) / (np.maximum(r_hat + b, 0.0)
                                           + cfg.eps) - u)
                    for a in (-dg, dg) for b in (-dg, dg)], axis=0)
    return lr1 * step1 + lr2 * step2


def test_checkpoint_is_whole_and_resumes_anywhere(worlds):
    """A 1x2 run's checkpoint holds whole tensors in the reference's
    format: the sharded resume and a one-device resume from it give the
    straight one-device run's losses of steps 2 and 3 (within 1e-5)."""
    from repro_torch.launch.train import train
    found, tmp = worlds(2)
    kw = dict(seq_len=TRAIN["seq_len"], global_batch=TRAIN["global_batch"],
              lr=TRAIN["lr"], microbatches=TRAIN["microbatches"],
              device="cpu", log=lambda *_: None, ckpt_every=0)
    cfg = _train_cfg("olmo-1b")
    straight = train(cfg, 4, **kw).losses
    one = train(cfg, 4, ckpt_dir=str(tmp / "ckpt_1x2"), resume=True, **kw)
    assert one.start_step == 2
    for got in [one.losses] + [f["resume/1x2"]["losses"] for f in found]:
        assert len(got) == 2
        for a, b in zip(got, straight[2:]):
            assert abs(a - b) <= LOSS_RTOL * abs(b), (got, straight)
    assert all(f["resume/1x2"]["start"] == 2 for f in found)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
@pytest.mark.parametrize("mesh_name", TRAIN_MESHES)
def test_gather_fn_gives_the_same_loss(worlds, mesh_name, arch):
    """A given hook gives the loss of the step's own, and is called a
    layer at a time: once a layer a microbatch, again in each layer's
    recomputation under remat."""
    cfg = _train_cfg(arch)
    mb = TRAIN["microbatches"]
    want = {"embed": mb, "unit": cfg.n_layers * mb * (2 if cfg.remat else 1),
            "final_norm": mb}
    if not cfg.tie_embeddings:
        want["lm_head"] = mb
    found, _ = worlds(_world_of(mesh_name))
    for f in found:
        got = f[f"gather/{mesh_name}/{arch}"]
        assert abs(got["true"] - got["false"]) <= 1e-6 * abs(
            got["false"]), got
        assert got["hints"] == want, got


@pytest.mark.parametrize("mesh_name", TRAIN_MESHES)
def test_a2a_training_step_equals_sort(worlds, mesh_name):
    """At a capacity factor of E / k neither dispatch drops a copy, so a
    train step through a2a (its experts in the gathered layout) equals
    one through sort: the loss within 1e-5 relative, and μ after the step
    (a tenth of the clipped gradient) within 1e-5 of its max |value| on
    every leaf.  (Not the parameters: Adam's first step moves a weight by
    about lr whatever its gradient's size, so a gradient near zero that
    two summation orders round apart moves a weight by a whole step.)"""
    found, _ = worlds(_world_of(mesh_name))
    for f in found:
        got = f[f"a2a_train/{mesh_name}"]
        sort, a2a = got["losses"]
        assert abs(a2a - sort) <= LOSS_RTOL * abs(sort), got
        assert got["mu_err"] <= PARAM_TOL, got


def test_reshard_tree_keeps_every_value(worlds):
    found, _ = worlds(4)
    for f in found:
        for shape in ("4x1", "2x2", "1x4"):
            got = f[f"reshard/{shape}"]
            assert got["same"] and got["sharded"] > 0, (shape, got)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_flash_decode_on_a_sharded_cache(worlds, arch):
    found, _ = worlds(4)
    for f in found:
        got = f[f"decode/{arch}"]
        assert got["local_slots"] == (16 if arch == "llama3-8b" else 8)
        assert got["err"] <= DECODE_RTOL, got
        assert got["prefill_err"] <= DECODE_RTOL, got


@pytest.mark.parametrize("case", sorted(TP_PREFILL["cases"]))
def test_tp_prefill_and_decode_equal_one_device(worlds, case):
    """Prefill on 1x2 with the attention, MLP and head split: the last
    logits within 1e-5 of one device's; the cache in one device's layout
    (K/V heads whole, shapes and dtypes equal), its positions and layer
    0's K/V (the embedding's rows through the rank's columns of wk, wv)
    exactly equal, every layer's K/V within 1e-5 (the ranks' row-parallel
    sums round apart from one product from layer 1 on); decode from it
    within 1e-5."""
    found, _ = worlds(2)
    for f in found:
        got = f[f"tp_prefill/{case}"]
        assert got["attention"] == "split", got
        assert got["kv"] == ("split" if case == "kv4" else "computed"), got
        assert got["same_layout"] and got["pos_equal"], got
        assert got["layer0_equal"], got
        for key in ("logits_err", "cache_err", "decode_err"):
            assert got[key] <= TP_RTOL, (key, got)


@pytest.mark.parametrize("smoothing", ["0.0", "0.1"])
def test_vocab_parallel_loss_equals_cross_entropy(worlds, smoothing):
    found, _ = worlds(2)
    for f in found:
        got = f[f"vocab_loss/{smoothing}"]
        assert got["masked"] > 0
        assert got["err"] <= VOCAB_LOSS_RTOL, got
        assert got["grad_err"] <= VOCAB_LOSS_RTOL, got


@pytest.mark.parametrize("strategy", ["sort", "onehot"])
def test_dispatch_on_a_batch_split_over_data(worlds, strategy):
    """Capacity over the whole batch: each data rank's rows equal the whole
    batch's dispatch (tokens that lose every copy included), and the
    ranks' load-balancing terms sum to the whole batch's loss."""
    found, _ = worlds(4)
    for f in found:
        got = f[f"split/{strategy}"]
        assert got["dropped"] > 0, got
        assert got["err"] <= 1e-6, got
        assert abs(got["aux"][0] - got["aux"][1]) <= 1e-6 * got["aux"][1]


@pytest.mark.parametrize("mode", sorted(A2A))
def test_a2a_equals_the_reference(worlds, reference_a2a, mode):
    _, tmp = worlds(_world_of(A2A[mode]["mesh"]))
    got = dict(np.load(tmp / f"a2a_{mode}.npz"))
    want = reference_a2a[mode]
    b, t = A2A_SHAPE
    y, y_ref = got["y"].reshape(b * t, -1), want["y"].reshape(b * t, -1)
    dropped = ~(np.abs(y) > 0).any(-1)
    # The capacity factor drops copies: some tokens lose every copy.
    assert dropped.any()
    assert dropped.tolist() == (~(np.abs(y_ref) > 0).any(-1)).tolist()
    assert _rel(y, y_ref) <= Y_TOL
    for name in ("x", "router", "w_gate", "w_up", "w_down"):
        assert got[name].shape == want[name].shape, name
        assert _rel(got[name], want[name]) <= GRAD_TOL, name


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
