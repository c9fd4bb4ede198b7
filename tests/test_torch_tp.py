"""Tensor-parallel compute over "model" (``repro_torch.models.tp``) in one
process, with no process group: each rank's partials, summed in rank
order, against the whole block.

For reduced configs (float32) of each GQA kind, ``"dense"`` (llama3-8b
at n_kv_heads 4, 2 and 1), ``"moe"`` (arctic-480b: 4 experts, top 2, and
the dense residual whose d_ff splits), ``"enc"`` and ``"dec_cross"``
(whisper-large-v3) and ``"attn_local"`` (recurrentgemma-2b, one KV head,
a window of 16 under 24 positions), at M in {1, 2, 4}:

* ``split_layer`` (every split part's partials over r < M summed in rank
  order, the code each rank runs with ``TP(plan, r)``) equals
  ``apply_block`` on the whole weights within 1e-5 of max |y|;
* one backward (the gradient of sum(y * w)): each rank's gradient of its
  own weight blocks equals the whole gradient's block (KV heads that
  several ranks compute: the sum of their gradients), and the input's
  gradient the whole one, within 1e-5 of each one's max |g|;
* the plan itself: which parts split, each rank's heads.

The whole block is held to the reference by the other test modules
(``tests/test_torch_lm.py``, ``test_torch_whisper.py``,
``test_torch_recurrent.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import sharding
from repro_torch.models import tp as tpm
from repro_torch.models import transformer
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
B, T = 2, 24
CASES = {   # name: (arch, kind, changes to its reduced config)
    "dense_kv4": ("llama3-8b", "dense", {}),
    "dense_kv2": ("llama3-8b", "dense", {"n_kv_heads": 2}),
    "dense_kv1": ("llama3-8b", "dense", {"n_kv_heads": 1}),
    "moe_dense": ("arctic-480b", "moe", {}),
    "enc": ("whisper-large-v3", "enc", {}),
    "dec_cross": ("whisper-large-v3", "dec_cross", {}),
    "attn_local": ("recurrentgemma-2b", "attn_local", {}),
}
SIZES = [1, 2, 4]


def _case(name):
    arch, kind, changes = CASES[name]
    cfg = dataclasses.replace(get_arch(arch).reduced(), **changes)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(7),
                                     "cpu")
    block = next(b for k, b in zip(params.kinds, params.layers) if k == kind
                 ) if kind != "enc" else params.encoder[0]
    g = np.random.default_rng(3)
    x = torch.from_numpy(g.standard_normal((B, T, cfg.d_model)).astype(
        np.float32))
    w = torch.from_numpy(g.standard_normal((B, T, cfg.d_model)).astype(
        np.float32))
    enc = (torch.from_numpy(g.standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        if kind == "dec_cross" else None)
    pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    return cfg, kind, block, x, w, enc, pos


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_partials_sum_to_the_whole_block(name, size):
    cfg, kind, block, x, _, enc, pos = _case(name)
    plan = sharding.tp_plan(cfg, size)
    with torch.no_grad():
        want, _ = transformer.apply_block(kind, cfg, block, x, pos,
                                          enc_out=enc)
        got = tpm.split_layer(kind, cfg, block, x, pos, plan, enc_out=enc)
    assert _rel(got, want) <= TOL
    if size > 1:
        assert plan.attention == "split" and plan.mlp == "split"


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_gradients_are_the_whole_gradients_blocks(name, size):
    cfg, kind, block, x, w, enc, pos = _case(name)
    plan = sharding.tp_plan(cfg, size)
    whole = {n: p.detach().clone().requires_grad_()
             for n, p in block.named_parameters()}
    xw = x.clone().requires_grad_()
    y, _ = tpm.call_with(block, whole, lambda p: transformer.apply_block(
        kind, cfg, p, xw, pos, enc_out=enc))
    want = dict(zip(["x"] + list(whole), torch.autograd.grad(
        torch.sum(y * w), [xw] + list(whole.values()))))

    ranks = [tpm.rank_params(kind, block, plan, r, leaves=True)
             for r in range(size)]
    xs = x.clone().requires_grad_()
    y = tpm.split_layer(kind, cfg, block, xs, pos, plan, ranks, enc_out=enc)
    leaves = [(r, n, t) for r in range(size) for n, t in ranks[r].items()
              if tpm.param_block(kind, n, plan, r) is not None]
    got = torch.autograd.grad(torch.sum(y * w), [xs] + [t for *_, t in
                                                        leaves])
    assert _rel(got[0], want["x"]) <= TOL
    summed = {}
    for (r, n, _), g in zip(leaves, got[1:]):
        dim, start, length = tpm.param_block(kind, n, plan, r)
        whole_g = summed.setdefault(n, torch.zeros_like(want[n]))
        whole_g.narrow(dim, start, length).add_(g)
        if plan.kv != "computed" or not n.endswith(("wk", "wv")):
            assert _rel(g, want[n].narrow(dim, start, length)) <= TOL, \
                (r, n)
    for n, g in summed.items():
        assert _rel(g, want[n]) <= TOL, n
    if size > 1:   # the attention's blocks, and the MLP's or the residual's
        owners = {n.rsplit(".", 1)[0] for _, n, _ in leaves}
        assert "attn" in owners and owners & {"mlp", "ffn.dense"}, owners


@pytest.mark.parametrize("size", [2, 4, 16])
def test_the_plan_by_heads(size):
    llama = get_arch("llama3-8b")
    plan = sharding.tp_plan(llama, size)
    assert plan.attention == plan.mlp == plan.head == "split"
    assert plan.kv == ("split" if size <= 8 else "computed")
    assert [plan.q_heads(r) for r in range(size)] == [
        (r * 32 // size, 32 // size) for r in range(size)]
    if size == 16:   # two query heads a rank, one of 8 KV heads
        assert [plan.kv_heads(r) for r in range(16)] == [
            (r // 2, 1) for r in range(16)]
    assert sharding.tp_plan(llama, 1).splits is False
    # Heads that M does not divide stay whole; the MLP and head split.
    for arch in ("arctic-480b", "starcoder2-3b", "qwen2-vl-2b",
                 "whisper-large-v3", "recurrentgemma-2b"):
        p16 = sharding.tp_plan(get_arch(arch), 16)
        assert p16.attention == "replicated" and p16.mlp == "split", arch
    # MLA and the xLSTM cells have no GQA kind.
    assert sharding.tp_plan(get_arch("minicpm3-4b"), 16).attention == \
        "replicated"
    assert sharding.tp_plan(get_arch("xlstm-350m"), 4).attention == \
        "replicated"
