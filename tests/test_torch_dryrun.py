"""The dry run (``repro_torch.launch.dryrun``) against the reference's
record and against arithmetic.

* ``input_specs`` equals the reference's on all 40 cells, read in a
  subprocess: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512
  host devices, and every other test here sees one device.
* ``argument_size_in_bytes`` of every non-skipped train and decode cell on
  16 x 16, and of two cells on 2 x 16 x 16, equals the reference's
  per-device bytes: each leaf of ``jax.eval_shape(init_params)``, of
  AdamW's float32 μ and ν and int32 step, and of the batch (or the
  ``init_cache`` cache, the token and its position) divided by the sizes
  of the axes its spec names (``tree_specs``, ``batch_spec``,
  ``cache_tree_specs`` under the reference test's ``FakeMesh`` stand-ins).
* FLOPs: reduced olmo-1b's step on fake worlds of 1 and 4 ranks over
  "data" reads the same FLOPs x devices; full-width olmo-1b ``train_4k``
  on (16, 1) reads the ``useful_ratio`` that remat and the flash formulas
  predict, and on (16, 16), its heads, d_ff and vocab split over "model"
  (``models/tp.py``), exactly a sixteenth of those FLOPs; reduced olmo-1b
  with one KV head on (2, 2) reads (1, 1)'s FLOPs / 4 plus the KV
  projections that both model ranks compute.
* The flash custom ops under ``FakeTensorMode`` on fake CUDA tensors give
  the kernels' shapes and dtypes, launching nothing; the step's FLOPs
  through the ops less those through ``ref.py`` are what the formulas say.
  A CPU-only torch cannot build an autograd node on a fake CUDA tensor
  (the node asks the CUDA device guard for a stream), so the step cases
  route fake CPU tensors to the ops (``ops.on_card``, monkeypatched).
* Collective bytes on a fake (2, 1) world: the ZeRO-3 gathers and their
  reduce-scatters, summed from the port's parameter list; on (2, 2), the
  all-reduces over "model" (5 a layer with remat) and "data".
* The same step counted on real CPU tensors in a gloo world of one and on
  fake ones reads the same FLOPs, bytes, collectives and argument bytes.
* The fake-tensor paths: MoE at capacity, xLSTM's one trip.
* The reference's slow entry-point test, ported: the CLI on olmo-1b
  ``decode_32k`` with ``--device cpu``, and ``roofline.main`` on its
  output.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import pytest
import torch

from repro_torch.configs import SHAPES, Shape, cells, get_arch
from repro_torch.kernels.flash_attention import ops
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import sharding as tshard
from repro_torch.models import transformer
from torch_threads import one_torch_thread  # noqa: F401

SRC = str(Path(__file__).resolve().parents[1] / "src")
CLI_TIMEOUT = 300

REF_SPECS = """
import json
from repro.configs import cells
from repro.launch.dryrun import input_specs
print(json.dumps({f"{a}|{s}": {k: [list(v.shape), str(v.dtype)]
                              for k, v in input_specs(a, s).items()}
                  for a, s, _ in cells()}))
"""


def _small(arch="olmo-1b", **kw):
    return dataclasses.replace(get_arch(arch).reduced(), **kw)


def _trace(cfg, shape, mesh_shape, opt_level=0, microbatches=1):
    with dryrun.fake_world(mesh_shape, ("data", "model"), "cpu") as (m, _):
        cell = dryrun.build_cell(cfg, shape, m, opt_level, "cpu",
                                 microbatches=microbatches)
        got = dryrun.trace(cell.fn, cell.args)
        got.pop("out")
    return got


# ---------------------------------------------------------------------------
# input_specs.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_input_specs():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_SPECS], env=env,
                         capture_output=True, text=True, timeout=CLI_TIMEOUT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in cells()])
def test_input_specs_match_the_reference(ref_input_specs, arch, shape):
    got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
           for k, v in dryrun.input_specs(arch, shape).items()}
    assert got == ref_input_specs[f"{arch}|{shape}"]
    assert "XLA_FLAGS" not in os.environ or \
        "512" not in os.environ["XLA_FLAGS"]


# ---------------------------------------------------------------------------
# Argument bytes against the reference's specs.
# ---------------------------------------------------------------------------

def _leaf_bytes(shape, itemsize, spec, axes: dict) -> int:
    n = math.prod(shape) * itemsize
    for entry in spec:
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                assert n % axes[ax] == 0
                n //= axes[ax]
    return n


def _tree_bytes(tree, specs, axes) -> int:
    import jax
    from jax.sharding import PartitionSpec
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return sum(_leaf_bytes(x.shape, x.dtype.itemsize, s, axes)
               for x, s in zip(leaves, spec_leaves))


def _reference_argument_bytes(arch, shape_name, multi_pod) -> int:
    """The reference's per-device bytes of a train or decode cell's
    inputs, from its specs (module docstring)."""
    import jax
    from repro.configs import get_arch as j_get_arch
    from repro.launch.sharding import (batch_spec, cache_tree_specs,
                                       tree_specs)
    from repro.models import transformer as jt
    from repro.train.optimizer import adamw_init
    from test_sharding_roofline import FakeMesh, FakeMeshPod
    mesh = FakeMeshPod() if multi_pod else FakeMesh()
    axes = mesh.shape
    cfg = j_get_arch(arch)
    shape = SHAPES[shape_name]
    params = jax.eval_shape(partial(jt.init_params, cfg),
                            jax.random.PRNGKey(0))
    p_specs = tree_specs(params, mesh, "params")
    total = _tree_bytes(params, p_specs, axes)
    specs = dryrun.input_specs(arch, shape_name)
    if shape.kind == "train":
        opt = jax.eval_shape(adamw_init, params)
        total += _tree_bytes(opt.mu, p_specs, axes)
        total += _tree_bytes(opt.nu, p_specs, axes)
        total += opt.step.dtype.itemsize            # replicated, P()
        batch = specs
    else:
        cache = jax.eval_shape(partial(jt.init_cache, cfg,
                                       shape.global_batch, shape.seq_len))
        total += _tree_bytes(cache, cache_tree_specs(cache, mesh, "cache"),
                             axes)
        batch = {"token": specs["token"]}
        total += 4                                  # pos, int32[]
    for spec in batch.values():
        itemsize = torch.empty((), dtype=spec.dtype).element_size()
        total += _leaf_bytes(spec.shape, itemsize,
                             batch_spec(spec.shape, mesh), axes)
    return total


ARG_CELLS = [(a, s, False) for a, s, skip in cells()
             if not skip and SHAPES[s].kind in ("train", "decode")] + [
    ("olmo-1b", "train_4k", True), ("llama3-8b", "decode_32k", True)]


@pytest.mark.parametrize(
    "arch,shape,multi_pod", ARG_CELLS,
    ids=[f"{a}-{s}-{'2x16x16' if p else '16x16'}" for a, s, p in ARG_CELLS])
def test_argument_bytes_equal_the_reference(arch, shape, multi_pod):
    sizes, axes = dryrun.production_shape(multi_pod)
    with dryrun.fake_world(sizes, axes, "cpu") as (mesh, _):
        cell = dryrun.build_cell(arch, shape, mesh, 0, "cpu")
        got = dryrun.argument_bytes(cell.args)
    assert got == _reference_argument_bytes(arch, shape, multi_pod)


# ---------------------------------------------------------------------------
# FLOPs.
# ---------------------------------------------------------------------------

STEP = Shape("step", 32, 8, "train")


def test_kv_heads_each_rank_computes_are_counted_twice():
    """Reduced olmo-1b with one KV head (remat) on (2, 2) against (1, 1):
    the model axis splits the query heads, d_ff and vocab, and each rank
    computes the one KV head whole, so 4 x (2, 2)'s FLOPs are (1, 1)'s plus
    the KV projections' once more: K = layers x 2 products (k, v) x 2 N D
    Dh (N tokens) x 4 (forward, remat's recomputation, and the backward's
    input and weight gradients)."""
    cfg = _small(remat=True, n_kv_heads=1)
    one = _trace(cfg, STEP, (1, 1))
    split = _trace(cfg, STEP, (2, 2))
    n = STEP.global_batch * STEP.seq_len
    kv = cfg.n_layers * 2 * 2 * n * cfg.d_model * cfg.hd * 4
    assert split["flops"] * 4 == one["flops"] + kv


def test_flops_times_devices_do_not_depend_on_the_mesh():
    """Over the data axis (a model axis of 1) each rank computes its rows'
    share of the step: FLOPs x devices equal one device's."""
    cfg = _small(remat=True)
    one = _trace(cfg, STEP, (1, 1))
    four = _trace(cfg, STEP, (4, 1))
    assert one["flops"] > 0
    assert one["flops"] == four["flops"] * 4


@pytest.fixture(scope="module")
def olmo_train():
    """mesh -> the counts of olmo-1b train_4k on it, attention through the
    flash ops (fake CPU tensors routed to them), each mesh traced once."""
    cache = {}

    def get(mesh_shape):
        if mesh_shape not in cache:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(ops, "on_card", lambda q: True)
                with dryrun.fake_world(mesh_shape, ("data", "model"),
                                       "cpu") as (mesh, _):
                    cell = dryrun.build_cell("olmo-1b", "train_4k", mesh, 0,
                                             "cpu")
                    got = dryrun.trace(cell.fn, cell.args)
                    got.pop("out")
            cache[mesh_shape] = got
        return cache[mesh_shape]
    return get


def test_olmo_train_useful_ratio_is_the_arithmetics(olmo_train):
    """olmo-1b train_4k on (16, 1), attention through the flash ops: a
    model axis of 1, so every rank computes its data row's whole layers.
    Global FLOPs: each layer's products 2 N_layer a token forward, again in
    remat's recomputation, twice in the backward (8 N_layer), less the MLP's
    down projection in the recomputation (2 D F: ``torch.utils.checkpoint``
    stops recomputing once every saved tensor is back, and the product's
    output is none); the tied head's 2 V D forward and 4 V D backward
    (outside remat); per layer and (row, head) the flash forward's formula
    twice and the backward's once.  useful_ratio = model_flops over
    that."""
    cfg = get_arch("olmo-1b")
    shape = SHAPES["train_4k"]
    got = olmo_train((16, 1))
    rec = {"arch": "olmo-1b", "shape": "train_4k", "devices": 16,
           "flops": got["flops"], "bytes_accessed": got["bytes_accessed"],
           "collective_bytes": got["collective_bytes"]}
    row = roofline.analyse(rec, "h100-sxm5")
    b, t, d, f, v = shape.global_batch, shape.seq_len, cfg.d_model, \
        cfg.d_ff, cfg.vocab
    n_layer = 4 * d * cfg.n_heads * cfg.hd + 3 * d * f
    q = (b, cfg.n_heads, t, cfg.hd)
    attn = (2 * ops.fwd_flops(q, q, True, torch.bfloat16)
            + ops.bwd_flops(q, q, True, torch.bfloat16))
    predicted = (8 * n_layer - 2 * d * f) * b * t * cfg.n_layers + \
        6 * v * d * b * t + cfg.n_layers * attn
    want = roofline.model_flops("olmo-1b", "train_4k") / predicted
    assert abs(row["useful_ratio"] - want) <= 0.02 * want, (row, want)


def test_olmo_train_splits_by_the_model_axis(olmo_train):
    """olmo-1b train_4k on (16, 16): its 16 heads, d_ff and vocab split
    over "model" (``sharding.tp_plan``), so every product and the flash
    formulas of rank 0 are a sixteenth of (16, 1)'s, exactly (norms and
    element-wise operators are not counted); the ZeRO-3 gathers are the
    model axis's blocks'."""
    one, split = olmo_train((16, 1)), olmo_train((16, 16))
    assert split["flops"] * 16 == one["flops"]
    assert split["collective_bytes"]["all-gather"] * 16 < \
        one["collective_bytes"]["all-gather"] * 1.1
    assert split["collective_bytes"]["all-reduce"] > 0


# ---------------------------------------------------------------------------
# The flash custom ops.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 64),
                                     (torch.float32, 16)])
def test_flash_ops_trace_fake_cuda_tensors(dtype, d):
    from torch._subclasses.fake_tensor import FakeTensorMode
    before = (ops.launches, ops.launches_bf16, ops.launches_bwd,
              ops.lse_written)
    b, h, h_kv, t = 2, 4, 2, 200
    with FakeTensorMode():
        q = torch.empty((b, h, t, d), dtype=dtype, device="cuda")
        k = torch.empty((b, h_kv, t, d), dtype=dtype, device="cuda")
        out = ops.attention(q, k, k, causal=True)
        assert out.shape == q.shape and out.dtype == dtype and out.is_cuda
        lse = None
        if dtype == torch.bfloat16:
            out, lse = ops.attention_with_lse(q, k, k, causal=True)
            assert lse.shape == (b, h, ops.stat_rows(t))
            assert lse.dtype == torch.float32 and lse.is_cuda
        grads = ops.attention_bwd(q, k, k, out, torch.empty_like(q),
                                  causal=True, lse=lse)
        assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]
        assert all(g.dtype == dtype and g.is_cuda for g in grads)
    assert (ops.launches, ops.launches_bf16, ops.launches_bwd,
            ops.lse_written) == before


def test_visited_pairs_count_the_tiles():
    assert ops.visited_pairs(100, 80, False, 64) == 8000
    # Query tile 0 sees key tile 0, tile 1 sees tiles 0 and 1.
    assert ops.visited_pairs(128, 128, True, 64) == 64 * 64 + 64 * 128
    # A ragged last tile counts its rows only.
    assert ops.visited_pairs(100, 100, True, 64) == 64 * 64 + 36 * 100
    assert ops.visited_pairs(4096, 4096, True, 128) == \
        128 * 128 * 32 * 33 // 2


def test_step_flops_through_the_ops_less_ref_are_the_formulas(monkeypatch):
    """Reduced olmo-1b (float32, head dim 16: the float32 kernels) with
    remat on one rank: ``ref.py`` computes the whole [T, S] scores, 2
    products forward and 5 backward (scores, dO Vᵀ, dV, dQ, dK), 2 T S D
    FLOP each per (row, head); the kernels the formulas' tiles.  With
    remat each forward runs twice."""
    cfg = _small(remat=True)
    ref = _trace(cfg, STEP, (1, 1))
    monkeypatch.setattr(ops, "on_card", lambda q: True)
    kern = _trace(cfg, STEP, (1, 1))
    b, t = STEP.global_batch, STEP.seq_len
    q = (b, cfg.n_heads, t, cfg.hd)
    pair_flops = 2 * b * cfg.n_heads * t * t * cfg.hd
    per_layer = (2 * (2 * pair_flops - ops.fwd_flops(q, q, True,
                                                     torch.float32))
                 + 5 * pair_flops - ops.bwd_flops(q, q, True,
                                                  torch.float32))
    assert ref["flops"] - kern["flops"] == cfg.n_layers * per_layer


# ---------------------------------------------------------------------------
# Collectives.
# ---------------------------------------------------------------------------

def test_gather_and_reduce_scatter_bytes_from_the_parameters():
    """(2, 1): a parameter whose spec names "data" is gathered whole where
    it is used, once a microbatch, twice for a layer's under remat (the
    forward and its recomputation); the backward of the forward's gather
    reduce-scatters its gradient to the rank's half."""
    cfg = _small(remat=True)
    mb = 2
    got = _trace(cfg, STEP, (2, 1), microbatches=mb)
    params = transformer.LM(cfg, "meta")
    with dryrun.fake_world((2, 1), ("data", "model"), "cpu") as (mesh, _):
        specs = tshard.tree_specs(params, mesh)
    gather = scatter = 0
    for name, p in params.named_parameters():
        if "data" not in specs[name]:
            continue
        full = p.numel() * p.element_size()
        gather += full * mb * (2 if name.startswith("layers.") else 1)
        scatter += full // 2 * mb
    assert gather > 0
    assert got["collective_bytes"]["all-gather"] == gather
    assert got["collective_bytes"]["reduce-scatter"] == scatter


def test_model_axis_all_reduces_are_the_arithmetics():
    """Reduced olmo-1b (remat, float32) on (2, 2), one microbatch: the
    all-reduces (2x their bytes), N = B T / 2 a data row's tokens, D wide.
    Over "model", a layer's attention and MLP each sum their row-parallel
    outputs in the forward and their column-parallel inputs' gradients in
    the backward, and remat's recomputation sums the attention's output
    again but not the MLP's (``torch.utils.checkpoint`` stops once every
    saved tensor is back: the down projection's output, and so its sum,
    are none): 5 of N D floats; the vocab-parallel lookup sums its rows
    (N D) and the head's input sums its gradient (N D); the loss reduces 3
    of N floats (max, sum of exp, gold logit).  Over "data": the label count (int64) and the
    loss (float32).  The global norm reduces a float per leaf over each
    axis.  No parameter's gradient is all-reduced: each is reduce-scattered
    to its storage."""
    cfg = _small(remat=True)
    got = _trace(cfg, STEP, (2, 2))
    n = STEP.global_batch * STEP.seq_len // 2
    d = cfg.d_model
    model = cfg.n_layers * 5 * n * d + 2 * n * d + 3 * n
    leaves = len(transformer.stacked_leaves(transformer.LM(cfg, "meta")))
    want = 2 * (4 * model + 8 + 4 + 2 * 4 * leaves)
    assert got["collective_bytes"]["all-reduce"] == want


# ---------------------------------------------------------------------------
# Fake against real.
# ---------------------------------------------------------------------------

def test_fake_and_real_steps_count_alike(tmp_path):
    """Reduced olmo-1b's step on a (1, 1) mesh, counted on fake CPU tensors
    and on real ones (random weights, a gloo world of one): FLOPs, bytes
    accessed, collective bytes and argument bytes equal."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshes
    from repro_torch.train.train_step import (TrainConfig,
                                              init_train_state,
                                              make_train_step,
                                              shard_train_state)
    cfg = _small(remat=True)
    fake = _trace(cfg, STEP, (1, 1), microbatches=2)
    meshes.init_shard_group("gloo", f"file://{tmp_path}/pg", world_size=1,
                            rank=0)
    try:
        mesh = meshes.make_mesh((1, 1), ("data", "model"), device="cpu")
        tcfg = TrainConfig(microbatches=2)
        state = shard_train_state(init_train_state(
            cfg, tcfg, torch.Generator().manual_seed(0), "cpu"), mesh)
        gen = torch.Generator().manual_seed(1)
        batch = dryrun.store_batch({k: torch.randint(
            0, cfg.vocab, (STEP.global_batch, STEP.seq_len), generator=gen,
            dtype=torch.int32) for k in ("tokens", "labels")}, mesh)
        real = dryrun.trace(make_train_step(cfg, tcfg), (state, batch))
        assert math.isfinite(float(real["out"][1]["loss"]))
    finally:
        dist.destroy_process_group()
    for key in ("flops", "bytes_accessed", "collective_bytes"):
        assert real[key] == fake[key], key
    assert real["memory"]["argument_size_in_bytes"] == \
        fake["memory"]["argument_size_in_bytes"]


# ---------------------------------------------------------------------------
# The fake-tensor paths of the model code.
# ---------------------------------------------------------------------------

def test_moe_dispatch_at_capacity_under_fake_tensors():
    """Every expert's buffer holds its C rows: the expert products are
    E C rows of 3 products of D x F a layer (6 D F FLOP a row)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import moe
    cfg = _small("mixtral-8x22b")
    n = 24
    with FakeTensorMode():
        params = moe.MoE(cfg, "cpu")
        x = torch.empty((1, n, cfg.d_model))
        count = dryrun.Count()
        with count:
            y, _ = moe.moe_ffn(cfg, params, x, "sort")
    assert y.shape == x.shape
    cap = moe._capacity(cfg, n)
    router = 2 * n * cfg.d_model * cfg.n_experts
    experts = cfg.n_experts * cap * 6 * cfg.d_model * cfg.d_ff
    assert count.flops == router + experts


def test_xlstm_counts_one_trip_of_its_loops():
    """The sLSTM's time loop and the mLSTM's chunk loop run one trip on
    fake tensors: the FLOPs do not grow with T beyond the projections."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import ssm
    cfg = _small("xlstm-350m")
    h, hd, d, b = cfg.n_heads, cfg.hd, cfg.d_model, 2

    def flops(cell_cls, fwd, t):
        with FakeTensorMode():
            cell = cell_cls(cfg, "cpu")
            x = torch.empty((b, t, d))
            count = dryrun.Count()
            with count:
                y = fwd(cfg, cell, x)
            assert y.shape == x.shape
        return count.flops

    t1, t2 = 3 * cfg.mlstm_chunk, 5 * cfg.mlstm_chunk
    # sLSTM: w_gates and wo grow with T; one step's recurrent product.
    for t in (t1, t2):
        assert flops(ssm.SLSTM, ssm.slstm_forward, t) == \
            2 * b * t * d * 4 * h * hd + 2 * b * t * h * hd * d + \
            2 * h * b * hd * 4 * hd
    # mLSTM: the projections grow with T, one chunk's body does not.
    m1 = flops(ssm.MLSTM, ssm.mlstm_forward, t1)
    m2 = flops(ssm.MLSTM, ssm.mlstm_forward, t2)
    proj = 2 * b * d * (4 * h * hd + 2 * h) + 2 * b * h * hd * d
    assert m2 - m1 == proj * (t2 - t1)


# ---------------------------------------------------------------------------
# The entry point (the reference's tests/test_distributed.py slow test).
# ---------------------------------------------------------------------------

def test_dryrun_single_cell_entrypoint(tmp_path):
    out_file = tmp_path / "cells.json"
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "olmo-1b", "--shape", "decode_32k", "--device", "cpu", "--out",
         str(out_file)], env=env, capture_output=True, text=True,
        timeout=CLI_TIMEOUT)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.splitlines()[-1])
    assert rec["devices"] == 256
    assert rec["flops"] > 0
    assert rec["collective_bytes"]["total"] > 0
    assert rec["probes"] == []
    # Decode computes replicated over "model".
    assert set(rec["tp"]) == {"attention", "kv", "mlp", "head"}
    assert set(rec["tp"].values()) == {"replicated"}
    rows = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline",
         str(out_file), "--card", "h100-sxm5"], env=env,
        capture_output=True, text=True, timeout=CLI_TIMEOUT)
    assert rows.returncode == 0, rows.stderr[-2000:]
    row = json.loads(rows.stdout.splitlines()[-1])
    assert row["dominant"] in ("compute", "memory", "collective")
