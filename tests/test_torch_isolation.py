"""The port stands alone: no JAX, nothing of ``repro``, CUDA by default.

A subprocess imports ``repro_torch`` (observability, runtime and the
multi-process launch included) and runs a tiny PageRank (also on the
shard_map backend, over a gloo world of one rank), greedy generation of
a reduced llama3-8b, of a reduced mixtral-8x22b (MoE, its window
crossed), of a reduced minicpm3-4b (MLA) and of a reduced
whisper-large-v3 (encoder, cross-attention, sinusoid positions; also
through ``launch/serve.py``'s ``main``), of a reduced recurrentgemma-2b
(RG-LRU, local attention, its tail) and of a reduced xlstm-350m (mLSTM,
sLSTM), a reduced qwen2-vl-2b's
forward from embeds at [3, B, T] positions (M-RoPE), a traced resilient
PageRank with one failure and adsorption on the CPU, two journaled views
restored, and reachability compiled from its rule text, then reports
which modules were loaded; a
source scan finds no import of ``jax`` or ``repro``; the entry points
refuse to fall back to the CPU when no device is named and CUDA is
missing.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = r"""
import json, sys
import repro_torch
from repro_torch.algorithms import pagerank
from repro_torch.core.partition import PartitionSnapshot
from repro_torch.data.graphs import load_dataset, make_powerlaw_graph, shard_csr
import repro_torch.convert
import repro_torch.kernels._build
import repro_torch.algorithms.adsorption
import repro_torch.obs
import repro_torch.runtime
import repro_torch.runtime.chaos
import repro_torch.launch.serve
import repro_torch.models.transformer
import repro_torch.serve.serve_step
import repro_torch.incremental
import repro_torch.launch.channel
import repro_torch.launch._worker
import repro_torch.launch.distributed
import repro_torch.runtime.health
import repro_torch.train
import repro_torch.launch.train
indptr, indices = make_powerlaw_graph(256, 6.0, seed=0)
snap = PartitionSnapshot(n_keys=256, num_shards=2)
pr, res = pagerank.run(shard_csr(indptr, indices, 2, device="cpu"), snap,
                       device="cpu", max_iters=5, ladder_tiers=2,
                       route_strategy="auto", edge_capacity=512,
                       src_capacity=128)
import torch
from repro_torch.configs import get_arch
from repro_torch.models import transformer
cfg = get_arch("llama3-8b").reduced()
lm = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
toks = repro_torch.serve.serve_step.generate(
    cfg, lm, torch.zeros((1, 4), dtype=torch.int32), 2, 6)
import repro_torch.models.moe
moe_cfg = get_arch("mixtral-8x22b").reduced()
moe_lm = transformer.init_params(moe_cfg, torch.Generator().manual_seed(0),
                                 "cpu")
moe_toks = repro_torch.serve.serve_step.generate(
    moe_cfg, moe_lm, torch.zeros((1, 20), dtype=torch.int32), 2, 22)
mla_cfg = get_arch("minicpm3-4b").reduced()
mla_lm = transformer.init_params(mla_cfg, torch.Generator().manual_seed(0),
                                 "cpu")
mla_toks = repro_torch.serve.serve_step.generate(
    mla_cfg, mla_lm, torch.zeros((1, 4), dtype=torch.int32), 3, 7)
wh_cfg = get_arch("whisper-large-v3").reduced()
wh_lm = transformer.init_params(wh_cfg, torch.Generator().manual_seed(0),
                                "cpu")
wh_enc = transformer.encode(wh_cfg, wh_lm, torch.randn(
    1, wh_cfg.encoder_seq, wh_cfg.d_model))
wh_toks = repro_torch.serve.serve_step.generate(
    wh_cfg, wh_lm, torch.zeros((1, 4), dtype=torch.int32), 3, 7,
    enc_out=wh_enc)
repro_torch.launch.serve.main(["--arch", "whisper-large-v3", "--reduced",
                               "--device", "cpu", "--batch", "1",
                               "--prompt-len", "4", "--new-tokens", "2"])
rec_toks = {}
for rec_name in ("recurrentgemma-2b", "xlstm-350m"):
    rec_cfg = get_arch(rec_name).reduced()
    rec_lm = transformer.init_params(rec_cfg,
                                     torch.Generator().manual_seed(0), "cpu")
    rec_toks[rec_name] = list(repro_torch.serve.serve_step.generate(
        rec_cfg, rec_lm, torch.zeros((1, 18), dtype=torch.int32), 2,
        20).shape)
vlm_cfg = get_arch("qwen2-vl-2b").reduced()
vlm_lm = transformer.init_params(vlm_cfg, torch.Generator().manual_seed(0),
                                 "cpu")
pos3 = torch.arange(6, dtype=torch.int32).expand(3, 1, 6).clone()
pos3[1:, :, 2:4] += torch.tensor([[[0, 1]], [[1, 0]]], dtype=torch.int32)
vlm_logits, _ = transformer.forward(vlm_cfg, vlm_lm, None, positions=pos3,
                                    embeds=torch.randn(1, 6, 64))
import tempfile
from repro_torch.obs import Tracer
from repro_torch.runtime import FaultPlan
from repro_torch.core.engine import ShardedExecutor
from repro_torch.algorithms import adsorption
ex = ShardedExecutor(snapshot=snap, seg_capacity=512, edge_capacity=512,
                     src_capacity=128, ladder_tiers=2, tracer=Tracer())
algo = pagerank.make_algorithm(snap, src_capacity=128, edge_capacity=512)
with tempfile.TemporaryDirectory() as td:
    rr = ex.run_resilient(algo, pagerank.initial_state(snap, "cpu"), 256,
                          shard_csr(indptr, indices, 2, device="cpu"), 5,
                          ckpt_root=td,
                          fault_plan=FaultPlan(fail_at=2, failed_shard=1))
seeds = torch.zeros((256, 4))
seeds[::10, 0] = 1.0
vec, _ = adsorption.run(shard_csr(indptr, indices, 2, device="cpu"), snap,
                        seeds, device="cpu", max_iters=3, edge_capacity=512,
                        src_capacity=128)
from repro_torch.incremental import EdgeInsert, PointInsert, ViewManager
with tempfile.TemporaryDirectory() as td:
    vm = ViewManager(journal_root=td)
    vm.create_graph_view("sp", "sssp", indptr, indices, 256, num_shards=2,
                         device="cpu")
    vm.create_kmeans_view("km", seeds[:64, :2].numpy(), k=2, device="cpu")
    vm.mutate("sp", EdgeInsert(0, 7))
    vm.mutate("km", PointInsert(0.5, 0.5))
    vm.refresh()
    views = {n: v.version for n, v in ViewManager.restore(td, "cpu").views
             .items()}
import repro_torch.frontend as F
cp = F.compile_program(F.parse_program(F.REACHABILITY_TEXT))
reach, _ = cp.run(shard_csr(indptr, indices, 2, device="cpu"), snap,
                  device="cpu", max_iters=40, route_strategy="auto",
                  ladder_tiers=2, edge_capacity=512, src_capacity=128)
import torch.distributed as dist
from repro_torch.launch.mesh import flat_mesh, init_shard_group
with tempfile.TemporaryDirectory() as td:
    init_shard_group("gloo", "file://" + td + "/pg", world_size=1, rank=0)
    smap = ShardedExecutor(snapshot=snap, seg_capacity=512, edge_capacity=512,
                           src_capacity=128, ladder_tiers=2,
                           route_strategy="auto", backend="shard_map",
                           mesh=flat_mesh(2, device="cpu"))
    pr_smap, res_smap = pagerank.run(
        shard_csr(indptr, indices, 2, device="cpu"), snap, device="cpu",
        max_iters=5, edge_capacity=512, src_capacity=128, executor=smap)
    dist.destroy_process_group()
print(json.dumps({"mods": sorted(sys.modules), "iters": int(res.stats.iterations),
                  "shard_map_equal": bool(torch.equal(pr, pr_smap)),
                  "lm": list(toks.shape), "moe": list(moe_toks.shape),
                  "mla": list(mla_toks.shape),
                  "whisper": list(wh_toks.shape), "recurrent": rec_toks,
                  "vlm": list(vlm_logits.shape),
                  "resilient": rr.metrics["recoveries"],
                  "adsorption": list(vec.shape), "views": views,
                  "reached": int((reach == 1.0).sum())}))
"""


def test_import_and_run_load_no_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["iters"] == 5
    assert got["lm"] == [1, 6]
    assert got["moe"] == [1, 22]
    assert got["mla"] == [1, 7]
    assert got["whisper"] == [1, 7]
    assert got["recurrent"] == {"recurrentgemma-2b": [1, 20],
                                "xlstm-350m": [1, 20]}
    assert got["vlm"] == [1, 6, 256]
    assert got["resilient"] == 1
    assert got["adsorption"] == [256, 4]
    assert got["views"] == {"km": 1, "sp": 1}
    assert got["reached"] > 1
    assert got["shard_map_equal"]
    bad = [m for m in got["mods"]
           if m == "jax" or m.startswith(("jax.", "jaxlib", "repro."))
           or m in ("repro", "ml_dtypes")]
    assert bad == []


def test_sources_import_neither_jax_nor_reference():
    pattern = re.compile(
        r"^\s*(import\s+(jax|jaxlib|repro|ml_dtypes)\b|"
        r"from\s+(jax|jaxlib|repro|ml_dtypes)(\.|\s))", re.M)
    hits = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
            for p in sorted(PKG.rglob("*.py"))
            for m in pattern.finditer(p.read_text())]
    assert hits == []
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert not pattern.search(smoke)


def test_entry_points_need_cuda_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    from repro_torch.algorithms import adsorption, pagerank
    from repro_torch.configs import get_arch
    from repro_torch.core.partition import PartitionSnapshot
    from repro_torch.data import graphs
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.frontend import compile_program, reachability_program
    from repro_torch.incremental import ViewManager
    from repro_torch.launch import _worker, distributed, serve, train
    from repro_torch.launch.mesh import init_shard_group
    from repro_torch.models import transformer
    from repro_torch.obs import calibrate_route_table
    from repro_torch.runtime import chaos
    snap = PartitionSnapshot(n_keys=64, num_shards=2)
    indptr, indices = graphs.make_powerlaw_graph(64, 4.0, seed=0)
    g = graphs.shard_csr(indptr, indices, 2, device="cpu")
    reach = compile_program(reachability_program())
    for call in (lambda: pagerank.run(g, snap),
                 lambda: graphs.load_dataset("dbpedia-small", 2),
                 lambda: pagerank.initial_state(snap),
                 lambda: transformer.init_params(get_arch("olmo-1b").reduced()),
                 lambda: transformer.init_cache(
                     get_arch("olmo-1b").reduced(), 1, 4),
                 lambda: TokenPipeline(256, 8, 1).batch_at(0),
                 lambda: serve.main(["--reduced"]),
                 lambda: serve.main(["--arch", "mixtral-8x22b", "--reduced"]),
                 lambda: transformer.init_params(
                     get_arch("arctic-480b").reduced()),
                 lambda: transformer.init_params(
                     get_arch("minicpm3-4b").reduced()),
                 lambda: transformer.init_cache(
                     get_arch("minicpm3-4b").reduced(), 1, 4),
                 lambda: serve.main(["--arch", "qwen2-vl-2b", "--reduced"]),
                 lambda: serve.main(["--arch", "whisper-large-v3",
                                     "--reduced"]),
                 lambda: transformer.init_cache(
                     get_arch("whisper-large-v3").reduced(), 1, 4),
                 lambda: transformer.init_params(
                     get_arch("recurrentgemma-2b").reduced()),
                 lambda: transformer.init_cache(
                     get_arch("recurrentgemma-2b").reduced(), 1, 4),
                 lambda: serve.main(["--arch", "recurrentgemma-2b",
                                     "--reduced"]),
                 lambda: transformer.init_params(
                     get_arch("xlstm-350m").reduced()),
                 lambda: transformer.init_cache(
                     get_arch("xlstm-350m").reduced(), 1, 4),
                 lambda: serve.main(["--arch", "xlstm-350m", "--reduced"]),
                 lambda: train.main(["--reduced", "--steps", "1"]),
                 lambda: adsorption.run(g, snap, torch.zeros(64, 4)),
                 lambda: reach.run(g, snap),
                 lambda: reach.initial_state(snap),
                 lambda: adsorption.initial_state(snap, torch.zeros(64, 4)),
                 lambda: calibrate_route_table(snap, [64]),
                 lambda: init_shard_group(),
                 lambda: chaos.main(["--quick", "--nodes", "64"]),
                 lambda: chaos.main(["--quick", "--nodes", "64", "--real"]),
                 lambda: _worker.main(["--id", "0", "--root", str(tmp_path),
                                       "--torch", "local", "--oneshot"]),
                 lambda: distributed.selftest(1, backend="nccl"),
                 lambda: distributed.selftest(1, backend="gloo"),
                 lambda: distributed.initialize_from_env(2, env={}),
                 lambda: ViewManager().create_graph_view(
                     "v", "sssp", indptr, indices, 64, num_shards=2),
                 lambda: ViewManager().create_kmeans_view(
                     "k", np.zeros((16, 2), np.float32), k=2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
