"""The port's sharding rules and roofline against the reference's.

No process group: the rules read axis names and sizes only.  Every
parameter of all ten configs at full width (``LM(cfg, device="meta")``:
no memory) takes the spec that the reference's ``tree_specs`` gives the
stacked leaf it belongs to (``jax.eval_shape(init_params)``), without the
leading unit entry, under the reference test's production stand-ins
(16 x 16 and 2 x 16 x 16) and the port's ``make_production_mesh``; so do
μ and ν (the stacked leaves, lead included) and every decodable config's
decode cache at decode_32k (``cache_tree_specs``).  ``batch_spec`` and
``drop_data`` take the reference test's cases; ``model_params``,
``model_flops`` and ``xlstm_correction`` equal the reference's on every
(arch, shape) of ``cells()``; ``analyse`` and ``what_would_help`` equal
the reference's on its test's cell with the reference's v5e constants
named (the port's own constants are the H100's, chosen by card name).
"""
from functools import partial

import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JP

from repro.configs import cells as j_cells
from repro.configs import get_arch as j_get_arch
from repro.launch import roofline as jroof
from repro.launch import sharding as jshard
from repro.models import transformer as jt

from repro_torch.configs import all_archs, cells, get_arch
from repro_torch.launch import roofline as troof
from repro_torch.launch import sharding as tshard
from repro_torch.launch.mesh import (dp_axes, dp_size, make_production_mesh,
                                     model_axis_size)
from repro_torch.models import transformer as tt
from repro_torch.train.optimizer import leaf_shape
from test_sharding_roofline import FakeMesh, FakeMeshPod
from torch_threads import one_torch_thread  # noqa: F401

MESHES = {"16x16": FakeMesh, "2x16x16": FakeMeshPod}
V5E = troof.Chip("v5e", 197e12, 819e9, 50e9)   # the reference's constants


def _spec(s) -> tuple:
    """A spec's entries, a one-name tuple read as that name (jax's
    ``PartitionSpec`` stores ``("data",)`` as ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in s)


def _at(tree, dotted: str):
    for part in dotted.split("."):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else \
            tree[part]
    return tree


@pytest.fixture(scope="module")
def ref_params():
    """{arch: the reference's parameter shapes (eval_shape)}."""
    return {arch: jax.eval_shape(partial(jt.init_params, j_get_arch(arch)),
                                 jax.random.PRNGKey(0))
            for arch in all_archs()}


def test_production_meshes_read_as_the_reference_stand_ins():
    for multi, fake in ((False, FakeMesh()), (True, FakeMeshPod())):
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh.axis_names == fake.axis_names
        assert mesh.shape == fake.shape
        assert dp_axes(mesh) == jshard.dp_axes(fake)
        assert dp_size(mesh) == jshard.dp_size(fake)
        assert model_axis_size(mesh) == jshard.model_axis_size(fake)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(all_archs()))
def test_param_specs_equal_the_reference(arch, mesh_name, ref_params):
    fake = MESHES[mesh_name]()
    ref = jshard.tree_specs(ref_params[arch], fake, "params")
    params = tt.LM(get_arch(arch), device="meta")
    meshes = (fake, make_production_mesh(multi_pod=mesh_name != "16x16"))
    for mesh in meshes:
        specs = tshard.tree_specs(params, mesh)
        assert set(specs) == {n for n, _ in params.named_parameters()}
        for name, _ in params.named_parameters():
            leaf = tt.stacked_name(name, params)
            want = _spec(_at(ref, leaf))
            if tt.is_stacked(leaf):
                assert want[0] is None
                want = want[1:]
            assert _spec(specs[name]) == want, (name, specs[name], want)
        # μ, ν and the residuals: the stacked leaves' own specs.
        leaves = tshard.leaf_specs(params, mesh)
        for leaf, ps in tt.stacked_leaves(params).items():
            assert _spec(leaves[leaf]) == _spec(_at(ref, leaf)), leaf
            assert leaf_shape(leaf, ps) == tuple(
                _at(ref_params[arch], leaf).shape)


@pytest.mark.parametrize("arch", sorted(
    a for a in all_archs() if get_arch(a).decode_ok))
def test_cache_specs_equal_the_reference(arch):
    cfg = get_arch(arch)
    b, s = 128, 32_768                              # decode_32k
    ref_cache = jax.eval_shape(partial(jt.init_cache, j_get_arch(arch), b,
                                       s))
    cache = tt.init_cache(cfg, b, s, device="meta")
    for fake in (FakeMesh(), FakeMeshPod()):
        ref = jshard.cache_tree_specs(ref_cache, fake, "cache")
        got = tshard.cache_tree_specs(cache, fake, cfg)
        n = 0
        for i, layer in enumerate(got["layers"]):
            prefix, row = tt.layer_leaf(cfg, i)
            ref_layer = _at(ref, prefix)

            def check(mine, theirs, path):
                nonlocal n
                if isinstance(mine, dict):
                    assert set(mine) == set(theirs), path
                    for k in mine:
                        check(mine[k], theirs[k], f"{path}/{k}")
                    return
                if isinstance(mine, tuple) and not isinstance(
                        mine, tshard.P):
                    for j, (a, c) in enumerate(zip(mine, theirs)):
                        check(a, c, f"{path}/{j}")
                    return
                want = _spec(theirs)
                if row is not None:
                    want = want[1:]
                assert _spec(mine) == want, (path, mine, want)
                n += 1
            check(layer, ref_layer, prefix)
        assert n > 0


def test_batch_and_drop_data_equal_the_reference():
    for fake in (FakeMesh(), FakeMeshPod()):
        for shape in ((256, 4096), (1, 524288), (32, 4, 8), (48,)):
            assert _spec(tshard.batch_spec(shape, fake)) == _spec(
                jshard.batch_spec(shape, fake)), (shape, fake)
    for spec in (("data", "model"), (("pod", "data"), None),
                 ("model", "data"), (None, ("data", "model")),
                 (("pod", "data", "model"),)):
        assert _spec(tshard.drop_data(tshard.P(*spec))) == _spec(
            jshard.drop_data(JP(*spec))), spec
    assert tshard.drop_data(tshard.P("data", "model")) == tshard.P(
        None, "model")


def test_placements_name_each_mesh_dims_tensor_dim():
    from torch.distributed.tensor import Replicate, Shard
    pod = make_production_mesh(multi_pod=True)
    assert tshard.placements(tshard.P(("pod", "data"), None, "model"),
                             pod) == [Shard(0), Shard(0), Shard(2)]
    assert tshard.placements(tshard.P(None, None), pod) == [Replicate()] * 3
    tree = {"a": tshard.P("data", None), "b": [tshard.P(None, "model")]}
    mesh = make_production_mesh()
    assert tshard.to_shardings(tree, mesh) == {
        "a": [Shard(0), Replicate()], "b": [[Replicate(), Shard(1)]]}


@pytest.mark.parametrize("arch", sorted(all_archs()))
def test_model_flops_equal_the_reference(arch):
    cfg, j_cfg = get_arch(arch), j_get_arch(arch)
    assert troof.model_params(cfg) == jroof.model_params(j_cfg)
    assert cells() == j_cells()
    for a, shape, _ in cells():
        if a != arch:
            continue
        assert troof.model_flops(arch, shape) == jroof.model_flops(arch,
                                                                   shape)
        assert troof.xlstm_correction(arch, shape) == \
            jroof.xlstm_correction(arch, shape)


def test_analyse_equals_the_reference_on_its_cell():
    cells_ = [{"arch": "olmo-1b", "shape": "train_4k", "devices": 256,
               "flops": 1e13, "bytes_accessed": 1e12,
               "collective_bytes": {"total": 1e13}},
              {"arch": "xlstm-350m", "shape": "prefill_32k", "devices": 256,
               "flops": 3e14, "bytes_accessed": 1e12,
               "collective_bytes": {"total": 1e9}},
              {"arch": "llama3-8b", "shape": "decode_32k", "devices": 256,
               "flops": 1e9, "bytes_accessed": 1e12,
               "collective_bytes": {"total": 1e9}},
              {"error": "did not compile"}]
    for cell in cells_:
        got, want = troof.analyse(cell, V5E), jroof.analyse(cell)
        assert got == want
        if want is not None:
            assert troof.what_would_help(got) == jroof.what_would_help(want)
    assert {jroof.analyse(c)["dominant"] for c in cells_[:3]} == {
        "collective", "compute", "memory"}


def test_card_constants_by_name():
    sxm = troof.chip_constants("NVIDIA H100 80GB HBM3")
    assert sxm.peak_flops == 989.4e12 and sxm.hbm_bw == 3.35e12
    pcie = troof.chip_constants("NVIDIA H100 PCIe")
    assert pcie.peak_flops == 756e12 and pcie.hbm_bw == 2.0e12
    with pytest.raises(ValueError, match="no datasheet constants"):
        troof.chip_constants("NVIDIA A100-SXM4-80GB")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="name the card"):
            troof.chip_constants()
    row = troof.analyse({"arch": "olmo-1b", "shape": "train_4k",
                         "devices": 1, "flops": 989.4e12,
                         "bytes_accessed": 1.0,
                         "collective_bytes": {"total": 1.0}}, sxm.name)
    assert row["compute_s"] == 1.0 and row["dominant"] == "compute"
