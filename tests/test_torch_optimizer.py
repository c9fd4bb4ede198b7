"""The port's AdamW and gradient compression against the reference's
``repro.train.optimizer``.

The reference runs eagerly on the reduced llama3-8b tree (2 layers, d 64,
RMSNorm, float32), whose per-layer leaves are stacked on a leading layer
axis; the port holds the same parameters per layer
(``convert.lm_params_from_jax``) and its μ, ν, gradients and residuals by
the reference's stacked leaves.  Inputs are numpy draws from fixed seeds.

Bounds: the schedule is bit for bit at the steps where both frameworks
compute it without a transcendental that rounds (warm-up, the cosine's two
ends); a step of AdamW is within 1 ulp (parameters, μ, ν: XLA's and
torch's ``pow`` for the bias corrections part in the last bit) and the
global norm within 4 ulp (a float32 sum of squares in another order);
compression is exact: the same blocks, scales, quantised values, top-k
picks and wire bytes.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as jt
from repro.train import optimizer as jo

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import transformer as tt
from repro_torch.train import optimizer as to
from repro_torch.train.train_step import nest, stacked_params, unnest

ARCH = "llama3-8b"


@pytest.fixture(scope="module")
def model():
    cfg_j = dataclasses.replace(j_get_arch(ARCH).reduced(), n_kv_heads=2)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), n_kv_heads=2)
    params_j = jt.init_params(cfg_j, jax.random.PRNGKey(0))
    return cfg, params_j


def port_params(cfg, params_j):
    return convert.lm_params_from_jax(cfg, params_j, "cpu")


def draw(tree, seed, scale=1.0):
    """A numpy tree shaped like ``tree``, standard normal * ``scale``
    (continuous draws: no ties)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (rng.standard_normal(x.shape) * scale
                                   ).astype(np.float32), tree)


def to_port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in unnest(tree).items()}


def assert_ulp(got, want, maxulp):
    np.testing.assert_array_max_ulp(np.asarray(got, np.float32),
                                    np.asarray(want, np.float32),
                                    maxulp=maxulp)


@pytest.mark.parametrize("cfg", [jo.AdamWConfig(),
                                 jo.AdamWConfig(lr=3e-3, warmup_steps=10,
                                                total_steps=50)])
def test_lr_schedule_bit_for_bit(cfg):
    tcfg = to.AdamWConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 5, 10, 50, cfg.total_steps):
        want = np.asarray(jo.lr_schedule(cfg, jnp.asarray(step, jnp.int32)))
        got = to.lr_schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes(), step


def test_leaves_follow_the_reference_tree(model):
    cfg, params_j = model
    leaves = tt.stacked_leaves(port_params(cfg, params_j))
    flat, _ = jax.tree_util.tree_flatten_with_path(params_j)
    want = [".".join(p.key for p in path) for path, _ in flat]
    assert list(leaves) == want
    for (path, x), (name, ps) in zip(flat, leaves.items()):
        assert to.leaf_shape(name, ps) == x.shape


def test_adamw_update_matches_the_reference(model):
    """Two steps on the same parameters and gradients (the second large
    enough to clip)."""
    cfg, params_j = model
    acfg = jo.AdamWConfig(lr=1e-2, warmup_steps=3)
    tcfg = to.AdamWConfig(**dataclasses.asdict(acfg))
    params = port_params(cfg, params_j)
    state_j, state = jo.adamw_init(params_j), to.adamw_init(params)
    for i, scale in enumerate((0.05, 3.0)):
        grads_j = draw(params_j, seed=10 + i, scale=scale)
        params_j, state_j, met_j = jo.adamw_update(acfg, state_j, params_j,
                                                   grads_j)
        params, state, met = to.adamw_update(tcfg, state, params,
                                             to_port(grads_j))
        assert_ulp(met["grad_norm"], met_j["grad_norm"], 4)
        assert np.asarray(met["lr"]).tobytes() == \
            np.asarray(met_j["lr"]).tobytes()
        assert int(state.step) == int(state_j.step) == i + 1
        got_p = stacked_params(params)
        for name, want in unnest(params_j).items():
            assert_ulp(got_p[name], want, 1)
        for got_t, want_t in ((state.mu, state_j.mu),
                              (state.nu, state_j.nu)):
            for name, want in unnest(want_t).items():
                assert_ulp(got_t[name], want, 1)


def test_weight_decay_follows_the_stacked_leaves(model):
    """With zero gradients only the decay moves a parameter: every leaf of
    two or more stacked dimensions decays, the per-layer norm scales
    ((U, D)) included, and final_norm's (D,) does not, in both
    packages."""
    cfg, params_j = model
    acfg = jo.AdamWConfig(lr=0.5, warmup_steps=1)
    params = port_params(cfg, params_j)
    zeros_j = jax.tree.map(jnp.zeros_like, params_j)
    new_j, _, _ = jo.adamw_update(acfg, jo.adamw_init(params_j), params_j,
                                  zeros_j)
    params, _, _ = to.adamw_update(
        to.AdamWConfig(**dataclasses.asdict(acfg)), to.adamw_init(params),
        params, to_port(zeros_j))
    got = stacked_params(params)
    before = unnest(params_j)
    moved = {name for name, x in unnest(new_j).items()
             if not np.array_equal(np.asarray(x), np.asarray(before[name]))}
    assert "units.b0_dense.ln1.scale" in moved
    assert "final_norm.scale" not in moved
    assert moved == {name for name, x in before.items() if x.ndim >= 2}
    for name, want in unnest(new_j).items():
        assert np.array_equal(got[name].numpy(), np.asarray(want)), name


@pytest.mark.parametrize("n", [256 * 7, 1000, 3])
def test_int8_compress_matches(n):
    g = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    q_j, s_j = jo.int8_compress(jnp.asarray(g))
    q, s = to.int8_compress(torch.from_numpy(g))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(),
                                                    np.asarray(q_j))
    assert s.numpy().tobytes() == np.asarray(s_j).tobytes()
    back_j = jo.int8_decompress(q_j, s_j, g.shape)
    assert np.array_equal(to.int8_decompress(q, s, g.shape).numpy(),
                          np.asarray(back_j))


def test_ef_topk_delta_matches():
    rng = np.random.default_rng(5)
    g = rng.standard_normal((3, 40, 17)).astype(np.float32)
    r = (rng.standard_normal(g.shape) * 0.1).astype(np.float32)
    want = jo.ef_topk_delta(jnp.asarray(g), jnp.asarray(r), 37)
    got = to.ef_topk_delta(torch.from_numpy(g), torch.from_numpy(r), 37)
    idx_j = np.flatnonzero(np.asarray(want[0]))
    assert np.array_equal(np.flatnonzero(got[0].numpy()), idx_j)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("method", ["none", "int8", "delta"])
def test_compress_tree_matches(model, method):
    """Compression over the stacked leaves (one top-k and one run of
    blocks across the layers): grads, residuals and wire bytes equal, the
    twin of tests/test_distributed.py::test_gradient_compression_wire_math
    and tests/test_runtime.py's test_compress_tree_bytes."""
    _, params_j = model
    grads_j = draw(params_j, seed=3)
    res_j = draw(params_j, seed=4, scale=0.01)
    want = jo.compress_tree(grads_j, res_j, method, 0.01)
    got = to.compress_tree(to_port(grads_j), to_port(res_j), method, 0.01)
    assert got[2].dtype == torch.float32
    assert float(got[2]) == float(want[2])
    n = sum(x.size for x in jax.tree.leaves(params_j))
    if method == "none":
        assert float(got[2]) == 4.0 * n
    if method == "delta":
        assert float(got[2]) == 8.0 * sum(
            max(1, int(x.size * 0.01)) for x in jax.tree.leaves(params_j))
    for got_t, want_t in zip(got[:2], want[:2]):
        for name, x in unnest(want_t).items():
            assert np.array_equal(got_t[name].numpy(), np.asarray(x)), name


def test_zero_residuals_and_init_have_the_stacked_shapes(model):
    cfg, params_j = model
    params = port_params(cfg, params_j)
    for tree in (to.zero_residuals(params), to.adamw_init(params).mu):
        assert {k: tuple(v.shape) for k, v in tree.items()} == {
            k: v.shape for k, v in unnest(params_j).items()}
        assert all(v.dtype == torch.float32 and not v.any()
                   for v in tree.values())
    assert nest(unnest(params_j)).keys() == params_j.keys()
