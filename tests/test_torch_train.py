"""The port's training path against the reference's ``repro.train``:
loss, gradients, the train step with microbatches and compression,
``launch/train.py`` with checkpoints and resume, and checkpoints read
across the packages.

At ``reduced()`` size (2 layers, d 64, 4 heads of 16, vocab 256, float32)
for llama3-8b with ``n_kv_heads=2`` (RMSNorm, GQA group 2) and olmo-1b
(non-parametric LayerNorm, tied embeddings).  The reference's weights and
state are carried into the port with ``convert.lm_params_from_jax`` and
``convert.train_state_from_jax``; batches come from the reference's
``TokenPipeline``.  The reference trains through its plain
``attention_ref`` (``use_flash_kernel=False``); the port through its
flash op, whose CPU forward is ``attention_ref`` and whose backward is
``attention_bwd_ref``.

Bounds: one microbatch's loss within 1e-5 relative and every gradient
within 1e-4 of its leaf's largest |g| (readings: 1.6e-7 and 1.2e-6); a
train step of 2 microbatches, for each compression: step 0's loss,
grad_norm and lr within 1e-5 relative (readings: at most 6.2e-7, on
int8's grad_norm), wire_bytes equal; the loss after 3 steps within 1e-3
relative (reading: at most 1.7e-7), wide because Adam's update divides by
sqrt(ν) and so turns near-zero gradients that the two frameworks round
apart into full-size steps.  Checkpoints and resumes are bit for bit.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as j_get_arch
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.models import transformer as jt
from repro.runtime.checkpoint import CheckpointManager as JCheckpointManager
from repro.train import optimizer as jo
from repro.train import train_step as jts

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tt
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.train import optimizer as to
from repro_torch.train import train_step as tts

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's max |g|
STEP0_RTOL = 1e-5
STEP3_RTOL = 1e-3


def _cfgs(name, **kw):
    if name == "llama3-8b":
        kw.setdefault("n_kv_heads", 2)
    return (dataclasses.replace(j_get_arch(name).reduced(), **kw),
            dataclasses.replace(get_arch(name).reduced(), **kw))


def _batch(vocab, t=32, b=4, step=0):
    j = JTokenPipeline(vocab, t, b).batch_at(step)
    return j, {k: torch.from_numpy(np.array(v)) for k, v in j.items()}


def _grads(params, total):
    """{stacked leaf: gradient} of ``total``."""
    leaves = tt.stacked_leaves(params)
    flat = [p for ps in leaves.values() for p in ps]
    got = iter(torch.autograd.grad(total, flat))
    return {name: (torch.stack([next(got) for _ in ps])
                   if tt.is_stacked(name) else next(got))
            for name, ps in leaves.items()}


def test_cross_entropy_matches_with_masks_and_smoothing():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 9, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 9)).astype(np.int32)
    labels[0, :4] = -1
    for smoothing in (0.0, 0.1):
        want = float(jts.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels), smoothing))
        got = tts.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), smoothing)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * abs(want)
    none = tts.cross_entropy(torch.from_numpy(logits),
                             torch.full((3, 9), -1, dtype=torch.int32))
    assert float(none) == 0.0


@pytest.mark.parametrize("arch", ["llama3-8b", "olmo-1b"])
def test_loss_and_gradients_match(arch):
    """One microbatch: the loss and every stacked leaf's gradient against
    ``jax.value_and_grad`` of the reference's loss; with ``remat`` the
    port's gradients are the same bits."""
    cfg_j, cfg = _cfgs(arch)
    params_j = jt.init_params(cfg_j, jax.random.PRNGKey(0))
    batch_j, batch = _batch(cfg.vocab)
    (_, (loss_j, _)), grads_j = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(cfg_j, jts.TrainConfig()), has_aux=True))(
        params_j, batch_j)
    params = convert.lm_params_from_jax(cfg, params_j, "cpu")
    params.requires_grad_(True)
    got = {}
    for remat in (False, True):
        loss_fn = tts.make_loss_fn(dataclasses.replace(cfg, remat=remat),
                                   tts.TrainConfig())
        total, (loss, _) = loss_fn(params, batch)
        assert abs(float(loss.detach()) - float(loss_j)) <= \
            LOSS_RTOL * abs(float(loss_j))
        got[remat] = _grads(params, total)
    for name, want in tts.unnest(grads_j).items():
        want = np.asarray(want)
        diff = np.abs(got[False][name].numpy() - want).max()
        assert diff <= GRAD_TOL * np.abs(want).max(), name
        assert torch.equal(got[True][name], got[False][name]), name


@pytest.mark.parametrize("compression", ["none", "int8", "delta"])
def test_train_step_matches(compression):
    cfg_j, cfg = _cfgs("llama3-8b")
    acfg = jo.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=3)
    tcfg_j = jts.TrainConfig(adamw=acfg, microbatches=2,
                             compression=compression)
    tcfg = tts.TrainConfig(adamw=to.AdamWConfig(**dataclasses.asdict(acfg)),
                           microbatches=2, compression=compression)
    state_j = jts.init_train_state(cfg_j, tcfg_j, jax.random.PRNGKey(0))
    state = convert.train_state_from_jax(cfg, state_j, "cpu")
    assert (state.residuals is None) == (compression == "none")
    step_j = jax.jit(jts.make_train_step(cfg_j, tcfg_j))
    step = tts.make_train_step(cfg, tcfg)
    for i in range(3):
        batch_j, batch = _batch(cfg.vocab, step=i)
        state_j, met_j = step_j(state_j, batch_j)
        state, met = step(state, batch)
        if i == 0:
            for key in ("loss", "grad_norm", "lr"):
                assert abs(float(met[key]) - float(met_j[key])) <= \
                    STEP0_RTOL * abs(float(met_j[key])), key
            assert met["wire_bytes"].dtype == torch.float32
            assert float(met["wire_bytes"]) == float(met_j["wire_bytes"])
    assert abs(float(met["loss"]) - float(met_j["loss"])) <= \
        STEP3_RTOL * abs(float(met_j["loss"]))
    assert int(state.opt.step) == int(state_j.opt.step) == 3


def _ckpt_arrays(root, step):
    with np.load(os.path.join(root, "node0",
                              f"full_{step:08d}_of0.npz")) as f:
        return {k: np.array(f[k]) for k in f.files}


def test_launch_train_resume_is_bit_for_bit(tmp_path, capsys):
    """``--reduced``, 4 steps with a checkpoint every 2, run straight; and
    the same run cut after its step-2 checkpoint and resumed with
    ``--resume``: the final checkpoints are the same bytes."""
    straight, cut = str(tmp_path / "straight"), str(tmp_path / "cut")
    args = ["--device", "cpu", "--reduced", "--steps", "4", "--seq-len",
            "32", "--global-batch", "4", "--microbatches", "2",
            "--compression", "delta", "--ckpt-every", "2"]
    ttrain.main(args + ["--ckpt-dir", straight])
    ttrain.main(args + ["--ckpt-dir", cut])
    os.remove(os.path.join(cut, "node0", "full_00000004_of0.npz"))
    ttrain.main(args + ["--ckpt-dir", cut, "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and out.count("done.") == 3
    a, b = _ckpt_arrays(straight, 4), _ckpt_arrays(cut, 4)
    assert a.keys() == b.keys() and "__sum__" in a
    assert all(np.array_equal(a[k], b[k]) for k in a)
    res = ttrain.train(get_arch("olmo-1b").reduced(), 4, seq_len=32,
                       global_batch=4, microbatches=2, compression="delta",
                       ckpt_dir=str(tmp_path / "again"), ckpt_every=0,
                       device="cpu", log=lambda *_: None)
    assert len(res.losses) == len(res.walls) == 4
    assert all(np.isfinite(res.losses)) and res.metrics[0]["wire_bytes"] > 0
    tree = tts.checkpoint_tree(res.state)
    flat = CheckpointManager(straight).load_full(0, tree)[0]
    assert all(torch.equal(x, y) for x, y in zip(
        jax.tree.leaves(tree), jax.tree.leaves(flat)))


def _random_state_j(cfg_j, seed):
    """A reference TrainState with every leaf drawn (delta residuals)."""
    params = jt.init_params(cfg_j, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def draw(tree):
        return jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32)), tree)
    return jts.TrainState(
        params=params, opt=jo.AdamWState(step=jnp.asarray(7, jnp.int32),
                                         mu=draw(params), nu=draw(params)),
        residuals=draw(params))


def _same_tree(a, b):
    """Leaf for leaf the same dtype, shape and bytes (the port's bf16 bits,
    dtype 'V2', against ml_dtypes' bfloat16)."""
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        names = {str(x.dtype), str(y.dtype)}
        assert x.dtype == y.dtype or names == {"|V2", "bfloat16"}
        assert x.shape == y.shape and x.tobytes() == y.tobytes()


def test_each_package_resumes_the_others_float32_checkpoint(tmp_path):
    cfg_j, cfg = _cfgs("llama3-8b")
    state_j = _random_state_j(cfg_j, 1)
    # The reference writes, the port reads.
    JCheckpointManager(str(tmp_path / "j")).save_full(0, 3, state_j)
    state = convert.train_state_from_jax(cfg, _random_state_j(cfg_j, 2),
                                         "cpu")
    tree, step = CheckpointManager(str(tmp_path / "j")).load_full(
        0, tts.checkpoint_tree(state))
    state = tts.restore_tree(state, tree)
    assert step == 3
    _same_tree(convert.train_state_to_jax(state), state_j)
    # The port writes, the reference reads.
    state = convert.train_state_from_jax(cfg, _random_state_j(cfg_j, 3),
                                         "cpu")
    CheckpointManager(str(tmp_path / "t")).save_full(
        0, 5, tts.checkpoint_tree(state))
    back, step = JCheckpointManager(str(tmp_path / "t")).load_full(
        0, state_j)
    assert step == 5
    _same_tree(back, convert.train_state_to_jax(state))
    # The resumed state trains on: one step each, the same loss.
    batch_j, batch = _batch(cfg.vocab)
    tcfg_j = jts.TrainConfig(compression="delta")
    _, met_j = jax.jit(jts.make_train_step(cfg_j, tcfg_j))(back, batch_j)
    _, met = tts.make_train_step(cfg, tts.TrainConfig(
        compression="delta"))(state, batch)
    assert abs(float(met["loss"]) - float(met_j["loss"])) <= \
        LOSS_RTOL * abs(float(met_j["loss"]))


def test_bf16_checkpoints(tmp_path):
    """A bf16 TrainState round-trips in the port bit for bit, and the port
    reads the reference's bf16 file bit for bit (the reference itself
    cannot: its digest reads the dtype back as '|V2')."""
    cfg_j, cfg = _cfgs("olmo-1b", dtype="bfloat16")
    state = tts.init_train_state(cfg, tts.TrainConfig(compression="int8"),
                                 torch.Generator().manual_seed(0), "cpu")
    assert state.params.embed.dtype == torch.bfloat16
    mgr = CheckpointManager(str(tmp_path / "t"))
    mgr.save_full(0, 1, tts.checkpoint_tree(state))
    with np.load(str(tmp_path / "t" / "node0" / "full_00000001_of0.npz")
                 ) as f:
        assert f[".params/['embed']"].dtype == np.dtype("V2")
    fresh = tts.init_train_state(cfg, tts.TrainConfig(compression="int8"),
                                 torch.Generator().manual_seed(9), "cpu")
    tree, _ = mgr.load_full(0, tts.checkpoint_tree(fresh))
    fresh = tts.restore_tree(fresh, tree)
    for x, y in zip(jax.tree.leaves(tts.checkpoint_tree(fresh)),
                    jax.tree.leaves(tts.checkpoint_tree(state))):
        assert x.dtype == y.dtype and torch.equal(x, y)

    state_j = jts.init_train_state(cfg_j, jts.TrainConfig(),
                                   jax.random.PRNGKey(4))
    JCheckpointManager(str(tmp_path / "j")).save_full(0, 2, state_j)
    port = tts.init_train_state(cfg, tts.TrainConfig(),
                                torch.Generator().manual_seed(1), "cpu")
    tree, _ = CheckpointManager(str(tmp_path / "j")).load_full(
        0, tts.checkpoint_tree(port))
    _same_tree(convert.train_state_to_jax(tts.restore_tree(port, tree)),
               state_j)


def test_serving_records_no_graph():
    """Parameters ask for no gradient after init_params, and serving a
    model that trains (its parameters asking for gradients) records no
    autograd graph."""
    cfg = get_arch("olmo-1b").reduced()
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in params.parameters())
    prompt = TokenPipeline(cfg.vocab, 8, 2, device="cpu").batch_at(0)[
        "tokens"]
    res = tserve.serve(cfg, params, prompt, 3)
    assert not any(p.requires_grad for p in params.parameters())
    state = tts.init_train_state(cfg, tts.TrainConfig(),
                                 torch.Generator().manual_seed(0), "cpu")
    assert all(p.requires_grad for p in state.params.parameters())
    res = tserve.serve(cfg, state.params, prompt, 3)
    assert res.prefill_logits.grad_fn is None
    assert not res.prefill_logits.requires_grad


def test_sharded_training_raises_naming_its_slice():
    """``--mesh 2x1`` without a process group of 2 ranks raises, naming
    the group it needs (as ``flat_mesh`` does); ``--mesh 1x1`` without
    one is the one-device loop; a gather hook on unsharded parameters
    gives the same loss (``tests/test_torch_sharded_lm.py`` trains on
    meshes)."""
    cfg = get_arch("olmo-1b").reduced()
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        ttrain.train(cfg, 1, mesh="2x1", device="cpu")
    kw = dict(seq_len=16, global_batch=2, ckpt_every=0, device="cpu",
              log=lambda *_: None)
    one = ttrain.train(cfg, 2, mesh="1x1", **kw)
    plain = ttrain.train(cfg, 2, **kw)
    assert one.losses == plain.losses
    from repro_torch.launch.sharding import make_gather_fn
    batch = TokenPipeline(cfg.vocab, 16, 2, device="cpu").batch_at(0)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        plain_loss = tts.make_loss_fn(cfg, tts.TrainConfig())(params, batch)
        hooked = tts.make_loss_fn(cfg, tts.TrainConfig(
            gather_fn=make_gather_fn(None)))(params, batch)
    assert torch.equal(plain_loss[0], hooked[0])
