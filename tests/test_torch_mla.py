"""The port's multi-head latent attention (MLA, minicpm3-4b) against the
reference's ``models/attention.py`` and ``models/transformer.py``.

At ``reduced()`` size, float32: 2 layers, d 64, 4 heads, q·k width 16 +
8 rope, v width 16, q rank 48, kv rank 32, d_ff 128, vocab 256.  The
module cases draw their weights and inputs from numpy with a seed; the
model cases carry the reference's weights into the port with
``convert.lm_params_from_jax``.

Tolerances, float32 (the port's LM tests' bound): attention outputs,
logits and cache tensors within 2e-5 abs + 2e-5 rel (readings: at most
6e-6 on logits of |logit| <= 4.0); greedy tokens exact (the reference's
best two logits at every compared step at least 1e-3 apart, so a token
cannot flip on rounding); one train step's loss, grad_norm and lr within
1e-5 relative and each parameter leaf within 1e-4 of its largest |value|
(``tests/test_torch_train.py``'s bounds); checkpoints bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as j_get_arch
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.runtime.checkpoint import CheckpointManager as JCheckpointManager
from repro.train import optimizer as jo
from repro.train import train_step as jts
from repro.train.serve_step import generate as j_generate

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tt
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.serve import serve_step as tss
from repro_torch.train import optimizer as to
from repro_torch.train import train_step as tts
from torch_threads import one_torch_thread  # noqa: F401

NAME = "minicpm3-4b"
ATOL = RTOL = 2e-5
STEP_RTOL = 1e-5
PARAM_TOL = 1e-4      # of each leaf's max |value|
B, T, NEW = 2, 48, 8
MLA_LEAVES = ("kv_norm", "q_norm", "w_dkv", "w_dq", "w_kr", "w_uk", "w_uq",
              "w_uv", "wo")


def _cfgs(**kw):
    return (dataclasses.replace(j_get_arch(NAME).reduced(), **kw),
            dataclasses.replace(get_arch(NAME).reduced(), **kw))


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _mla_case(seed=0, t=T):
    """(cfg_j, cfg, reference params, port MLA, x, positions): weights,
    norm scales (not 1, so they count) and x drawn from numpy."""
    cfg_j, cfg = _cfgs()
    rng = np.random.default_rng(seed)
    params = attn.MLA(cfg, "cpu")
    with torch.no_grad():
        for name, p in params.named_parameters():
            if name.endswith("norm"):
                v = 1.0 + 0.1 * rng.standard_normal(p.shape)
            else:
                v = rng.standard_normal(p.shape) * p.shape[0] ** -0.5
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    params_j = {n: jnp.asarray(p.numpy())
                for n, p in params.named_parameters()}
    x = rng.standard_normal((B, t, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (B, t)).copy()
    return cfg_j, cfg, params_j, params, x, pos


class Model:
    def __init__(self):
        self.cfg_j, self.cfg = _cfgs()
        self.params_j = jt.init_params(self.cfg_j, jax.random.PRNGKey(0))
        self.params = convert.lm_params_from_jax(self.cfg, self.params_j,
                                                 "cpu")
        rng = np.random.default_rng(3)
        self.tokens_all = torch.from_numpy(
            rng.integers(0, self.cfg.vocab, (B, T + NEW)).astype(np.int32))
        self.tokens = self.tokens_all[:, :T].contiguous()


_MODELS = {}


def model() -> Model:
    if NAME not in _MODELS:
        _MODELS[NAME] = Model()
    return _MODELS[NAME]


@pytest.fixture(autouse=True, scope="module")
def _drop_models():
    yield
    _MODELS.clear()
    jax.clear_caches()


# ---------------------------------------------------------------------------
# The MLA module: train, prefill, absorbed decode.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blocked", [False, True])
def test_mla_train_matches_reference(blocked, monkeypatch):
    """``blocked`` lowers both packages' BLOCKED_THRESHOLD below T·T, so
    both take blocked_attention (q·k width 24, v width 16)."""
    if blocked:
        monkeypatch.setattr(attn, "BLOCKED_THRESHOLD", T * T - 1)
        monkeypatch.setattr(jattn, "BLOCKED_THRESHOLD", T * T - 1)
        seen = []
        real = attn.blocked_attention
        monkeypatch.setattr(attn, "blocked_attention",
                            lambda *a, **k: seen.append(a[0].shape) or
                            real(*a, **k))
    cfg_j, cfg, params_j, params, x, pos = _mla_case()
    before = (fa_ops.launches, fa_ops.launches_bf16)
    got = attn.mla_train(cfg, params, torch.from_numpy(x),
                         torch.from_numpy(pos))
    assert (fa_ops.launches, fa_ops.launches_bf16) == before
    want = jax.jit(lambda p, v, i: jattn.mla_train(cfg_j, p, v, i))(
        params_j, jnp.asarray(x), jnp.asarray(pos))
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want)
    if blocked:
        assert seen == [(B, cfg.n_heads, T, cfg.hd + cfg.mla_rope_dim)]


@pytest.mark.parametrize("max_len", [T, T + NEW])
def test_mla_prefill_matches_reference(max_len):
    cfg_j, cfg, params_j, params, x, pos = _mla_case(seed=1)
    y, cache = attn.mla_prefill(cfg, params, torch.from_numpy(x),
                                torch.from_numpy(pos), max_len)
    y_j, cache_j = jax.jit(lambda p, v, i: jattn.mla_prefill(
        cfg_j, p, v, i, max_len))(params_j, jnp.asarray(x), jnp.asarray(pos))
    _close(y, y_j)
    assert cache["c"].shape == (B, max_len, cfg.mla_kv_rank)
    assert cache["kr"].shape == (B, max_len, cfg.mla_rope_dim)
    for key in ("c", "kr"):
        _close(cache[key], cache_j[key])
        assert not cache[key][:, T:].any()


def test_mla_prefill_refuses_a_short_cache():
    _, cfg, _, params, x, pos = _mla_case()
    with pytest.raises(ValueError, match="cannot hold"):
        attn.mla_prefill(cfg, params, torch.from_numpy(x),
                         torch.from_numpy(pos), T - 1)


def test_mla_decode_matches_reference():
    """NEW absorbed decode steps after a prefill of T - NEW tokens: each
    step's output and the latent cache against the reference's, the
    port's cache written in place."""
    cfg_j, cfg, params_j, params, x, pos = _mla_case(seed=2)
    start = T - NEW
    xt = torch.from_numpy(x)
    _, cache = attn.mla_prefill(cfg, params, xt[:, :start],
                                torch.from_numpy(pos[:, :start]), T)
    _, cache_j = jax.jit(lambda p, v, i: jattn.mla_prefill(
        cfg_j, p, v, i, T))(params_j, jnp.asarray(x[:, :start]),
                            jnp.asarray(pos[:, :start]))
    full = attn.mla_train(cfg, params, xt, torch.from_numpy(pos))
    step_j = jax.jit(lambda p, xi, c, i: jattn.mla_decode(cfg_j, p, xi, c,
                                                          i))
    for i in range(start, T):
        y, same = attn.mla_decode(cfg, params, xt[:, i:i + 1], cache,
                                  torch.tensor(i, dtype=torch.int32))
        assert same is cache
        y_j, cache_j = step_j(params_j, jnp.asarray(x[:, i:i + 1]), cache_j,
                              jnp.asarray(i, jnp.int32))
        _close(y, y_j)
        _close(y[:, 0], full[:, i].numpy())
    for key in ("c", "kr"):
        _close(cache[key], cache_j[key])


def test_blocked_attention_with_a_narrower_value_matches_reference():
    """D = 24 against Dv = 16, the MLA shape, S not a multiple of
    block_k."""
    rng = np.random.default_rng(5)
    q, k = (rng.standard_normal((1, 4, 300, 24)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((1, 4, 300, 16)).astype(np.float32)
    for causal in (True, False):
        got = attn.blocked_attention(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal, block_k=128)
        want = jattn.blocked_attention(*map(jnp.asarray, (q, k, v)),
                                       causal=causal, block_k=128)
        assert got.shape == v.shape[:3] + (16,)
        _close(got, want)


# ---------------------------------------------------------------------------
# The model: forward, prefill, decode, serving.
# ---------------------------------------------------------------------------

def test_forward_matches_reference():
    m = model()
    logits, aux = tt.forward(m.cfg, m.params, m.tokens)
    cfg = m.cfg_j
    logits_j, _ = jax.jit(lambda p, t: jt.forward(cfg, p, t))(
        m.params_j, jnp.asarray(m.tokens.numpy()))
    assert logits.dtype == torch.float32 and logits.shape == (B, T, 256)
    assert float(aux) == 0.0
    _close(logits, logits_j)


def test_forward_and_prefill_from_embeds_match_reference():
    """``embeds`` in place of the tokens (minicpm3 unties its head, so the
    embedding is not read at all)."""
    m = model()
    rng = np.random.default_rng(7)
    emb = (rng.standard_normal((B, T, m.cfg.d_model)) * 0.1
           ).astype(np.float32)
    cfg = m.cfg_j
    got, _ = tt.forward(m.cfg, m.params, None, embeds=torch.from_numpy(emb))
    want, _ = jax.jit(lambda p, t, e: jt.forward(cfg, p, t, embeds=e))(
        m.params_j, jnp.asarray(m.tokens.numpy()), jnp.asarray(emb))
    _close(got, want)
    logits, cache = tt.prefill_forward(m.cfg, m.params, None, T + NEW,
                                       embeds=torch.from_numpy(emb))
    logits_j, cache_j = jax.jit(
        lambda p, t, e: jt.prefill_forward(cfg, p, t, T + NEW, embeds=e))(
        m.params_j, jnp.asarray(m.tokens.numpy()), jnp.asarray(emb))
    _close(logits, logits_j)
    _close(logits[:, 0], got[:, -1].numpy())
    for u, layer in enumerate(cache["layers"]):
        for key in ("c", "kr"):
            _close(layer["attn"][key],
                   np.asarray(cache_j["units"]["b0_mla"]["attn"][key][u]))


def test_serve_steps_match_reference():
    """prefill_forward, then serve_step against the reference's
    decode_step, tokens equal, the latent caches within 2e-5."""
    m = model()
    cfg = m.cfg_j
    max_len = T + NEW
    logits, cache = tt.prefill_forward(m.cfg, m.params, m.tokens, max_len)
    logits_j, cache_j = jax.jit(
        lambda p, t: jt.prefill_forward(cfg, p, t, max_len))(
        m.params_j, jnp.asarray(m.tokens.numpy()))
    _close(logits, logits_j)
    first = torch.argmax(logits[:, 0], -1).to(torch.int32)[:, None]
    state = tss.ServeState(cache, torch.tensor(T, dtype=torch.int32), first)
    tok_j = jnp.argmax(logits_j[:, 0], -1).astype(jnp.int32)[:, None]
    np.testing.assert_array_equal(first.numpy(), np.asarray(tok_j))
    step_j = jax.jit(lambda p, tok, c, pos: jt.decode_step(cfg, p, tok, c,
                                                           pos))
    pos_j, c_j = jnp.asarray(T, jnp.int32), cache_j
    for _ in range(NEW):
        lj, c_j = step_j(m.params_j, tok_j, c_j, pos_j)
        top2 = np.sort(np.asarray(lj[:, 0]), axis=-1)[:, -2:]
        assert float((top2[:, 1] - top2[:, 0]).min()) > 1e-3
        tok_j = jnp.argmax(lj[:, 0], -1).astype(jnp.int32)[:, None]
        pos_j = pos_j + 1
        tok, state = tss.serve_step(m.cfg, m.params, state)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))
    for u, layer in enumerate(state.cache["layers"]):
        for key in ("c", "kr"):
            _close(layer["attn"][key],
                   np.asarray(c_j["units"]["b0_mla"]["attn"][key][u]))


def test_generate_matches_reference():
    m = model()
    prompt = m.tokens[:, :12].contiguous()
    got = tss.generate(m.cfg, m.params, prompt, NEW, 12 + NEW)
    cfg = m.cfg_j
    want = jax.jit(lambda p, t: j_generate(cfg, p, t, NEW, 12 + NEW))(
        m.params_j, jnp.asarray(prompt.numpy()))
    assert got.dtype == torch.int32 and got.shape == (B, 12 + NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_teacher_forced_decode_equals_forward():
    """The absorbed decode (attention in latent space, scores over
    sqrt(nope + rope)) after a prefill equals the forward over the
    extended sequence."""
    m = model()
    full, _ = tt.forward(m.cfg, m.params, m.tokens_all)
    _, cache = tt.prefill_forward(m.cfg, m.params, m.tokens, T + NEW)
    for i in range(NEW):
        logits, cache = tt.decode_step(m.cfg, m.params,
                                       m.tokens_all[:, T + i:T + i + 1],
                                       cache, torch.tensor(T + i))
        _close(logits[:, 0], full[:, T + i].numpy())


def test_launch_serve_runs_minicpm3_reduced_on_the_cpu(capsys):
    tserve.main(["--arch", NAME, "--reduced", "--device", "cpu",
                 "--prompt-len", "20", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill [4x20]" in out and "decoded 3 steps" in out


# ---------------------------------------------------------------------------
# Parameters, training and checkpoints.
# ---------------------------------------------------------------------------

def test_convert_carries_every_mla_leaf():
    m = model()
    leaves = tt.stacked_leaves(m.params)
    flat_j = tts.unnest(m.params_j)
    assert list(leaves) == list(flat_j)
    assert [k.split(".")[-1] for k in leaves
            if k.startswith("units.b0_mla.attn.")] == list(MLA_LEAVES)
    for leaf, ps in leaves.items():
        want = np.asarray(flat_j[leaf])
        got = (torch.stack(ps) if tt.is_stacked(leaf) else ps[0]).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), leaf


def test_bf16_mla_leaves_carry_their_bits():
    cfg_j, cfg = _cfgs(dtype="bfloat16")
    params_j = jt.init_params(cfg_j, jax.random.PRNGKey(1))
    params = convert.lm_params_from_jax(cfg, params_j, "cpu")
    a, a_j = params.layers[1].attn, params_j["units"]["b0_mla"]["attn"]
    assert a.q_norm.dtype == a.kv_norm.dtype == torch.float32
    for name in ("w_uq", "w_kr", "wo"):
        got = getattr(a, name)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                      np.asarray(a_j[name][1]).view(np.uint16))


def test_init_params_draws_the_mla_leaves():
    cfg = get_arch(NAME).reduced()
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    a = params.layers[0].attn
    for w, std in ((a.w_dq, cfg.d_model ** -0.5),
                   (a.w_uq, cfg.mla_q_rank ** -0.5),
                   (a.w_uk, cfg.mla_kv_rank ** -0.5),
                   (a.w_kr, cfg.d_model ** -0.5),
                   (a.wo, (cfg.n_heads * cfg.hd) ** -0.5)):
        assert abs(float(w.std()) / std - 1.0) < 0.15
    assert torch.equal(a.q_norm, torch.ones(cfg.mla_q_rank))
    assert not torch.equal(params.layers[0].attn.w_uv,
                           params.layers[1].attn.w_uv)


def test_train_step_from_embeds_matches():
    """One AdamW step (2 microbatches) on a batch with ``embeds`` and
    [B, T] ``positions``: loss, grad_norm and lr, then every parameter
    leaf.  The untied embedding is not read, so its gradient is zero in
    both packages."""
    cfg_j, cfg = _cfgs()
    acfg = jo.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=3)
    tcfg_j = jts.TrainConfig(adamw=acfg, microbatches=2)
    tcfg = tts.TrainConfig(adamw=to.AdamWConfig(**dataclasses.asdict(acfg)),
                           microbatches=2)
    state_j = jts.init_train_state(cfg_j, tcfg_j, jax.random.PRNGKey(0))
    state = convert.train_state_from_jax(cfg, state_j, "cpu")
    batch_j = dict(JTokenPipeline(cfg.vocab, 32, 4).batch_at(0))
    rng = np.random.default_rng(4)
    batch_j["embeds"] = jnp.asarray(
        (rng.standard_normal((4, 32, cfg.d_model)) * 0.1).astype(np.float32))
    batch_j["positions"] = jnp.asarray(
        np.broadcast_to(np.arange(5, 37, dtype=np.int32), (4, 32)))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in batch_j.items()}
    state_j, met_j = jax.jit(jts.make_train_step(cfg_j, tcfg_j))(state_j,
                                                                 batch_j)
    embed_before = state.params.embed.detach().clone()
    state, met = tts.make_train_step(cfg, tcfg)(state, batch)
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(met[key]) - float(met_j[key])) <= \
            STEP_RTOL * abs(float(met_j[key])), key
    assert float(state.opt.mu["embed"].abs().max()) == 0.0
    assert not torch.equal(state.params.embed, embed_before)  # decay only
    got = convert.train_state_to_jax(state)
    for name, want in tts.unnest(state_j.params).items():
        want = np.asarray(want)
        diff = np.abs(tts.unnest(got.params)[name] - want).max()
        assert diff <= PARAM_TOL * np.abs(want).max(), name


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
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_each_package_reads_the_others_mla_checkpoint(tmp_path):
    cfg_j, cfg = _cfgs()
    state_j = _random_state_j(cfg_j, 1)
    JCheckpointManager(str(tmp_path / "j")).save_full(0, 3, state_j)
    state = convert.train_state_from_jax(cfg, _random_state_j(cfg_j, 2),
                                         "cpu")
    tree, step = CheckpointManager(str(tmp_path / "j")).load_full(
        0, tts.checkpoint_tree(state))
    state = tts.restore_tree(state, tree)
    assert step == 3
    _same_tree(convert.train_state_to_jax(state), state_j)
    state = convert.train_state_from_jax(cfg, _random_state_j(cfg_j, 3),
                                         "cpu")
    CheckpointManager(str(tmp_path / "t")).save_full(
        0, 5, tts.checkpoint_tree(state))
    back, step = JCheckpointManager(str(tmp_path / "t")).load_full(
        0, state_j)
    assert step == 5
    _same_tree(back, convert.train_state_to_jax(state))
    assert "w_uk" in back.params["units"]["b0_mla"]["attn"]
