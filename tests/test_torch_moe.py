"""The port's Mixture-of-Experts and sliding-window paths against the
reference's ``models/moe.py``, ``models/attention.py`` and
``models/transformer.py``.

At ``reduced()`` size, float32: arctic-480b (4 experts, top-2, dense
residual, full attention) and mixtral-8x22b (4 experts, top-2, window 16),
2 layers, d 64, 4 heads of 16, d_ff 128, vocab 256.  The reference's
weights are carried into the port with ``convert.lm_params_from_jax``;
``moe_ffn``'s own cases draw their weights and inputs from numpy with a
seed.

Tolerances: ``moe_ffn`` outputs within 1e-5 of max |y| and the aux loss
within 1e-6 relative; window and blocked attention within 1e-6 of max
|out|; logits within 1e-4 of the largest, aux within 1e-6 relative; cache
tensors within 2e-5 abs + 2e-5 rel, cache positions and greedy tokens
exact (the reference's best two logits at every compared step at least
1e-3 apart, so a token cannot flip on rounding); one train step's loss,
aux, grad_norm and lr within 1e-5 relative and each parameter leaf within
1e-4 of its largest |value| (``tests/test_torch_train.py``'s bounds).
``moe_ffn``'s cases also check that no token's k-th and (k+1)-th router
probabilities lie within 1e-5 of each other, and that the expert choices
are the reference's.
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
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.train import optimizer as jo
from repro.train import train_step as jts
from repro.train.serve_step import generate as j_generate

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import transformer as tt
from repro_torch.serve import serve_step as tss
from repro_torch.train import optimizer as to
from repro_torch.train import train_step as tts
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["arctic-480b", "mixtral-8x22b"]
Y_TOL = 1e-5          # of max |y|
AUX_RTOL = 1e-6
ATTN_TOL = 1e-6       # of max |out|
LOGIT_TOL = 1e-4      # of max |logit|
ATOL = RTOL = 2e-5    # cache tensors
STEP_RTOL = 1e-5
PARAM_TOL = 1e-4      # of each leaf's max |value|
TIE_GAP = 1e-5
B, T, NEW = 2, 64, 8


def _cfgs(name, **kw):
    return (dataclasses.replace(j_get_arch(name).reduced(), **kw),
            dataclasses.replace(get_arch(name).reduced(), **kw))


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _no_near_ties(probs, k):
    """The k-th and (k+1)-th largest of each row are apart."""
    s = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    assert float((s[:, k - 1] - s[:, k]).min()) > TIE_GAP


class Model:
    def __init__(self, name):
        self.cfg_j, self.cfg = _cfgs(name)
        self.params_j = jt.init_params(self.cfg_j, jax.random.PRNGKey(0))
        self.params = convert.lm_params_from_jax(self.cfg, self.params_j,
                                                 "cpu")
        rng = np.random.default_rng(3)
        self.tokens_all = torch.from_numpy(
            rng.integers(0, self.cfg.vocab, (B, T + NEW)).astype(np.int32))
        self.tokens = self.tokens_all[:, :T].contiguous()


_MODELS = {}


def model(name) -> Model:
    if name not in _MODELS:
        _MODELS[name] = Model(name)
    return _MODELS[name]


@pytest.fixture(autouse=True, scope="module")
def _drop_models():
    yield
    _MODELS.clear()
    jax.clear_caches()


# ---------------------------------------------------------------------------
# moe_ffn.
# ---------------------------------------------------------------------------

def _moe_case(name, capacity_factor, seed=0, zero_router=False):
    """(cfg_j, cfg, reference params, port MoE, x) with weights drawn from
    numpy; expert 0's router column is tilted towards the inputs' mean so
    that it draws most tokens (and overflows at capacity_factor 1.25)."""
    cfg_j, cfg = _cfgs(name, capacity_factor=capacity_factor)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    rng = np.random.default_rng(seed)
    w = {"router": rng.standard_normal((d, e)) * d ** -0.5,
         "w_gate": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_up": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_down": rng.standard_normal((e, f, d)) * f ** -0.5}
    w["router"][:, 0] += 0.05
    if zero_router:
        w["router"][:] = 0.0
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = (rng.standard_normal((B, T, d)) + 1.0).astype(np.float32)
    params = moe.MoE(cfg, "cpu")
    with torch.no_grad():
        for k, v in w.items():
            getattr(params, k).copy_(torch.from_numpy(v))
        if cfg.moe_dense_residual:
            for k in ("w_gate", "w_up", "w_down"):
                shape = getattr(params.dense, k).shape
                v = (rng.standard_normal(shape) * shape[0] ** -0.5
                     ).astype(np.float32)
                getattr(params.dense, k).copy_(torch.from_numpy(v))
    params_j = {k: jnp.asarray(getattr(params, k).numpy())
                for k in ("router", "w_gate", "w_up", "w_down")}
    if cfg.moe_dense_residual:
        params_j["dense"] = {k: jnp.asarray(v.numpy()) for k, v in
                             params.dense.named_parameters()}
    return cfg_j, cfg, params_j, params, x


@pytest.mark.parametrize("strategy", ["sort", "onehot"])
@pytest.mark.parametrize("capacity_factor", [1.25, 16.0])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_ffn_matches_reference(name, capacity_factor, strategy):
    cfg_j, cfg, params_j, params, x = _moe_case(name, capacity_factor)
    n = B * T
    cap = moe._capacity(cfg, n)
    assert cap == jmoe._capacity(cfg_j, n)
    top_e, top_p, _ = moe._route(cfg, params, torch.from_numpy(
        x.reshape(n, -1)))
    probs = torch.softmax(torch.from_numpy(x.reshape(n, -1)) @
                          params.router, -1)
    _no_near_ties(probs.numpy(), cfg.top_k)
    counts = np.bincount(top_e.numpy().ravel(), minlength=cfg.n_experts)
    # 1.25 drops copies (expert 0 overflows); 16 keeps them all.
    assert (counts.max() > cap) == (capacity_factor == 1.25)
    y, aux = moe.moe_ffn(cfg, params, torch.from_numpy(x), strategy)
    y_j, aux_j = jax.jit(lambda p, v: jmoe.moe_ffn(cfg_j, p, v, strategy))(
        params_j, jnp.asarray(x))
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert _rel(y, y_j) <= Y_TOL
    assert abs(float(aux) - float(aux_j)) <= AUX_RTOL * abs(float(aux_j))
    ej, pj, _ = jmoe._route(cfg_j, params_j, jnp.asarray(x.reshape(n, -1)))
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(ej))


@pytest.mark.parametrize("strategy", ["sort", "onehot"])
def test_equal_probabilities_keep_the_reference_copies(strategy):
    """A zero router makes every probability equal: each token picks the
    lowest-indexed experts (0 and 1), and their capacity goes to the
    earliest tokens; the others get no expert output."""
    cfg_j, cfg, params_j, params, x = _moe_case("mixtral-8x22b", 1.25,
                                                zero_router=True)
    n = B * T
    cap = moe._capacity(cfg, n)
    top_e, top_p, _ = moe._route(cfg, params, torch.from_numpy(
        x.reshape(n, -1)))
    assert top_e.tolist() == [[0, 1]] * n
    assert torch.equal(top_p, torch.full((n, 2), 0.5))
    y, aux = moe.moe_ffn(cfg, params, torch.from_numpy(x), strategy)
    y_j, aux_j = jax.jit(lambda p, v: jmoe.moe_ffn(cfg_j, p, v, strategy))(
        params_j, jnp.asarray(x))
    assert _rel(y, y_j) <= Y_TOL
    assert float(aux) == float(aux_j)
    served = y.reshape(n, -1).abs().amax(-1) > 0
    assert served.tolist() == [True] * cap + [False] * (n - cap)
    assert (np.abs(np.asarray(y_j).reshape(n, -1)).max(-1) > 0).tolist() \
        == served.tolist()


def test_a2a_and_unknown_strategies_raise():
    """a2a needs an ambient mesh with a 'model' axis (as the
    reference's; ``tests/test_torch_sharded_lm.py`` runs it on meshes);
    an unknown strategy raises."""
    _, cfg, _, params, x = _moe_case("mixtral-8x22b", 1.25)
    with pytest.raises(ValueError, match="ambient mesh with a 'model'"):
        moe.moe_ffn(cfg, params, torch.from_numpy(x), "a2a")
    with pytest.raises(ValueError):
        moe.moe_ffn(cfg, params, torch.from_numpy(x), "gather")


def test_rank_in_group_matches_reference():
    owner = np.random.default_rng(1).integers(0, 5, 300).astype(np.int32)
    got = moe._rank_in_group(torch.from_numpy(owner), 5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmoe._rank_in_group(jnp.asarray(owner), 5)))


# ---------------------------------------------------------------------------
# Sliding windows and blocked attention.
# ---------------------------------------------------------------------------

def _qkv(t, seed=0, h=4, h_kv=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((1, h, t, d), (1, h_kv, t, d), (1, h_kv, t, d))]


@pytest.mark.parametrize("causal,window", [(True, 64), (True, 0),
                                           (False, 0)])
def test_blocked_attention_matches_reference(causal, window):
    """T = S = 300 > window, S not a multiple of block_k = 128."""
    q, k, v = _qkv(300)
    got = attn.blocked_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, window=window, block_k=128)
    want = jattn.blocked_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, window=window,
                                   block_k=128)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert _rel(got, want) <= ATTN_TOL
    if window:
        windowed = attn._windowed_attention(*map(torch.from_numpy,
                                                 (q, k, v)), window)
        assert _rel(windowed, jattn._windowed_attention(
            *map(jnp.asarray, (q, k, v)), window)) <= ATTN_TOL
        assert _rel(got, windowed.numpy()) <= ATTN_TOL


# ---------------------------------------------------------------------------
# The model: forward, prefill, decode, serving.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(name):
    m = model(name)
    before = (fa_ops.launches, fa_ops.launches_bf16)
    logits, aux = tt.forward(m.cfg, m.params, m.tokens)
    assert (fa_ops.launches, fa_ops.launches_bf16) == before
    cfg = m.cfg_j
    logits_j, aux_j = jax.jit(lambda p, t: jt.forward(cfg, p, t))(
        m.params_j, jnp.asarray(m.tokens.numpy()))
    assert logits.dtype == torch.float32 and logits.shape == (B, T, 256)
    assert _rel(logits, logits_j) <= LOGIT_TOL
    assert abs(float(aux) - float(aux_j)) <= AUX_RTOL * abs(float(aux_j))
    onehot, aux_o = tt.forward(m.cfg, m.params, m.tokens,
                               moe_strategy="onehot")
    logits_o, aux_oj = jax.jit(lambda p, t: jt.forward(
        cfg, p, t, moe_strategy="onehot"))(m.params_j,
                                           jnp.asarray(m.tokens.numpy()))
    assert _rel(onehot, logits_o) <= LOGIT_TOL
    assert abs(float(aux_o) - float(aux_oj)) <= AUX_RTOL * abs(float(aux_oj))


@pytest.mark.parametrize("name,max_len,blocked", [
    ("arctic-480b", T + NEW, False), ("arctic-480b", T - 8, False),
    ("mixtral-8x22b", T + NEW, False), ("mixtral-8x22b", 12, False),
    ("mixtral-8x22b", T + NEW, True)])
def test_prefill_matches_reference(name, max_len, blocked, monkeypatch):
    """Caches of max(T, max_len) or the window's ring; ``blocked`` lowers
    both packages' BLOCKED_THRESHOLD below T·T, so mixtral's prefill takes
    blocked_attention."""
    if blocked:
        monkeypatch.setattr(attn, "BLOCKED_THRESHOLD", T * T - 1)
        monkeypatch.setattr(jattn, "BLOCKED_THRESHOLD", T * T - 1)
        seen = []
        real = attn.blocked_attention
        monkeypatch.setattr(attn, "blocked_attention",
                            lambda *a, **k: seen.append(1) or real(*a, **k))
    m = model(name)
    logits, cache = tt.prefill_forward(m.cfg, m.params, m.tokens, max_len)
    cfg = m.cfg_j
    logits_j, cache_j = jax.jit(
        lambda p, t: jt.prefill_forward(cfg, p, t, max_len))(
        m.params_j, jnp.asarray(m.tokens.numpy()))
    if blocked:
        assert len(seen) == m.cfg.n_layers
    assert _rel(logits, logits_j) <= LOGIT_TOL
    slots = min(m.cfg.window, max_len) if m.cfg.window else max_len
    for u, layer in enumerate(cache["layers"]):
        want = jax.tree.map(lambda a: np.asarray(a)[u],
                            cache_j["units"]["b0_moe"]["attn"])
        got = layer["attn"]
        assert got["k"].shape[2] == slots
        np.testing.assert_array_equal(got["pos"].numpy(), want["pos"])
        for key in ("k", "v"):
            np.testing.assert_allclose(got[key].numpy(), want[key],
                                       atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ARCHS)
def test_serve_steps_match_reference(name):
    """prefill_forward, then serve_step against the reference's
    decode_step, tokens and cache positions equal; mixtral's ring has
    wrapped (T > window)."""
    m = model(name)
    cfg = m.cfg_j
    max_len = T + NEW
    logits, cache = tt.prefill_forward(m.cfg, m.params, m.tokens, max_len)
    logits_j, cache_j = jax.jit(
        lambda p, t: jt.prefill_forward(cfg, p, t, max_len))(
        m.params_j, jnp.asarray(m.tokens.numpy()))
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
        np.testing.assert_array_equal(
            layer["attn"]["pos"].numpy(),
            np.asarray(c_j["units"]["b0_moe"]["attn"]["pos"][u]))


@pytest.mark.parametrize("name", ARCHS)
def test_generate_matches_reference(name):
    """A prompt of 12 and 8 new tokens: mixtral's decode positions cross
    its window of 16."""
    m = model(name)
    prompt = m.tokens[:, :12].contiguous()
    got = tss.generate(m.cfg, m.params, prompt, NEW, 12 + NEW)
    cfg = m.cfg_j
    want = jax.jit(lambda p, t: j_generate(cfg, p, t, NEW, 12 + NEW))(
        m.params_j, jnp.asarray(prompt.numpy()))
    assert got.dtype == torch.int32 and got.shape == (B, 12 + NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ARCHS)
def test_teacher_forced_decode_equals_forward(name):
    """Decode over 8 teacher-forced steps after a prefill equals the full
    forward over the extended sequence (mixtral: a wrapped ring against
    the window's mask).  A decode step never drops a copy (B tokens, at
    most B <= 8 copies an expert, capacity 8) and the forward drops them
    past capacity, so the forward and the prefill here hold every copy:
    a capacity factor of E / k makes the capacity the token count."""
    m = model(name)
    cfg = dataclasses.replace(m.cfg,
                              capacity_factor=m.cfg.n_experts / m.cfg.top_k)
    assert moe._capacity(cfg, B * (T + NEW)) == B * (T + NEW)
    full, _ = tt.forward(cfg, m.params, m.tokens_all)
    _, cache = tt.prefill_forward(cfg, m.params, m.tokens, T + NEW)
    for i in range(NEW):
        logits, cache = tt.decode_step(cfg, m.params,
                                       m.tokens_all[:, T + i:T + i + 1],
                                       cache, torch.tensor(T + i))
        assert _rel(logits[:, 0], full[:, T + i].numpy()) <= LOGIT_TOL


def test_launch_serve_runs_mixtral_reduced_on_the_cpu(capsys):
    tserve.main(["--arch", "mixtral-8x22b", "--reduced", "--device", "cpu",
                 "--prompt-len", "20", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill [4x20]" in out and "decoded 3 steps" in out


# ---------------------------------------------------------------------------
# Parameters and training.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_convert_carries_every_moe_leaf(name):
    m = model(name)
    leaves = tt.stacked_leaves(m.params)
    flat_j = tts.unnest(m.params_j)
    assert list(leaves) == list(flat_j)
    assert "units.b0_moe.ffn.router" in leaves
    assert ("units.b0_moe.ffn.dense.w_gate" in leaves) == (
        name == "arctic-480b")
    for leaf, ps in leaves.items():
        want = np.asarray(flat_j[leaf])
        got = (torch.stack(ps) if tt.is_stacked(leaf) else ps[0]).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), leaf


def test_bf16_moe_leaves_carry_their_bits():
    cfg_j, cfg = _cfgs("arctic-480b", dtype="bfloat16")
    params_j = jt.init_params(cfg_j, jax.random.PRNGKey(1))
    params = convert.lm_params_from_jax(cfg, params_j, "cpu")
    ffn, ffn_j = params.layers[1].ffn, params_j["units"]["b0_moe"]["ffn"]
    assert ffn.router.dtype == torch.float32
    assert np.array_equal(ffn.router.numpy(), np.asarray(ffn_j["router"][1]))
    for got, want in ((ffn.w_up, ffn_j["w_up"]),
                      (ffn.dense.w_down, ffn_j["dense"]["w_down"])):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.view(torch.uint16).numpy(),
            np.asarray(want[1]).view(np.uint16))


def test_init_params_draws_the_moe_leaves():
    cfg = get_arch("arctic-480b").reduced()
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ffn = params.layers[0].ffn
    for w, std in ((ffn.router, cfg.d_model ** -0.5),
                   (ffn.w_gate, cfg.d_model ** -0.5),
                   (ffn.w_down, cfg.d_ff ** -0.5),
                   (ffn.dense.w_up, cfg.d_model ** -0.5)):
        assert abs(float(w.std()) / std - 1.0) < 0.1
    assert not torch.equal(ffn.w_gate[0], ffn.w_gate[1])


def test_mixtral_train_step_matches():
    """One AdamW step (no compression, 2 microbatches) on reduced mixtral:
    loss, aux, grad_norm and lr, then every parameter leaf."""
    cfg_j, cfg = _cfgs("mixtral-8x22b")
    acfg = jo.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=3)
    tcfg_j = jts.TrainConfig(adamw=acfg, microbatches=2)
    tcfg = tts.TrainConfig(adamw=to.AdamWConfig(**dataclasses.asdict(acfg)),
                           microbatches=2)
    state_j = jts.init_train_state(cfg_j, tcfg_j, jax.random.PRNGKey(0))
    state = convert.train_state_from_jax(cfg, state_j, "cpu")
    batch_j = JTokenPipeline(cfg.vocab, 32, 4).batch_at(0)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in batch_j.items()}
    _, (_, aux_j) = jts.make_loss_fn(cfg_j, tcfg_j)(state_j.params, batch_j)
    _, (_, aux) = tts.make_loss_fn(cfg, tcfg)(state.params, batch)
    assert abs(float(aux.detach()) - float(aux_j)) <= STEP_RTOL * abs(float(aux_j))
    state_j, met_j = jax.jit(jts.make_train_step(cfg_j, tcfg_j))(state_j,
                                                                 batch_j)
    state, met = tts.make_train_step(cfg, tcfg)(state, batch)
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(met[key]) - float(met_j[key])) <= \
            STEP_RTOL * abs(float(met_j[key])), key
    got = convert.train_state_to_jax(state)
    for name, want in tts.unnest(state_j.params).items():
        want = np.asarray(want)
        diff = np.abs(tts.unnest(got.params)[name] - want).max()
        assert diff <= PARAM_TOL * np.abs(want).max(), name
