"""The port's recurrent block kinds against the reference's
``models/rglru.py``, ``models/ssm.py`` and ``models/transformer.py``.

At ``reduced()`` size, float32: recurrentgemma-2b (8 layers: the unit
("rec", "rec", "attn_local") twice and a ("rec", "rec") tail; d 64, 4/1
heads of 16, rnn width 64, conv width 4, window 16, d_ff 128, vocab 256)
and xlstm-350m (4 layers, ("mlstm", "slstm") twice; d 64, 4 heads of 16,
mLSTM chunk 8, no MLP, sinusoid positions, LayerNorm).  The reference's
weights are carried into the port with ``convert.lm_params_from_jax``; the
module cases draw their weights and inputs from numpy with a seed.

Tolerances: module outputs and states within 1e-5 of the reference's max
|value| (each leaf); the scan bit for bit against
``jax.lax.associative_scan`` run op by op, within 1e-6 of max |h| under
``jit``; logits within 1e-4 of the largest; cache tensors within
2e-5 abs + 2e-5 rel, cache positions and greedy tokens exact (the
reference's best two logits at every compared step at least 1e-3 apart,
so a token cannot flip on rounding); one train step's loss, grad_norm and
lr within 1e-5 relative and each parameter leaf within 1e-4 of its largest
|value| (``tests/test_torch_train.py``'s bounds).  The float32 products
and transcendentals of the two frameworks agree to a few ulp, which these
bounds leave room for; XLA may also contract ``a2·b1 + b2`` into a fused
multiply-add, which moves a scan's output by an ulp.

bfloat16, the same weights cast as the reference's bf16 init casts them:
the forward, the prefill's logits and teacher-forced decode steps each
within BF16_FACTOR = 2 times the reference's own distance from the
float32 evaluation of those weights (the largest logit the scale).  Both
packages round the same quantities to bf16 (every ``astype``, every bf16
product's output, the residual stream), but XLA may drop a round trip
that the port makes, so each lies its own bf16 distance from the float32
evaluation, and the two at most the sum of those apart.  Decode's own
distance from that evaluation is held to DECODE_FACTOR times the bf16
forward's, the card's check on the full models.  The port's own bf16
prefill and decode stay within BF16_SELF_TOL (two bf16 ulps of the
largest logit) of its bf16 forward: they round the same quantities at the
same points, on float32 values that differ only in the order of their
sums (chunks or a scan against steps), so a rounding flips only where a
value lies that close to a bf16 boundary, and a flip moves it one ulp.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as j_get_arch
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.models import rglru as jrg
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro.train import optimizer as jo
from repro.train import train_step as jts
from repro.train.serve_step import generate as j_generate

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve as tserve
from repro_torch.models import rglru, ssm
from repro_torch.models import transformer as tt
from repro_torch.serve import serve_step as tss
from repro_torch.train import optimizer as to
from repro_torch.train import train_step as tts
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["recurrentgemma-2b", "xlstm-350m"]
MOD_TOL = 1e-5        # of each leaf's max |value|
SCAN_TOL = 1e-6       # of max |h|
LOGIT_TOL = 1e-4      # of max |logit|
ATOL = RTOL = 2e-5    # cache tensors
STEP_RTOL = 1e-5
PARAM_TOL = 1e-4      # of each leaf's max |value|
BF16_FACTOR = 2      # of the reference's bf16 distance from float32
DECODE_FACTOR = 1.5   # chip_smoke.RECURRENT_DECODE_FACTOR
BF16_SELF_TOL = 2 ** -7  # two bf16 ulps of max |logit|
B, T, NEW = 2, 37, 6  # T past recurrentgemma's reduced window (16)


def _cfgs(name, **kw):
    return (dataclasses.replace(j_get_arch(name).reduced(), **kw),
            dataclasses.replace(get_arch(name).reduced(), **kw))


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


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
        self._prefill_j = {}
        self._bf16 = None
        cfg = self.cfg_j
        self.step_j = jax.jit(lambda p, tok, c, pos: jt.decode_step(
            cfg, p, tok, c, pos))

    def bf16(self):
        """(config pair, reference tree, port LM) of the same weights in
        bf16: each leaf cast to the type the reference's bf16 init gives
        it (its float32 leaves stay float32)."""
        if self._bf16 is None:
            cfgs = _cfgs(self.cfg.name, dtype="bfloat16")
            types = jax.eval_shape(lambda k: jt.init_params(cfgs[0], k),
                                   jax.random.PRNGKey(0))
            params_j = jax.tree.map(lambda x, t: np.asarray(x).astype(
                t.dtype), self.params_j, types)
            self._bf16 = (cfgs, params_j, convert.lm_params_from_jax(
                cfgs[1], params_j, "cpu"))
        return self._bf16

    def prefill_j(self, tokens, max_len):
        """The reference's prefill, one jitted function per ``max_len``
        (shared by the tests that prefill the same shapes)."""
        if max_len not in self._prefill_j:
            cfg = self.cfg_j
            self._prefill_j[max_len] = jax.jit(
                lambda p, t: jt.prefill_forward(cfg, p, t, max_len))
        return self._prefill_j[max_len](self.params_j,
                                        jnp.asarray(tokens.numpy()))


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


def cache_pairs(cfg, cache, cache_j):
    """(name, port tensor, reference array) for every leaf of every layer's
    cache: layer ℓ's at its unit row or its tail entry
    (``transformer.layer_leaf``)."""
    out = []
    for layer, c in enumerate(cache["layers"]):
        prefix, row = tt.layer_leaf(cfg, layer)
        node = cache_j
        for part in prefix.split("."):
            node = node[part]
        for group, leaves in c.items():
            for key, got in leaves.items():
                want = np.asarray(node[group][key])
                out.append((f"{prefix}[{row}].{group}.{key}", got,
                            want if row is None else want[row]))
    return out


# ---------------------------------------------------------------------------
# The cells, module by module.
# ---------------------------------------------------------------------------

def _cell(cls, cfg, seed):
    """A port cell with standard normal weights / sqrt(fan-in) (``lam``
    positive, as its linspace init) from numpy, and the same weights as
    the reference's dict."""
    cell = cls(cfg, "cpu")
    rng = np.random.default_rng(seed)
    weights = {}
    with torch.no_grad():
        for name, p in cell.named_parameters():
            w = rng.standard_normal(p.shape) * p.shape[-2 if p.dim() > 1
                                                        else 0] ** -0.5
            if name == "lam":
                w = np.linspace(0.9, 4.0, p.shape[0]) + 0.1 * w
            p.copy_(torch.from_numpy(w.astype(np.float32)))
            weights[name] = jnp.asarray(p.numpy())
    return cell, weights


def _x(cfg, t, seed):
    x = np.random.default_rng(seed).standard_normal((B, t, cfg.d_model))
    return x.astype(np.float32)


def _state_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        assert _rel(got[k], w) <= MOD_TOL, k


def _zeros_equal(got: dict, want: dict):
    """An initial state: the reference's keys, shapes and float32, zeros."""
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == w.shape
        assert not got[k].any() and not np.asarray(w).any()


@pytest.mark.parametrize("t", [1, 2, 16, 37])
def test_associative_scan_matches_jax(t):
    """The odd/even recursion against ``jax.lax.associative_scan`` on the
    same (a, b), odd and even lengths: bit for bit against it run op by op
    (the same combines in the same order), within SCAN_TOL of it under
    ``jit`` (which may fuse a2·b1 + b2), and against a sequential loop in
    float64."""
    rng = np.random.default_rng(t)
    a = rng.uniform(0.0, 1.0, (B, t, 8)).astype(np.float32)
    b = rng.standard_normal((B, t, 8)).astype(np.float32)
    _, h = rglru.associative_scan(torch.from_numpy(a), torch.from_numpy(b))

    def scan(a, b):
        return jax.lax.associative_scan(
            lambda e1, e2: (e2[0] * e1[0], e2[0] * e1[1] + e2[1]), (a, b),
            axis=1)[1]

    assert h.shape == (B, t, 8) and h.dtype == torch.float32
    np.testing.assert_array_equal(h.numpy(), np.asarray(
        scan(jnp.asarray(a), jnp.asarray(b))))
    assert _rel(h, jax.jit(scan)(jnp.asarray(a), jnp.asarray(b))) <= \
        SCAN_TOL
    seq = np.zeros((B, 8))
    for i in range(t):
        seq = a[:, i] * seq + b[:, i].astype(np.float64)
    assert _rel(h[:, -1], seq) <= SCAN_TOL


@pytest.mark.parametrize("t", [2, 12])
def test_rglru_forward_and_decode_match_reference(t):
    """The forward, its state (t = 2 is shorter than the conv's history of
    3: zeros before the first input) and 3 decode steps from it."""
    _, cfg = _cfgs("recurrentgemma-2b")
    cell, w = _cell(rglru.RGLRU, cfg, seed=t)
    x = _x(cfg, t + 3, seed=10 + t)
    xt = torch.from_numpy(x)
    y = rglru.rglru_forward(cfg, cell, xt[:, :t])
    y_s, state = rglru.rglru_forward(cfg, cell, xt[:, :t], return_state=True)
    y_j, state_j = jax.jit(lambda w, x: jrg.rglru_forward(
        cfg, w, x, return_state=True))(w, jnp.asarray(x[:, :t]))
    assert torch.equal(y, y_s)
    assert _rel(y, y_j) <= MOD_TOL
    assert state["conv"].shape == (B, cfg.conv_width - 1, cfg.rnn_dim)
    _state_close(state, state_j)
    decode_j = jax.jit(lambda w, x, s: jrg.rglru_decode(cfg, w, x, s))
    for i in range(t, t + 3):
        y, state = rglru.rglru_decode(cfg, cell, xt[:, i:i + 1], state)
        y_j, state_j = decode_j(w, jnp.asarray(x[:, i:i + 1]), state_j)
        assert _rel(y, y_j) <= MOD_TOL
        _state_close(state, state_j)
    _zeros_equal(rglru.init_rglru_state(cfg, B, "cpu"),
                 jrg.init_rglru_state(cfg, B))


@pytest.mark.parametrize("t", [12, 16])
def test_mlstm_forward_and_decode_match_reference(t):
    """Chunk 8: t = 12 pads 4 steps (the state must be the one after step
    12), t = 16 is two whole chunks; then 3 decode steps."""
    _, cfg = _cfgs("xlstm-350m")
    assert cfg.mlstm_chunk == 8
    cell, w = _cell(ssm.MLSTM, cfg, seed=t)
    x = _x(cfg, t + 3, seed=20 + t)
    xt = torch.from_numpy(x)
    y, state = ssm.mlstm_forward(cfg, cell, xt[:, :t], return_state=True)
    y_j, state_j = jax.jit(lambda w, x: jssm.mlstm_forward(
        cfg, w, x, return_state=True))(w, jnp.asarray(x[:, :t]))
    assert y.shape == (B, t, cfg.d_model)
    assert torch.equal(y, ssm.mlstm_forward(cfg, cell, xt[:, :t]))
    assert _rel(y, y_j) <= MOD_TOL
    _state_close(state, state_j)
    decode_j = jax.jit(lambda w, x, s: jssm.mlstm_decode(cfg, w, x, s))
    for i in range(t, t + 3):
        y, state = ssm.mlstm_decode(cfg, cell, xt[:, i:i + 1], state)
        y_j, state_j = decode_j(w, jnp.asarray(x[:, i:i + 1]), state_j)
        assert _rel(y, y_j) <= MOD_TOL
        _state_close(state, state_j)
    # The chunked forward over t + 3 equals t + 3 decode steps from zero.
    state = ssm.init_mlstm_state(cfg, B, "cpu")
    steps = []
    for i in range(t + 3):
        y, state = ssm.mlstm_decode(cfg, cell, xt[:, i:i + 1], state)
        steps.append(y)
    assert _rel(torch.cat(steps, 1), ssm.mlstm_forward(cfg, cell, xt).numpy()
                ) <= MOD_TOL


def test_slstm_forward_and_decode_match_reference():
    _, cfg = _cfgs("xlstm-350m")
    cell, w = _cell(ssm.SLSTM, cfg, seed=5)
    t = 12
    x = _x(cfg, t + 3, seed=30)
    xt = torch.from_numpy(x)
    y, state = ssm.slstm_forward(cfg, cell, xt[:, :t], return_state=True)
    y_j, state_j = jax.jit(lambda w, x: jssm.slstm_forward(
        cfg, w, x, return_state=True))(w, jnp.asarray(x[:, :t]))
    assert torch.equal(y, ssm.slstm_forward(cfg, cell, xt[:, :t]))
    assert _rel(y, y_j) <= MOD_TOL
    _state_close(state, state_j)
    decode_j = jax.jit(lambda w, x, s: jssm.slstm_decode(cfg, w, x, s))
    for i in range(t, t + 3):
        y, state = ssm.slstm_decode(cfg, cell, xt[:, i:i + 1], state)
        y_j, state_j = decode_j(w, jnp.asarray(x[:, i:i + 1]), state_j)
        assert _rel(y, y_j) <= MOD_TOL
        _state_close(state, state_j)
    _zeros_equal(ssm.init_slstm_state(cfg, B, "cpu"),
                 jssm.init_slstm_state(cfg, B))
    _zeros_equal(ssm.init_mlstm_state(cfg, B, "cpu"),
                 jssm.init_mlstm_state(cfg, B))


def test_float64_cells_compute_in_float64():
    """A float64 copy of a cell keeps float64 through every cast up."""
    _, cfg = _cfgs("xlstm-350m")
    for cls, fwd in ((ssm.MLSTM, ssm.mlstm_forward),
                     (ssm.SLSTM, ssm.slstm_forward)):
        cell, _ = _cell(cls, cfg, seed=7)
        x = torch.from_numpy(_x(cfg, 9, seed=8))
        y64, state = fwd(cfg, cell.double(), x.double(), return_state=True)
        assert y64.dtype == torch.float64
        assert all(s.dtype == torch.float64 for s in state.values())
        assert _rel(fwd(cfg, cell.float(), x), y64.numpy()) <= MOD_TOL


# ---------------------------------------------------------------------------
# Configs, leaves, conversion.
# ---------------------------------------------------------------------------

def test_layer_kinds_and_leaf_names():
    cfg = get_arch("recurrentgemma-2b")
    kinds = tt.layer_kinds(cfg)
    assert len(kinds) == 26 and kinds[-3:] == ("attn_local", "rec", "rec")
    assert tt.layer_leaf(cfg, 5) == ("units.b2_attn_local", 1)
    assert tt.layer_leaf(cfg, 24) == ("tail.t0_rec", None)
    assert tt.layer_kinds(get_arch("xlstm-350m"))[:3] == (
        "mlstm", "slstm", "mlstm")
    m = model("recurrentgemma-2b")
    assert tt.stacked_name("layers.7.cell.lam", m.params) == \
        "tail.t1_rec.cell.lam"
    assert tt.stacked_row("layers.7.cell.lam", m.params) is None
    assert tt.stacked_name("layers.5.attn.wq", m.params) == \
        "units.b2_attn_local.attn.wq"
    assert tt.stacked_row("layers.5.attn.wq", m.params) == 1
    assert not tt.is_stacked("tail.t0_rec.cell.lam")


@pytest.mark.parametrize("name", ARCHS)
def test_convert_carries_every_leaf(name):
    """Every reference leaf, unit and tail, bit for bit, under the
    reference's names and in its flatten order; the float32 leaves stay
    float32 in a bf16 model."""
    m = model(name)
    leaves = tt.stacked_leaves(m.params)
    flat_j = tts.unnest(m.params_j)
    assert list(leaves) == list(flat_j)
    for leaf, ps in leaves.items():
        want = np.asarray(flat_j[leaf])
        got = (torch.stack(ps) if tt.is_stacked(leaf) else ps[0]).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), leaf
    # A bf16 model's tree: the leaves cast to the types the reference's
    # init gives them (its float32 leaves stay float32).
    _, params_j, params = m.bf16()
    for leaf, ps in tt.stacked_leaves(params).items():
        want = np.asarray(tts.unnest(params_j)[leaf])
        got = torch.stack(ps) if tt.is_stacked(leaf) else ps[0]
        assert str(got.dtype).endswith(str(want.dtype)), leaf
        bits = (got.view(torch.int16).numpy().view(np.uint16)
                if got.dtype == torch.bfloat16 else got.numpy())
        assert np.array_equal(bits, want.view(bits.dtype)), leaf


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_draws_the_cells(name):
    cfg = get_arch(name).reduced()
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cell = params.layers[0].cell
    if name == "recurrentgemma-2b":
        assert torch.equal(cell.lam, torch.linspace(0.9, 4.0, cfg.rnn_dim))
        std = [(cell.w_in, cfg.d_model ** -0.5),
               (cell.w_a, cfg.rnn_dim ** -0.5)]
        assert not hasattr(params.layers[0], "attn")
        assert hasattr(params.layers[2], "attn")
    else:
        std = [(cell.wq, cfg.d_model ** -0.5),
               (params.layers[1].cell.r_gates, cfg.hd ** -0.5)]
        assert not hasattr(params.layers[0], "mlp")
    for w, s in std:
        assert abs(float(w.std()) / s - 1.0) < 0.15


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
    logits_j, _ = jax.jit(lambda p, t: jt.forward(cfg, p, t))(
        m.params_j, jnp.asarray(m.tokens.numpy()))
    assert logits.dtype == torch.float32 and logits.shape == (B, T, 256)
    assert _rel(logits, logits_j) <= LOGIT_TOL
    assert float(aux) == 0.0


@pytest.mark.parametrize("name,t,max_len", [
    ("recurrentgemma-2b", T, T + NEW), ("recurrentgemma-2b", 2, 8),
    ("xlstm-350m", 13, 20), ("xlstm-350m", 16, 16)])
def test_prefill_matches_reference(name, t, max_len):
    """Logits and every cache leaf: recurrentgemma's attn_local ring past
    its window (T = 37 > 16) and a prompt of 2, shorter than the conv's
    history; xlstm at a prompt that is not a chunk multiple (13) and one
    that is."""
    m = model(name)
    tokens = m.tokens[:, :t].contiguous()
    logits, cache = tt.prefill_forward(m.cfg, m.params, tokens, max_len)
    logits_j, cache_j = m.prefill_j(tokens, max_len)
    assert _rel(logits, logits_j) <= LOGIT_TOL
    pairs = cache_pairs(m.cfg, cache, cache_j)
    assert len(pairs) == len(jax.tree.leaves(cache_j)) + sum(
        np.asarray(x).shape[0] - 1 for x in
        jax.tree.leaves(cache_j.get("units")))
    for leaf, got, want in pairs:
        assert tuple(got.shape) == want.shape, leaf
        if leaf.endswith(".pos"):
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL,
                                       rtol=RTOL, err_msg=leaf)


@pytest.mark.parametrize("name", ARCHS)
def test_serve_steps_match_reference(name):
    """prefill_forward, then serve_step against the reference's
    decode_step: tokens equal at each step, every cache leaf at the end."""
    m = model(name)
    max_len = T + NEW
    logits, cache = tt.prefill_forward(m.cfg, m.params, m.tokens, max_len)
    logits_j, cache_j = m.prefill_j(m.tokens, max_len)
    first = torch.argmax(logits[:, 0], -1).to(torch.int32)[:, None]
    state = tss.ServeState(cache, torch.tensor(T, dtype=torch.int32), first)
    tok_j = jnp.argmax(logits_j[:, 0], -1).astype(jnp.int32)[:, None]
    np.testing.assert_array_equal(first.numpy(), np.asarray(tok_j))
    pos_j, c_j = jnp.asarray(T, jnp.int32), cache_j
    for _ in range(NEW):
        lj, c_j = m.step_j(m.params_j, tok_j, c_j, pos_j)
        top2 = np.sort(np.asarray(lj[:, 0]), axis=-1)[:, -2:]
        assert float((top2[:, 1] - top2[:, 0]).min()) > 1e-3
        tok_j = jnp.argmax(lj[:, 0], -1).astype(jnp.int32)[:, None]
        pos_j = pos_j + 1
        tok, state = tss.serve_step(m.cfg, m.params, state)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))
    for leaf, got, want in cache_pairs(m.cfg, state.cache, c_j):
        if leaf.endswith(".pos"):
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL,
                                       rtol=RTOL, err_msg=leaf)


@pytest.mark.parametrize("name", ARCHS)
def test_generate_matches_reference(name):
    """A prompt of 12 and 6 new tokens through the teacher-forced prefill
    (``serve_step.prefill``: decode steps from an empty cache)."""
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
    """Decode over the 6 teacher-forced tokens after a prefill equals the
    full forward over the extended sequence (recurrentgemma: a wrapped
    ring against the window's mask; xlstm: the chunked mLSTM against its
    recurrence)."""
    m = model(name)
    full, _ = tt.forward(m.cfg, m.params, m.tokens_all)
    _, cache = tt.prefill_forward(m.cfg, m.params, m.tokens, T + NEW)
    for i in range(NEW):
        logits, cache = tt.decode_step(m.cfg, m.params,
                                       m.tokens_all[:, T + i:T + i + 1],
                                       cache, torch.tensor(T + i))
        assert _rel(logits[:, 0], full[:, T + i].numpy()) <= LOGIT_TOL


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_forward_prefill_and_decode_within_the_references_rounding(
        name):
    """bf16, the same weights: the forward over T + NEW tokens, the
    prefill of T and NEW teacher-forced decode steps, each against the
    reference's, within BF16_FACTOR times the reference's own distance from
    the float32 evaluation of those weights; and decode no farther from
    that evaluation than DECODE_FACTOR times the port's bf16 forward (the
    card's check, ``chip_smoke.RECURRENT_DECODE_FACTOR``)."""
    m = model(name)
    (cfg_j, cfg), params_j, params = m.bf16()
    toks_j = jnp.asarray(m.tokens_all.numpy())
    fwd_j = jax.jit(lambda p, t: jt.forward(cfg_j, p, t)[0])(params_j,
                                                             toks_j)
    pre_j, cache_j = jax.jit(lambda p, t: jt.prefill_forward(
        cfg_j, p, t, T + NEW))(params_j, toks_j[:, :T])
    step_j = jax.jit(lambda p, tok, c, pos: jt.decode_step(cfg_j, p, tok, c,
                                                           pos))
    dec_j = []
    for i in range(NEW):
        lj, cache_j = step_j(params_j, toks_j[:, T + i:T + i + 1], cache_j,
                             jnp.asarray(T + i, jnp.int32))
        dec_j.append(np.asarray(lj))
    dec_j = np.concatenate(dec_j, 1)

    fwd, _ = tt.forward(cfg, params, m.tokens_all)
    pre, cache = tt.prefill_forward(cfg, params, m.tokens, T + NEW)
    dec = []
    for i in range(NEW):
        logits, cache = tt.decode_step(cfg, params,
                                       m.tokens_all[:, T + i:T + i + 1],
                                       cache, torch.tensor(T + i))
        dec.append(logits)
    dec = torch.cat(dec, 1)
    assert fwd.dtype == pre.dtype == dec.dtype == torch.float32
    # The float32 evaluation (the port's float32 forward equals the
    # reference's within LOGIT_TOL: test_forward_matches_reference).
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    f32, _ = tt.forward(cfg32, copy.deepcopy(params).float(), m.tokens_all)
    f32 = f32.numpy()
    for what, got, want, ref in (("forward", fwd, fwd_j, f32),
                                 ("prefill", pre, pre_j, f32[:, T - 1:T]),
                                 ("decode", dec, dec_j, f32[:, T:])):
        assert _rel(got, want) <= BF16_FACTOR * _rel(want, ref), what
    assert _rel(dec, f32[:, T:]) <= DECODE_FACTOR * _rel(fwd[:, T:],
                                                         f32[:, T:])
    # The port against itself: prefill and decode round where its forward
    # does, on float32 values that differ only in the order of their sums.
    assert _rel(pre, fwd[:, T - 1:T].numpy()) <= BF16_SELF_TOL
    assert _rel(dec, fwd[:, T:].numpy()) <= BF16_SELF_TOL


@pytest.mark.parametrize("name", ARCHS)
def test_launch_serve_runs_reduced_on_the_cpu(name, capsys):
    tserve.main(["--arch", name, "--reduced", "--device", "cpu",
                 "--prompt-len", "20", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill [4x20]" in out and "decoded 3 steps" in out


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------

def test_weight_decay_skips_the_tails_vectors():
    """With zero gradients only the decay moves a parameter: every leaf of
    two or more reference dimensions decays (the stacked ``lam`` [U, R]
    and norm scales [U, D] too), the tail's ``lam`` and norm scales, one
    layer's, do not; in both packages."""
    m = model("recurrentgemma-2b")
    acfg = jo.AdamWConfig(lr=0.5, warmup_steps=1)
    params = convert.lm_params_from_jax(m.cfg, m.params_j, "cpu")
    zeros_j = jax.tree.map(jnp.zeros_like, m.params_j)
    new_j, _, _ = jax.jit(lambda p, z: jo.adamw_update(
        acfg, jo.adamw_init(p), p, z))(m.params_j, zeros_j)
    zeros = {name: torch.zeros(to.leaf_shape(name, ps))
             for name, ps in tt.stacked_leaves(params).items()}
    params, _, _ = to.adamw_update(
        to.AdamWConfig(**dataclasses.asdict(acfg)), to.adamw_init(params),
        params, zeros)
    before = tts.unnest(m.params_j)
    moved_j = {name for name, x in tts.unnest(new_j).items()
               if not np.array_equal(np.asarray(x), np.asarray(before[name]))}
    got = tts.stacked_params(params)
    moved = {name for name, x in got.items()
             if not np.array_equal(x.numpy(), np.asarray(before[name]))}
    assert "units.b0_rec.cell.lam" in moved
    assert "tail.t0_rec.cell.lam" not in moved
    assert "tail.t1_rec.ln1.scale" not in moved
    assert moved == moved_j == {name for name, x in before.items()
                                if np.ndim(x) >= 2}


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches(name):
    """One AdamW step (no compression, one microbatch: the split into
    microbatches knows no block kind and tests/test_torch_train.py holds it
    at 2): loss, grad_norm and lr, then every parameter leaf, unit and
    tail.  The state is the reference's ``init_train_state`` at key 0 (the
    module's weights)."""
    m = model(name)
    cfg_j, cfg = m.cfg_j, m.cfg
    acfg = jo.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=3)
    tcfg_j = jts.TrainConfig(adamw=acfg, microbatches=1)
    tcfg = tts.TrainConfig(adamw=to.AdamWConfig(**dataclasses.asdict(acfg)),
                           microbatches=1)
    state_j = jts.TrainState(params=m.params_j, opt=jo.adamw_init(m.params_j),
                             residuals=None)
    state = convert.train_state_from_jax(cfg, state_j, "cpu")
    batch_j = JTokenPipeline(cfg.vocab, 24, 4).batch_at(0)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in batch_j.items()}
    state_j, met_j = jax.jit(jts.make_train_step(cfg_j, tcfg_j))(state_j,
                                                                 batch_j)
    state, met = tts.make_train_step(cfg, tcfg)(state, batch)
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(met[key]) - float(met_j[key])) <= \
            STEP_RTOL * abs(float(met_j[key])), key
    got = convert.train_state_to_jax(state)
    for leaf, want in tts.unnest(state_j.params).items():
        want = np.asarray(want)
        diff = np.abs(tts.unnest(got.params)[leaf] - want).max()
        assert diff <= PARAM_TOL * np.abs(want).max(), leaf
