"""The port's dense-LM serving path against the reference's.

At ``reduced()`` size (2 layers, d 64, 4 heads of 16, vocab 256, float32)
for olmo-1b (non-parametric LayerNorm, tied embeddings, MHA), llama3-8b
with ``n_kv_heads=2`` (RMSNorm, GQA group 2; its own reduced config keeps
4 KV heads) and starcoder2-3b (LayerNorm, GQA group 2).  The reference's
weights (``jax.random``) are carried into the port with
``convert.lm_params_from_jax``; tokens come from both packages'
``TokenPipeline`` and are checked equal.

Tolerances, float32: logits and cache tensors within 2e-5 abs + 2e-5 rel.
The reference's own two attention paths (Pallas flash in interpret mode,
which engages at T % 128 == 0, and its plain oracle) differ by up to
2.9e-6 on these logits (|logit| <= 4.6), the port from either by up to
6.0e-6: torch and XLA agree on matmuls and transcendentals only to a few
ulp.  Positions and greedy tokens are exact: the test checks that the
reference's best two logits at every decode step are at least 1e-3 apart,
so a token cannot flip on rounding.  bfloat16: logits within 0.08 abs
(2.5 bf16 ulps at the largest logit, |logit| <= 4.3; the reading is
0.051): the two frameworks round the bf16 residual stream and matmul
outputs at different places.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import all_archs as j_all_archs
from repro.configs import get_arch as j_get_arch
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.train.serve_step import ServeState as JServeState
from repro.train.serve_step import generate as j_generate
from repro.train.serve_step import serve_step as j_serve_step

from repro_torch import convert
from repro_torch.configs import all_archs, get_arch
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as attn
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.serve import serve_step as tss
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["olmo-1b", "llama3-8b", "starcoder2-3b"]
MOE_ARCHS = ["arctic-480b", "mixtral-8x22b"]    # tests/test_torch_moe.py
# tests/test_torch_mla.py, tests/test_torch_vlm.py and
# tests/test_torch_whisper.py
MLA_VLM_ARCHS = ["minicpm3-4b", "qwen2-vl-2b", "whisper-large-v3"]
RECURRENT_ARCHS = ["recurrentgemma-2b", "xlstm-350m"]  # test_torch_recurrent
ATOL = RTOL = 2e-5
BF16_ATOL = 8e-2
B, T, NEW = 2, 256, 8


def _cfgs(name, **kw):
    """(reference config, port config), reduced, with ``kw`` replaced."""
    kw = dict(kw)
    if name == "llama3-8b":
        kw.setdefault("n_kv_heads", 2)
    return (dataclasses.replace(j_get_arch(name).reduced(), **kw),
            dataclasses.replace(get_arch(name).reduced(), **kw))


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.float().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


class Model:
    """One architecture's reference params, port params and tokens."""

    def __init__(self, name, **kw):
        self.cfg_j, self.cfg = _cfgs(name, **kw)
        self.params_j = jt.init_params(self.cfg_j, jax.random.PRNGKey(0))
        self.params = convert.lm_params_from_jax(self.cfg, self.params_j,
                                                 "cpu")
        batch = TokenPipeline(self.cfg.vocab, T + NEW, B, seed=3,
                              device="cpu").batch_at(0)
        self.tokens_all = batch["tokens"]
        self.tokens = self.tokens_all[:, :T]

    def forward_j(self, tokens, use_kernel):
        cfg = self.cfg_j
        fn = jax.jit(lambda p, t: jt.forward(cfg, p, t,
                                             use_kernel=use_kernel)[0])
        return np.asarray(fn(self.params_j, jnp.asarray(tokens.numpy())))


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
# Configs, data, conversion.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS + MOE_ARCHS + MLA_VLM_ARCHS
                         + RECURRENT_ARCHS)
def test_configs_equal_the_reference(name):
    j, t = j_get_arch(name), get_arch(name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert t.hd == j.hd and t.n_units == j.n_units and t.tail == j.tail


def test_only_dense_configs_registered_others_name_their_slice():
    """Every config of the reference is registered in the port (all ten:
    dense, MoE, MLA, VLM, Whisper and the recurrent two), and every block
    kind its configs use (the units, and the encoder's ``"enc"``) builds a
    port block."""
    everything = ARCHS + MOE_ARCHS + MLA_VLM_ARCHS + RECURRENT_ARCHS
    assert list(all_archs()) == sorted(everything) == sorted(j_all_archs())
    assert len(all_archs()) == 10
    kinds = set()
    for name in everything:
        j = j_get_arch(name)
        assert get_arch(name).name == j.name
        kinds |= set(j.unit) | ({"enc"} if j.encoder_layers else set())
    assert kinds == set(tt.KINDS)
    for kind in sorted(kinds):
        cfg = get_arch(next(n for n in everything if kind in
                            get_arch(n).unit + (("enc",) if get_arch(
                                n).encoder_layers else ()))).reduced()
        assert isinstance(tt.Block(kind, cfg, "meta"), torch.nn.Module)


def test_token_pipeline_equals_the_reference():
    kw = dict(vocab=50_304, seq_len=64, global_batch=8, host_id=1,
              num_hosts=2, seed=5)
    for step in (0, 3):
        got = TokenPipeline(**kw, device="cpu").batch_at(step)
        want = JTokenPipeline(**kw).batch_at(step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


def test_convert_carries_bf16_bits_and_every_leaf():
    cfg_j, cfg = _cfgs("llama3-8b", dtype="bfloat16")
    params_j = jt.init_params(cfg_j, jax.random.PRNGKey(1))
    params = convert.lm_params_from_jax(cfg, params_j, "cpu")
    assert params.embed.dtype == torch.bfloat16
    assert params.layers[0].ln1.scale.dtype == torch.float32
    want = np.asarray(params_j["units"]["b0_dense"]["attn"]["wk"][1])
    np.testing.assert_array_equal(
        params.layers[1].attn.wk.view(torch.uint16).numpy(),
        want.view(np.uint16))
    assert tt.param_count(params) == sum(
        int(np.size(x)) for x in jax.tree.leaves(params_j))
    with pytest.raises(ValueError):
        convert.lm_params_from_jax(dataclasses.replace(cfg, d_ff=64),
                                   params_j, "cpu")


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_layers_match_reference(kind):
    """Norms (eps 1e-6, population variance), interleaved RoPE (θ = 1e4),
    SwiGLU and linear layers on identical inputs and weights."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 3, 16, 32)).astype(np.float32) * 3 + 1
    pos = rng.integers(0, 5000, size=(2, 16)).astype(np.int32)
    norm = tl.Norm(kind, 32, "cpu")
    norm_j = {}
    with torch.no_grad():
        for name, p in norm.named_parameters():
            norm_j[name] = rng.normal(size=32).astype(np.float32)
            p.copy_(torch.from_numpy(norm_j[name]))
    _close(tl.apply_norm(kind, norm, torch.from_numpy(x)),
           jl.apply_norm(kind, norm_j, jnp.asarray(x)), atol=1e-5, rtol=1e-5)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    mlp = tl.MLP(32, 48, torch.float32, "cpu")
    lin = tl.Linear(32, 24, torch.float32, "cpu", bias=True)
    tl.init_mlp(mlp, torch.Generator().manual_seed(0))
    tl.init_linear(lin, torch.Generator().manual_seed(1))
    assert float(lin.b.abs().max()) == 0.0
    with torch.no_grad():
        lin.b.copy_(torch.from_numpy(rng.normal(size=24).astype(np.float32)))
    mlp_j = {n: jnp.asarray(p.numpy()) for n, p in mlp.named_parameters()}
    lin_j = {n: jnp.asarray(p.numpy()) for n, p in lin.named_parameters()}
    _close(tl.apply_mlp(mlp, torch.from_numpy(x)),
           jl.apply_mlp(mlp_j, jnp.asarray(x)))
    _close(tl.apply_linear(lin, torch.from_numpy(x)),
           jl.apply_linear(lin_j, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# Forward, prefill, decode.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(name):
    m = model(name)
    before = fa_ops.launches
    kernel_path, aux = tt.forward(m.cfg, m.params, m.tokens, use_kernel=True)
    plain_path, _ = tt.forward(m.cfg, m.params, m.tokens, use_kernel=False)
    assert fa_ops.launches == before       # CPU: the op's plain version
    assert kernel_path.dtype == torch.float32
    assert kernel_path.shape == (B, T, m.cfg.vocab)
    assert float(aux) == 0.0
    # On the CPU the op runs its plain version: the two paths are one.
    assert torch.equal(kernel_path, plain_path)
    _close(kernel_path, m.forward_j(m.tokens, use_kernel=True))
    _close(plain_path, m.forward_j(m.tokens, use_kernel=False))


@pytest.mark.parametrize("name,max_len", [("olmo-1b", T + NEW),
                                          ("llama3-8b", T + NEW),
                                          ("starcoder2-3b", T + NEW),
                                          ("llama3-8b", T - 56)])
def test_prefill_matches_reference(name, max_len):
    m = model(name)
    logits, cache = tt.prefill_forward(m.cfg, m.params, m.tokens, max_len)
    cfg = m.cfg_j
    logits_j, cache_j = jax.jit(
        lambda p, t: jt.prefill_forward(cfg, p, t, max_len))(
        m.params_j, jnp.asarray(m.tokens.numpy()))
    _close(logits, logits_j)
    layers = cache["layers"]
    assert len(layers) == m.cfg.n_layers
    for u, layer in enumerate(layers):
        want = jax.tree.map(lambda a: np.asarray(a)[u],
                            cache_j["units"]["b0_dense"]["attn"])
        got = layer["attn"]
        assert got["pos"].dtype == torch.int32
        np.testing.assert_array_equal(got["pos"].numpy(), want["pos"])
        for key in ("k", "v"):
            assert got[key].shape == want[key].shape
            _close(got[key], want[key])


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_plain_path_matches_reference(name):
    """``use_kernel=False`` (attention_ref) against the reference's prefill,
    and on the CPU equal to the op's path, logits and caches."""
    m = model(name)
    max_len = T + NEW
    before = fa_ops.launches
    logits, cache = tt.prefill_forward(m.cfg, m.params, m.tokens, max_len,
                                       use_kernel=True)
    plain, plain_cache = tt.prefill_forward(m.cfg, m.params, m.tokens,
                                            max_len, use_kernel=False)
    assert fa_ops.launches == before
    assert torch.equal(logits, plain)
    for got, want in zip(cache["layers"], plain_cache["layers"]):
        for key in ("k", "v", "pos"):
            assert torch.equal(got["attn"][key], want["attn"][key])
    cfg = m.cfg_j
    logits_j, _ = jax.jit(
        lambda p, t: jt.prefill_forward(cfg, p, t, max_len))(
        m.params_j, jnp.asarray(m.tokens.numpy()))
    _close(plain, logits_j)


@pytest.mark.parametrize("name", ARCHS)
def test_serve_steps_match_reference(name):
    m = model(name)
    cfg = m.cfg_j
    max_len = T + NEW
    logits, cache = tt.prefill_forward(m.cfg, m.params, m.tokens, max_len)
    logits_j, cache_j = jax.jit(
        lambda p, t: jt.prefill_forward(cfg, p, t, max_len))(
        m.params_j, jnp.asarray(m.tokens.numpy()))
    first = torch.argmax(logits[:, 0], -1).to(torch.int32)[:, None]
    first_j = jnp.argmax(logits_j[:, 0], -1).astype(jnp.int32)[:, None]
    state = tss.ServeState(cache, torch.tensor(T, dtype=torch.int32), first)
    state_j = JServeState(cache_j, jnp.asarray(T, jnp.int32), first_j)
    step_j = jax.jit(lambda p, s: jt.decode_step(cfg, p, s.last_token,
                                                 s.cache, s.pos))
    for _ in range(NEW):
        # The reference's logits for this step: its best two are apart.
        lj, _ = step_j(m.params_j, state_j)
        top2 = np.sort(np.asarray(lj[:, 0]), axis=-1)[:, -2:]
        assert float((top2[:, 1] - top2[:, 0]).min()) > 1e-3
        tok, state = tss.serve_step(m.cfg, m.params, state)
        tok_j, state_j = j_serve_step(cfg, m.params_j, state_j)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))
    assert int(state.pos) == T + NEW
    for u, layer in enumerate(state.cache["layers"]):
        np.testing.assert_array_equal(
            layer["attn"]["pos"].numpy(),
            np.asarray(state_j.cache["units"]["b0_dense"]["attn"]["pos"][u]))


@pytest.mark.parametrize("name", ARCHS)
def test_generate_matches_reference(name):
    m = model(name)
    prompt = m.tokens[:, :12]
    got = tss.generate(m.cfg, m.params, prompt, NEW, 12 + NEW)
    cfg = m.cfg_j
    want = jax.jit(lambda p, t: j_generate(cfg, p, t, NEW, 12 + NEW))(
        m.params_j, jnp.asarray(prompt.numpy()))
    assert got.dtype == torch.int32 and got.shape == (B, 12 + NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ARCHS)
def test_teacher_forced_decode_equals_forward(name):
    """Decode logits over 8 teacher-forced steps after a prefill equal the
    full forward over the extended sequence: the cache, its ring slots and
    the positions are right."""
    m = model(name)
    full, _ = tt.forward(m.cfg, m.params, m.tokens_all)
    _, cache = tt.prefill_forward(m.cfg, m.params, m.tokens, T + NEW)
    for i in range(NEW):
        logits, cache = tt.decode_step(m.cfg, m.params,
                                       m.tokens_all[:, T + i:T + i + 1],
                                       cache, torch.tensor(T + i))
        _close(logits[:, 0], full[:, T + i].numpy())


def test_bf16_forward_within_bf16_rounding():
    cfg_j, cfg = _cfgs("llama3-8b", dtype="bfloat16")
    params_j = jt.init_params(cfg_j, jax.random.PRNGKey(2))
    params = convert.lm_params_from_jax(cfg, params_j, "cpu")
    tokens = model("llama3-8b").tokens
    got, _ = tt.forward(cfg, params, tokens)
    want = jax.jit(lambda p, t: jt.forward(cfg_j, p, t, use_kernel=True)[0])(
        params_j, jnp.asarray(tokens.numpy()))
    _close(got, want, atol=BF16_ATOL, rtol=0.0)


def test_bf16_head_dim_128_takes_the_bf16_op(monkeypatch):
    """bf16 at head dim 128 (the dense configs' own) hands the op bf16
    operands, which on the CPU is the float32 plain version rounded to
    bf16: the kernel path equals the plain path bit for bit, and the
    forward stays within bf16 rounding of the reference's, whose Pallas
    kernel (interpret mode, T % 128 == 0) rounds P to bf16."""
    cfg_j, cfg = _cfgs("llama3-8b", dtype="bfloat16", d_model=256,
                       head_dim=128)
    seen = []

    def op(q, k, v, causal):
        seen.append((q.dtype, k.dtype, v.dtype, q.shape[-1]))
        return fa_ops.attention(q, k, v, causal=causal)

    monkeypatch.setattr(attn, "flash_attn_op", op)
    params_j = jt.init_params(cfg_j, jax.random.PRNGKey(4))
    params = convert.lm_params_from_jax(cfg, params_j, "cpu")
    tokens = model("llama3-8b").tokens
    got, _ = tt.forward(cfg, params, tokens)
    assert seen == [(torch.bfloat16,) * 3 + (128,)] * cfg.n_layers
    plain, _ = tt.forward(cfg, params, tokens, use_kernel=False)
    assert torch.equal(got, plain)
    want = jax.jit(lambda p, t: jt.forward(cfg_j, p, t, use_kernel=True)[0])(
        params_j, jnp.asarray(tokens.numpy()))
    _close(got, want, atol=BF16_ATOL, rtol=0.0)


# ---------------------------------------------------------------------------
# Flash decoding and the a2a dispatch without a mesh.
# ---------------------------------------------------------------------------

def test_unported_paths_name_their_slice():
    """Without an ambient mesh, flash decoding is the full decode bit for
    bit (dense, and recurrentgemma's local attention), as the reference's
    falls back; MoE's a2a dispatch raises ``ValueError``, as the
    reference's does (``tests/test_torch_sharded_lm.py`` runs both on
    meshes)."""
    moe_cfg = get_arch("mixtral-8x22b").reduced()
    moe_params = tt.init_params(moe_cfg, torch.Generator().manual_seed(0),
                                "cpu")
    with pytest.raises(ValueError, match="ambient mesh"):
        tt.forward(moe_cfg, moe_params, torch.zeros((1, 4), dtype=torch.int32),
                   moe_strategy="a2a")
    m = model("llama3-8b")
    rg_cfg = get_arch("recurrentgemma-2b").reduced()
    rg_params = tt.init_params(rg_cfg, torch.Generator().manual_seed(0),
                               "cpu")
    for cfg, params in ((m.cfg, m.params), (rg_cfg, rg_params)):
        tokens = m.tokens[:, :24]
        outs = []
        for flash in (False, True):
            _, cache = tt.prefill_forward(cfg, params, tokens[:, :20], 24)
            steps = [tt.decode_step(cfg, params, tokens[:, i:i + 1], cache,
                                    torch.tensor(i), flash_decode=flash)[0]
                     for i in range(20, 24)]
            outs.append(torch.cat(steps, 1))
        assert torch.equal(outs[0], outs[1]), cfg.name
