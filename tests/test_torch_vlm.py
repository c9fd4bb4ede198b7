"""The port's M-RoPE and vision-stub inputs (qwen2-vl-2b) against the
reference's ``models/layers.py``, ``models/attention.py``,
``models/transformer.py`` and ``train/train_step.py``.

At ``reduced()`` size, float32: 2 layers, d 64, 4 heads over 2 KV heads
of 16 (M-RoPE sections of 2, 3 and 3 pairs), d_ff 128, vocab 256, tied
embeddings.  A multimodal input is 10 text tokens, a 4 x 6 patch grid and
14 more text tokens, given as ``embeds`` (text rows from the embedding,
patch rows drawn from numpy) with Qwen2-VL's [3, B, T] positions: text
rows equal, the grid at one temporal index with its height and width
rows, the text after it resuming past the grid's largest position.  The
reference's weights are carried into the port with
``convert.lm_params_from_jax``.

Tolerances, float32 (the port's LM tests' bound): rotations, attention
outputs, logits and cache tensors within 2e-5 abs + 2e-5 rel (readings:
at most 4e-6 on logits of |logit| <= 4.8); M-RoPE with three equal rows
equals RoPE bit for bit; cache positions and greedy tokens exact (the
reference's best two logits at every compared step at least 1e-3 apart);
one train step's loss, grad_norm and lr within 1e-5 relative and each
parameter leaf within 1e-4 of its largest |value|
(``tests/test_torch_train.py``'s bounds).
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
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.train import optimizer as jo
from repro.train import train_step as jts
from repro.train.serve_step import generate as j_generate

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as attn
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.serve import serve_step as tss
from repro_torch.train import optimizer as to
from repro_torch.train import train_step as tts
from torch_threads import one_torch_thread  # noqa: F401

NAME = "qwen2-vl-2b"
ATOL = RTOL = 2e-5
STEP_RTOL = 1e-5
PARAM_TOL = 1e-4      # of each leaf's max |value|
B, NEW = 2, 8
TEXT0, GRID, TEXT1 = 10, (4, 6), 14
T = TEXT0 + GRID[0] * GRID[1] + TEXT1          # 48


def _cfgs(**kw):
    return (dataclasses.replace(j_get_arch(NAME).reduced(), **kw),
            dataclasses.replace(get_arch(NAME).reduced(), **kw))


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def vision_positions(b, text0, grid, text1) -> np.ndarray:
    """Qwen2-VL's int32[3, B, T]: text 0..text0-1 on all three rows; the
    grid's patches at temporal text0, height text0 + row, width text0 +
    col; then text from text0 + max(grid) on, all rows equal."""
    gh, gw = grid
    rows = [np.repeat(np.arange(text0)[None], 3, 0)]
    hh, ww = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    rows.append(text0 + np.stack([np.zeros(gh * gw, int), hh.ravel(),
                                  ww.ravel()]))
    start = text0 + max(gh, gw)
    rows.append(np.repeat(np.arange(start, start + text1)[None], 3, 0))
    pos = np.concatenate(rows, axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, b, pos.shape[1])))


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
        # The vision stub: text rows from the embedding, patch rows drawn.
        emb = np.asarray(self.params_j["embed"])[self.tokens.numpy()]
        n = GRID[0] * GRID[1]
        emb[:, TEXT0:TEXT0 + n] = (rng.standard_normal(
            (B, n, self.cfg.d_model)) * self.cfg.d_model ** -0.5)
        self.embeds = emb.astype(np.float32)
        self.pos3 = vision_positions(B, TEXT0, GRID, TEXT1)


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
# M-RoPE.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [16, 128])
def test_apply_mrope_matches_reference(d):
    """x [B, H, T, D] against positions [3, B, 1, T] (a head axis given)
    and [3, B, T] (inserted); sections of D/2 = 8 pairs 2/3/3, of 64
    pairs 16/24/24."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((B, 3, T, d)).astype(np.float32)
    pos = rng.integers(0, 500, (3, B, T)).astype(np.int32)
    want = jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos))
    for p in (pos, pos[:, :, None]):
        got = tl.apply_mrope(torch.from_numpy(x), torch.from_numpy(p))
        assert got.dtype == torch.float32 and got.shape == x.shape
        _close(got, want)
    # Each section turns by its own row: a row changed moves its pairs
    # only.
    moved = pos.copy()
    moved[1] += 7
    got = tl.apply_mrope(torch.from_numpy(x), torch.from_numpy(moved))
    base = tl.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos))
    half = d // 2
    lo, hi = int(half * 0.25), int(half * 0.25) + int(half * 0.375)
    differs = (got != base).reshape(B, 3, T, half, 2).any(-1).any((0, 1, 2))
    assert differs.tolist() == [lo <= i < hi for i in range(half)]


def test_apply_mrope_with_equal_rows_is_rope_bit_for_bit():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((B, 4, T, 16)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 4096, (B, T)).astype(np.int32))
    got = tl.apply_mrope(x, pos[None].expand(3, B, T))
    assert torch.equal(got, tl.apply_rope(x, pos))
    bf = x.bfloat16()
    assert torch.equal(tl.apply_mrope(bf, pos[None].expand(3, B, T)),
                       tl.apply_rope(bf, pos))


def test_gqa_train_and_prefill_with_vision_positions_match_reference():
    m = model()
    cfg_j, cfg = m.cfg_j, m.cfg
    layer, layer_j = m.params.layers[0].attn, jax.tree.map(
        lambda a: a[0], m.params_j["units"]["b0_dense"]["attn"])
    x = m.embeds
    got = attn.gqa_train(cfg, layer, torch.from_numpy(x),
                         torch.from_numpy(m.pos3))
    want = jax.jit(lambda p, v, q: jattn.gqa_train(cfg_j, p, v, q))(
        layer_j, jnp.asarray(x), jnp.asarray(m.pos3))
    _close(got, want)
    y, cache = attn.gqa_prefill(cfg, layer, torch.from_numpy(x),
                                torch.from_numpy(m.pos3), T + NEW)
    y_j, cache_j = jax.jit(lambda p, v, q: jattn.gqa_prefill(
        cfg_j, p, v, q, T + NEW))(layer_j, jnp.asarray(x),
                                  jnp.asarray(m.pos3))
    _close(y, y_j)
    # The cache's slots follow the temporal row, as the reference's do:
    # the grid's patches share one temporal position, so one slot, which
    # each package's scatter fills from one of them (unspecified which);
    # the other slots are compared.
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(cache_j["pos"]))
    once = np.arange(T + NEW) != TEXT0
    for key in ("k", "v"):
        _close(cache[key][:, :, once], np.asarray(cache_j[key])[:, :, once])


# ---------------------------------------------------------------------------
# The model: forward, prefill, decode, serving.
# ---------------------------------------------------------------------------

def test_forward_from_embeds_with_vision_positions_matches_reference():
    m = model()
    cfg = m.cfg_j
    got, aux = tt.forward(m.cfg, m.params, m.tokens,
                          positions=torch.from_numpy(m.pos3),
                          embeds=torch.from_numpy(m.embeds))
    want, _ = jax.jit(lambda p, t, q, e: jt.forward(
        cfg, p, t, positions=q, embeds=e))(
        m.params_j, jnp.asarray(m.tokens.numpy()), jnp.asarray(m.pos3),
        jnp.asarray(m.embeds))
    assert got.dtype == torch.float32 and got.shape == (B, T, 256)
    assert float(aux) == 0.0
    _close(got, want)
    plain, _ = tt.forward(m.cfg, m.params, None,
                          positions=torch.from_numpy(m.pos3),
                          embeds=torch.from_numpy(m.embeds), use_kernel=False)
    _close(plain, want)


def test_text_positions_are_three_equal_rows():
    """Text-only: default positions, [B, T] and three equal [3, B, T] rows
    give the same logits bit for bit, and the reference's."""
    m = model()
    pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    a, _ = tt.forward(m.cfg, m.params, m.tokens)
    b, _ = tt.forward(m.cfg, m.params, m.tokens, positions=pos)
    c, _ = tt.forward(m.cfg, m.params, m.tokens,
                      positions=pos[None].expand(3, B, T).contiguous())
    assert torch.equal(a, b) and torch.equal(a, c)
    cfg = m.cfg_j
    want, _ = jax.jit(lambda p, t: jt.forward(cfg, p, t))(
        m.params_j, jnp.asarray(m.tokens.numpy()))
    _close(a, want)


def test_prefill_from_embeds_matches_reference():
    """The prefill keeps positions 0..T-1, as the reference's does."""
    m = model()
    cfg = m.cfg_j
    logits, cache = tt.prefill_forward(m.cfg, m.params, m.tokens, T + NEW,
                                       embeds=torch.from_numpy(m.embeds))
    logits_j, cache_j = jax.jit(
        lambda p, t, e: jt.prefill_forward(cfg, p, t, T + NEW, embeds=e))(
        m.params_j, jnp.asarray(m.tokens.numpy()), jnp.asarray(m.embeds))
    _close(logits, logits_j)
    full, _ = tt.forward(m.cfg, m.params, None,
                         embeds=torch.from_numpy(m.embeds))
    _close(logits[:, 0], full[:, -1].numpy())
    for u, layer in enumerate(cache["layers"]):
        want = jax.tree.map(lambda a: np.asarray(a)[u],
                            cache_j["units"]["b0_dense"]["attn"])
        np.testing.assert_array_equal(layer["attn"]["pos"].numpy(),
                                      want["pos"])
        for key in ("k", "v"):
            _close(layer["attn"][key], want[key])


def test_serve_steps_match_reference():
    """Text-only serving (three equal rows): prefill_forward, then
    serve_step against the reference's decode_step, tokens equal."""
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
        np.testing.assert_array_equal(
            layer["attn"]["pos"].numpy(),
            np.asarray(c_j["units"]["b0_dense"]["attn"]["pos"][u]))


def test_generate_matches_reference():
    m = model()
    prompt = m.tokens[:, :12].contiguous()
    got = tss.generate(m.cfg, m.params, prompt, NEW, 12 + NEW)
    cfg = m.cfg_j
    want = jax.jit(lambda p, t: j_generate(cfg, p, t, NEW, 12 + NEW))(
        m.params_j, jnp.asarray(prompt.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_teacher_forced_decode_equals_forward():
    m = model()
    full, _ = tt.forward(m.cfg, m.params, m.tokens_all)
    _, cache = tt.prefill_forward(m.cfg, m.params, m.tokens, T + NEW)
    for i in range(NEW):
        logits, cache = tt.decode_step(m.cfg, m.params,
                                       m.tokens_all[:, T + i:T + i + 1],
                                       cache, torch.tensor(T + i))
        _close(logits[:, 0], full[:, T + i].numpy())


def test_bf16_head_dim_128_hands_the_op_bf16_operands(monkeypatch):
    """qwen2-vl's own head dim and dtype at reduced width: the flash op
    gets bf16 q, k, v at D = 128 (on the CPU its plain version), from
    embeds at vision positions."""
    cfg_j, cfg = _cfgs(dtype="bfloat16", head_dim=128)
    seen = []
    real = attn.flash_attn_op

    def op(q, k, v, causal=True):
        seen.append((q.dtype, k.dtype, v.dtype, q.shape[-1], k.shape[1]))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(attn, "flash_attn_op", op)
    params_j = jt.init_params(cfg_j, jax.random.PRNGKey(4))
    params = convert.lm_params_from_jax(cfg, params_j, "cpu")
    m = model()
    got, _ = tt.forward(cfg, params, m.tokens,
                        positions=torch.from_numpy(m.pos3),
                        embeds=torch.from_numpy(m.embeds))
    assert seen == [(torch.bfloat16,) * 3 + (128, cfg.n_kv_heads)] * \
        cfg.n_layers
    plain, _ = tt.forward(cfg, params, m.tokens,
                          positions=torch.from_numpy(m.pos3),
                          embeds=torch.from_numpy(m.embeds),
                          use_kernel=False)
    assert torch.equal(got, plain)


def test_launch_serve_runs_qwen2_vl_reduced_on_the_cpu(capsys):
    tserve.main(["--arch", NAME, "--reduced", "--device", "cpu",
                 "--prompt-len", "20", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill [4x20]" in out and "decoded 3 steps" in out


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------

def _vision_batch(cfg, params_j, b=4):
    """A TokenPipeline batch with ``embeds`` (the tokens' rows, the grid's
    drawn) and [3, B, T] ``positions``."""
    batch = dict(JTokenPipeline(cfg.vocab, T, b).batch_at(0))
    emb = np.asarray(params_j["embed"])[np.asarray(batch["tokens"])]
    n = GRID[0] * GRID[1]
    emb[:, TEXT0:TEXT0 + n] = np.random.default_rng(6).standard_normal(
        (b, n, cfg.d_model)) * cfg.d_model ** -0.5
    batch["embeds"] = jnp.asarray(emb.astype(np.float32))
    batch["positions"] = jnp.asarray(vision_positions(b, TEXT0, GRID, TEXT1))
    return batch


def test_train_step_from_embeds_and_vision_positions_matches():
    """One AdamW step on a batch with ``embeds`` and [3, B, T]
    ``positions`` (one microbatch: the reference cuts every batch array
    on its leading axis): loss, grad_norm and lr, then every parameter
    leaf; the tied embedding's gradient comes from the head alone."""
    cfg_j, cfg = _cfgs()
    acfg = jo.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=3)
    tcfg_j = jts.TrainConfig(adamw=acfg)
    tcfg = tts.TrainConfig(adamw=to.AdamWConfig(**dataclasses.asdict(acfg)))
    state_j = jts.init_train_state(cfg_j, tcfg_j, jax.random.PRNGKey(0))
    state = convert.train_state_from_jax(cfg, state_j, "cpu")
    batch_j = _vision_batch(cfg, state_j.params)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in batch_j.items()}
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


def test_microbatches_refuse_positions_without_a_leading_batch_axis():
    cfg_j, cfg = _cfgs()
    params_j = jt.init_params(cfg_j, jax.random.PRNGKey(0))
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in _vision_batch(cfg, params_j).items()}
    state = tts.init_train_state(cfg, tts.TrainConfig(microbatches=2),
                                 torch.Generator().manual_seed(0), "cpu")
    step = tts.make_train_step(cfg, tts.TrainConfig(microbatches=2))
    with pytest.raises(ValueError, match="leading axis"):
        step(state, batch)
