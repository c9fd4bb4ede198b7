"""The port's Whisper encoder-decoder (whisper-large-v3) against the
reference's ``models/transformer.py``, ``models/attention.py``,
``train/serve_step.py`` and ``train/train_step.py``.

At ``reduced()`` size, float32: 2 encoder and 2 decoder layers, 32 frames,
d 64, 4/4 heads of 16, d_ff 128, vocab 256, LayerNorm, untied, sinusoid
positions.  The frames (the audio frontend's stub output), the tokens and
the drawn training states come from numpy seeds; the reference's weights
are carried into the port with ``convert.lm_params_from_jax``.

Tolerances: ``_sinusoid`` within 1e-6 absolute (the port computes the
reference's frequency table bit for bit, ``transformer._exp_f32``; only
torch's and XLA's sin and cos part them, by an ulp); the encoder output,
logits and cache tensors within 2e-5 abs + 2e-5 rel (the port's LM tests'
float32 bound: torch and XLA round matmuls and transcendentals a few ulp
apart); cache positions and greedy tokens exact (the reference's best two
logits at every compared step at least 1e-3 apart); one train step's loss,
grad_norm and lr within 1e-5 relative and each parameter leaf within 1e-4
of its largest |value| (``tests/test_torch_train.py``'s bounds);
checkpoints bit for bit; dtypes exactly.
"""
import dataclasses

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
from repro.train.serve_step import generate as j_generate
from repro.train.serve_step import prefill as j_prefill
from repro.train import train_step as jts

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tt
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.serve import serve_step as tss
from repro_torch.train import optimizer as to
from repro_torch.train import train_step as tts
from torch_threads import one_torch_thread  # noqa: F401

NAME = "whisper-large-v3"
ATOL = RTOL = 2e-5
SINUSOID_ATOL = 1e-6
STEP_RTOL = 1e-5
PARAM_TOL = 1e-4      # of each leaf's max |value|
B, T, NEW = 2, 24, 8


def _cfgs(**kw):
    return (dataclasses.replace(j_get_arch(NAME).reduced(), **kw),
            dataclasses.replace(get_arch(NAME).reduced(), **kw))


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _frames(cfg, b, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(
        dtype)


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
        self.frames = _frames(self.cfg, B, 4)
        cfg = self.cfg_j
        self.enc_j = jax.jit(lambda p, f: jt.encode(cfg, p, f))(
            self.params_j, jnp.asarray(self.frames))
        self.enc = tt.encode(self.cfg, self.params,
                             torch.from_numpy(self.frames))


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


def test_config_equals_the_reference():
    j, t = j_get_arch(NAME), get_arch(NAME)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (t.encoder_layers, t.encoder_seq, t.hd, t.rope_kind) == (
        32, 1500, 64, "none")


# ---------------------------------------------------------------------------
# Sinusoid positions and the encoder.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [16, 64, 1280])
def test_sinusoid_matches_reference(d):
    """Positions 0..1499 (the encoder's frames at full size) as [B, T],
    and a decode step's [B, 1]."""
    pos = np.arange(1500, dtype=np.int32).reshape(2, 750)
    for p in (pos, pos[:, -1:]):
        got = tt._sinusoid(torch.from_numpy(p), d)
        want = np.asarray(jt._sinusoid(jnp.asarray(p), d))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=SINUSOID_ATOL,
                                   rtol=0)


def test_encode_matches_reference():
    m = model()
    assert m.enc.dtype == torch.float32
    assert m.enc.shape == (B, m.cfg.encoder_seq, m.cfg.d_model)
    _close(m.enc, m.enc_j)
    # use_kernel=False is the reference's path; on the CPU the kernel's
    # plain version is the same function.
    plain = tt.encode(m.cfg, m.params, torch.from_numpy(m.frames),
                      use_kernel=False)
    assert torch.equal(plain, m.enc)


# ---------------------------------------------------------------------------
# The decoder: forward, prefill, decode, serving.
# ---------------------------------------------------------------------------

def test_forward_with_enc_out_matches_reference():
    m = model()
    cfg = m.cfg_j
    got, aux = tt.forward(m.cfg, m.params, m.tokens, enc_out=m.enc)
    want, _ = jax.jit(lambda p, t, e: jt.forward(cfg, p, t, enc_out=e))(
        m.params_j, jnp.asarray(m.tokens.numpy()), m.enc_j)
    assert got.shape == (B, T, m.cfg.vocab) and float(aux) == 0.0
    _close(got, want)
    with pytest.raises(ValueError, match="enc_out"):
        tt.forward(m.cfg, m.params, m.tokens)


def _cross_kv_j(cache_j, u):
    return [np.asarray(x)[u] for x in
            cache_j["units"]["b0_dec_cross"]["cross_kv"]]


def test_prefill_with_cross_kv_matches_reference():
    m = model()
    cfg = m.cfg_j
    logits, cache = tt.prefill_forward(m.cfg, m.params, m.tokens, T + NEW,
                                       enc_out=m.enc)
    logits_j, cache_j = jax.jit(lambda p, t, e: jt.prefill_forward(
        cfg, p, t, T + NEW, enc_out=e))(
        m.params_j, jnp.asarray(m.tokens.numpy()), m.enc_j)
    _close(logits, logits_j)
    full, _ = tt.forward(m.cfg, m.params, m.tokens, enc_out=m.enc)
    _close(logits[:, 0], full[:, -1].numpy())
    for u, layer in enumerate(cache["layers"]):
        want = jax.tree.map(lambda a: np.asarray(a)[u],
                            cache_j["units"]["b0_dec_cross"]["attn"])
        np.testing.assert_array_equal(layer["attn"]["pos"].numpy(),
                                      want["pos"])
        for key in ("k", "v"):
            _close(layer["attn"][key], want[key])
        k, v = layer["cross_kv"]
        assert k.shape == (B, m.cfg.n_kv_heads, m.cfg.encoder_seq, m.cfg.hd)
        for got, want_kv in zip((k, v), _cross_kv_j(cache_j, u)):
            _close(got, want_kv)


def test_teacher_forced_decode_matches_forward_and_reference():
    """Decode steps from the prefill's cache (cross K/V read, never
    written) against the forward over the longer sequence, and against
    the reference's decode_step."""
    m = model()
    cfg = m.cfg_j
    full, _ = tt.forward(m.cfg, m.params, m.tokens_all, enc_out=m.enc)
    _, cache = tt.prefill_forward(m.cfg, m.params, m.tokens, T + NEW,
                                  enc_out=m.enc)
    cross = [tuple(x.clone() for x in c["cross_kv"]) for c in
             cache["layers"]]
    _, cache_j = jax.jit(lambda p, t, e: jt.prefill_forward(
        cfg, p, t, T + NEW, enc_out=e))(
        m.params_j, jnp.asarray(m.tokens.numpy()), m.enc_j)
    step_j = jax.jit(lambda p, tok, c, pos: jt.decode_step(cfg, p, tok, c,
                                                           pos))
    for i in range(NEW):
        tok = m.tokens_all[:, T + i:T + i + 1]
        logits, cache = tt.decode_step(m.cfg, m.params, tok, cache,
                                       torch.tensor(T + i))
        logits_j, cache_j = step_j(m.params_j, jnp.asarray(tok.numpy()),
                                   cache_j, jnp.asarray(T + i, jnp.int32))
        _close(logits[:, 0], full[:, T + i].numpy())
        _close(logits, logits_j)
    for c, (k, v) in zip(cache["layers"], cross):
        assert torch.equal(c["cross_kv"][0], k)
        assert torch.equal(c["cross_kv"][1], v)


def test_serve_step_prefill_fills_cross_kv_as_the_reference():
    """``serve_step.prefill``: fill_cross_kv, then the prompt teacher-forced
    through decode_step; the cache (self and cross) and the next token
    against the reference's; generate's tokens equal."""
    m = model()
    cfg = m.cfg_j
    prompt = m.tokens[:, :12].contiguous()
    logits, state = tss.prefill(m.cfg, m.params, prompt, 12 + NEW,
                                enc_out=m.enc)
    logits_j, state_j = jax.jit(lambda p, t, e: j_prefill(
        cfg, p, t, 12 + NEW, enc_out=e))(
        m.params_j, jnp.asarray(prompt.numpy()), m.enc_j)
    _close(logits, logits_j)
    np.testing.assert_array_equal(state.last_token.numpy(),
                                  np.asarray(state_j.last_token))
    for u, layer in enumerate(state.cache["layers"]):
        for got, want in zip(layer["cross_kv"],
                             _cross_kv_j(state_j.cache, u)):
            _close(got, want)
        want = jax.tree.map(lambda a: np.asarray(a)[u],
                            state_j.cache["units"]["b0_dec_cross"]["attn"])
        np.testing.assert_array_equal(layer["attn"]["pos"].numpy(),
                                      want["pos"])
        _close(layer["attn"]["k"], want["k"])
    # generate: the reference's best two logits stay apart at every step.
    got = tss.generate(m.cfg, m.params, prompt, NEW, 12 + NEW,
                       enc_out=m.enc)
    want = jax.jit(lambda p, t, e: j_generate(cfg, p, t, NEW, 12 + NEW,
                                                enc_out=e))(
        m.params_j, jnp.asarray(prompt.numpy()), m.enc_j)
    full, _ = jax.jit(lambda p, t, e: jt.forward(cfg, p, t, enc_out=e))(
        m.params_j, want, m.enc_j)
    top2 = np.sort(np.asarray(full[:, 11:-1]), axis=-1)[..., -2:]
    assert float((top2[..., 1] - top2[..., 0]).min()) > 1e-3
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_launch_serve_runs_whisper_reduced_on_the_cpu(capsys):
    tserve.main(["--arch", NAME, "--reduced", "--device", "cpu",
                 "--prompt-len", "20", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "encode [4x32]" in out and "prefill [4x20]" in out
    assert "decoded 3 steps" in out


def test_serve_needs_frames():
    m = model()
    with pytest.raises(ValueError, match="frames"):
        tserve.serve(m.cfg, m.params, m.tokens, 2)


# ---------------------------------------------------------------------------
# The dtype trap: the encoder keeps the frames' dtype.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frames_dtype", ["float32", "bfloat16"])
def test_encoder_keeps_the_frames_dtype(frames_dtype):
    """A bf16 copy of the reduced config: float32 frames run the encoder in
    float32 (JAX promotes float32 activations against bf16 weights), so
    enc_out and the prefill's cross K/V are float32 in both packages;
    bf16 frames keep everything bf16.  The decoder's own cache is bf16
    either way."""
    cfg_j, cfg = _cfgs(dtype="bfloat16")
    params_j = jt.init_params(cfg_j, jax.random.PRNGKey(5))
    params = convert.lm_params_from_jax(cfg, params_j, "cpu")
    frames = _frames(cfg, B, 6)
    f_j = jnp.asarray(frames).astype(getattr(jnp, frames_dtype))
    f_t = torch.from_numpy(frames).to(getattr(torch, frames_dtype))
    enc_j = jt.encode(cfg_j, params_j, f_j)
    enc = tt.encode(cfg, params, f_t)
    toks = model().tokens[:, :8].contiguous()
    _, cache_j = jt.prefill_forward(cfg_j, params_j,
                                    jnp.asarray(toks.numpy()), 12,
                                    enc_out=enc_j)
    _, cache = tt.prefill_forward(cfg, params, toks, 12, enc_out=enc)
    want = getattr(torch, frames_dtype)
    assert str(enc_j.dtype) == frames_dtype and enc.dtype == want
    for u, layer in enumerate(cache["layers"]):
        kv_j = cache_j["units"]["b0_dec_cross"]["cross_kv"]
        assert [str(x.dtype) for x in kv_j] == [frames_dtype] * 2
        assert [x.dtype for x in layer["cross_kv"]] == [want] * 2
        assert layer["attn"]["k"].dtype == torch.bfloat16
        assert str(cache_j["units"]["b0_dec_cross"]["attn"]["k"].dtype) == \
            "bfloat16"
    if frames_dtype == "float32":
        # The float32 encoder runs on bf16 weights cast up, as XLA's.
        _close(enc, enc_j)
        # fill_cross_kv replaces the bf16 zeros init_cache made.
        c = tss.fill_cross_kv(cfg, params,
                              tt.init_cache(cfg, B, 12, device="cpu"), enc)
        assert [x.dtype for x in c["layers"][0]["cross_kv"]] == \
            [torch.float32] * 2


# ---------------------------------------------------------------------------
# Parameters, training and checkpoints.
# ---------------------------------------------------------------------------

def test_convert_carries_every_whisper_leaf():
    m = model()
    leaves = tt.stacked_leaves(m.params)
    flat_j = tts.unnest(m.params_j)
    assert list(leaves) == list(flat_j)
    assert "enc_norm.scale" in leaves and tt.is_stacked(
        "enc_units.b0_enc.attn.wq")
    assert {k.split(".", 2)[2] for k in leaves
            if k.startswith("units.b0_dec_cross.")} >= {
        "ln_cross.scale", "ln_cross.bias", "cross.wq", "cross.wk",
        "cross.wv", "cross.wo"}
    for leaf, ps in leaves.items():
        want = np.asarray(flat_j[leaf])
        got = (torch.stack(ps) if tt.is_stacked(leaf) else ps[0]).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), leaf


def test_init_params_draws_the_encoder_and_cross_leaves():
    cfg = get_arch(NAME).reduced()
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert len(params.encoder) == cfg.encoder_layers
    s = cfg.d_model ** -0.5
    for w in (params.encoder[0].attn.wq, params.layers[0].cross.wk):
        assert abs(float(w.std()) / s - 1.0) < 0.15
    assert torch.equal(params.enc_norm.scale, torch.ones(cfg.d_model))
    assert torch.equal(params.layers[1].ln_cross.bias,
                       torch.zeros(cfg.d_model))
    assert not torch.equal(params.encoder[0].attn.wq,
                           params.encoder[1].attn.wq)


def test_train_step_with_frames_matches():
    """One AdamW step (2 microbatches) on a batch with ``frames``: loss,
    grad_norm and lr, then every parameter leaf, the encoder's included."""
    cfg_j, cfg = _cfgs()
    acfg = jo.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=3)
    tcfg_j = jts.TrainConfig(adamw=acfg, microbatches=2)
    tcfg = tts.TrainConfig(adamw=to.AdamWConfig(**dataclasses.asdict(acfg)),
                           microbatches=2)
    state_j = jts.init_train_state(cfg_j, tcfg_j, jax.random.PRNGKey(0))
    state = convert.train_state_from_jax(cfg, state_j, "cpu")
    batch_j = dict(JTokenPipeline(cfg.vocab, 16, 4).batch_at(0))
    batch_j["frames"] = jnp.asarray(_frames(cfg, 4, 7))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in batch_j.items()}
    state_j, met_j = jax.jit(jts.make_train_step(cfg_j, tcfg_j))(state_j,
                                                                 batch_j)
    state, met = tts.make_train_step(cfg, tcfg)(state, batch)
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(met[key]) - float(met_j[key])) <= \
            STEP_RTOL * abs(float(met_j[key])), key
    assert float(state.opt.mu["enc_units.b0_enc.attn.wq"].abs().max()) > 0
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


def test_each_package_reads_the_others_whisper_checkpoint(tmp_path):
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
    assert "b0_enc" in back.params["enc_units"]
    assert "cross" in back.params["units"]["b0_dec_cross"]
