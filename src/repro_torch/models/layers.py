"""Shared model primitives: norms, rotary embeddings, gated MLP (the
reference's ``models/layers.py``).

``init_*`` fill a given parameter from a ``torch.Generator``; ``apply_*``
take (params, x) and compute in the reference's order and types.  Norm
scales and biases are float32, weights are in the config dtype.
``apply_mlp`` takes a ``tp`` (``models/tp.py``): the rank's block of d_ff,
column-parallel in, row-parallel out.

The reference defines these functions, not the published models: RoPE
rotates *interleaved* pairs (``x[..., ::2]``, ``x[..., 1::2]``) with
θ = 10,000 for every config, and the norms use eps = 1e-6 with the
population variance.  The port keeps all three (ROADMAP queue 3).
``apply_mrope`` (Qwen2-VL's M-RoPE) rotates the same pairs, its angle
table built from three position rows, one a section of the pairs.

Products with a weight go through :func:`mm`, which takes JAX's type
promotion: float32 activations against bf16 weights multiply in float32
(torch's ``@`` refuses mixed types).  The Whisper encoder meets it, where
float32 frames run a bf16 model's encoder in float32, as in the
reference; everywhere else the two types agree and ``mm`` is ``@``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a FakeTensorMode tensor (shapes, no values: the
    dry run's, ``launch/dryrun.py``)."""
    from torch._subclasses.fake_tensor import is_fake as fake
    return fake(t)


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Fill ``t`` in place with N(0, std²) drawn in float32 from ``gen``
    (on ``t``'s device) and rounded once to ``t``'s dtype."""
    t.copy_(torch.randn(t.shape, generator=gen, device=t.device,
                        dtype=torch.float32) * std)


def _param(*shape, dtype, device) -> nn.Parameter:
    # No parameter asks for a gradient at init, so serving records no
    # autograd graph; training turns them on (train_step.init_train_state).
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """``scale`` (rmsnorm, layernorm) and ``bias`` (layernorm), float32;
    none for olmo's non-parametric LayerNorm."""

    def __init__(self, kind: str, d: int, device=None):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm", "nonparam_ln"):
            raise ValueError(kind)
        if kind in ("rmsnorm", "layernorm"):
            self.scale = _param(d, dtype=torch.float32, device=device)
        if kind == "layernorm":
            self.bias = _param(d, dtype=torch.float32, device=device)


def init_norm(norm: Norm) -> None:
    """Scale 1, bias 0 (the reference's init)."""
    if hasattr(norm, "scale"):
        norm.scale.fill_(1.0)
    if hasattr(norm, "bias"):
        norm.bias.zero_()


def apply_norm(kind: str, params: Norm, x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        out = xf / rms * params.scale
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            out = out * params.scale + params.bias
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings.
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float = 10_000.0, device=None
               ) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x [..., T, D]; positions int32[..., T] (broadcastable).  Rotates the
    interleaved pairs (x[2i], x[2i+1]) by ``positions · θ^(-2i/D)``."""
    d = x.shape[-1]
    while positions.dim() < x.dim() - 1:      # insert head axes before T
        positions = positions[..., None, :]
    freqs = rope_freqs(d, theta, x.device)                  # [D/2]
    return _rotate(x, positions[..., None].float() * freqs)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """The pairs (x[2i], x[2i+1]) rotated by ``angles`` [..., T, D/2], back
    in x's dtype."""
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., ::2], x[..., 1::2]
    rx1 = x1 * cos - x2 * sin
    rx2 = x1 * sin + x2 * cos
    return torch.stack([rx1, rx2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections=(0.25, 0.375, 0.375), theta: float = 10_000.0
                ) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the D/2 rotary pairs split into (temporal, height,
    width) sections of ``int(D/2 · s)`` pairs (the last takes the rest;
    16/24/24 at D = 128), each rotated by its own position row.

    x [..., T, D]; positions3 int32[3, ..., T] (head axes inserted before
    T).  With three equal rows this is :func:`apply_rope` exactly."""
    d = x.shape[-1]
    half = d // 2
    bounds = [0]
    for s in sections[:-1]:
        bounds.append(bounds[-1] + int(half * s))
    bounds.append(half)
    freqs = rope_freqs(d, theta, x.device)                  # [D/2]
    parts = []
    for i in range(3):
        pos = positions3[i]
        while pos.dim() < x.dim() - 1:        # insert head axes before T
            pos = pos[..., None, :]
        parts.append(pos[..., None].float() * freqs[bounds[i]:bounds[i + 1]])
    return _rotate(x, torch.cat(parts, dim=-1))


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU) and linear layers.
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype, device=None):
        super().__init__()
        self.w_gate = _param(d_model, d_ff, dtype=dtype, device=device)
        self.w_up = _param(d_model, d_ff, dtype=dtype, device=device)
        self.w_down = _param(d_ff, d_model, dtype=dtype, device=device)


def init_mlp(mlp: MLP, gen: torch.Generator) -> None:
    d_model, d_ff = mlp.w_gate.shape
    normal_(mlp.w_gate, d_model ** -0.5, gen)
    normal_(mlp.w_up, d_model ** -0.5, gen)
    normal_(mlp.w_down, d_ff ** -0.5, gen)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted type of the two, as JAX multiplies mixed
    types: the narrower operand (a bf16 weight against float32
    activations) is cast up, never the other way."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def widen(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32 at least: where the reference casts up to float32
    (``astype(jnp.float32)``), bf16 and float32 give float32 and float64
    stays float64, so a float64 copy of a model runs in float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def apply_mlp(params: MLP, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The SwiGLU; with ``tp`` (``models/tp.py``) on this rank's block of
    d_ff, its input entering and its output leaving over the model
    axis."""
    if tp is not None:
        x = tp.enter(x)
    gate = F.silu(mm(x, params.w_gate))
    y = mm(gate * mm(x, params.w_up), params.w_down)
    return y if tp is None else tp.exit(y)


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, dtype, device=None,
                 bias: bool = False):
        super().__init__()
        self.w = _param(d_in, d_out, dtype=dtype, device=device)
        if bias:
            self.b = _param(d_out, dtype=dtype, device=device)


def init_linear(lin: Linear, gen: torch.Generator) -> None:
    normal_(lin.w, lin.w.shape[0] ** -0.5, gen)
    if hasattr(lin, "b"):
        lin.b.zero_()


def apply_linear(params: Linear, x: torch.Tensor) -> torch.Tensor:
    y = x @ params.w
    if hasattr(params, "b"):
        y = y + params.b
    return y
