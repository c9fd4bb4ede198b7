"""The gradient of the flash_attention op on the CPU: its plain backward
``attention_bwd_ref`` (the backward kernel's three steps with
materialised scores) and the op's ``torch.autograd.Function``.

Inputs are numpy draws from fixed seeds, GQA groups 1, 2 and 4, causal and
not, T ragged against every tile size.  Bounds: against
``torch.autograd`` of ``attention_ref`` in float64, 1e-10 of each
gradient's largest |g| (the two orders of the same float64 sums);
against ``jax.vjp`` of the reference's ``attention_ref`` in float32, 1e-5
of each gradient's largest |g| (float32 sums of up to S = 75 terms in
other orders, and torch's and XLA's exp); the Function against plain
autograd of ``attention_ref``, float32, the same 1e-5.  A bf16 gradient
on the CPU is the float32 plain backward of the bf16 values, rounded to
bf16, bit for bit.

The bf16 backward kernel on the card rounds P and dS to bf16 before their
products and the gradients at the end; ``attention_bwd_rounded`` is the
plain emulation of those roundings.  With them off it is
``attention_bwd_ref`` bit for bit; with them on it stays within the card
tests' bf16 bound, 1e-4 max|g| + 2^-8 |g| + ``bf16_rounding_terms`` (each
rounded operand off by at most 2^-9 of itself, taken at 2^-8), at causal,
ragged and GQA shapes: the bound follows from the roundings, not from the
card's readings.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import ops as fa_ops
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = [  # B, H, H_kv, T, S, D
    (2, 4, 4, 37, 37, 16), (1, 4, 2, 75, 75, 32), (2, 8, 2, 19, 19, 16),
    (1, 4, 1, 33, 50, 64), (2, 2, 2, 1, 70, 16)]
CASES = [(shape, causal) for shape in SHAPES for causal in (True, False)
         if not (causal and shape[3] != shape[4])]


def draw(shape, seed, dtype=np.float32):
    b, h, h_kv, t, s, d = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(dtype)
            for sh in ((b, h, t, d), (b, h_kv, s, d), (b, h_kv, s, d),
                       (b, h, t, d))]


def assert_close_to_max(got, want, rel):
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= rel * np.abs(w).max(), \
            (np.abs(g - w).max(), np.abs(w).max())


@pytest.mark.parametrize("shape,causal", CASES)
def test_bwd_ref_is_autograd_of_attention_ref(shape, causal):
    q, k, v, do = (torch.from_numpy(x) for x in draw(shape, 1, np.float64))
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    o = fa.attention_ref(*qkv, causal=causal)
    want = torch.autograd.grad(o, qkv, do)
    got = fa.attention_bwd_ref(q, k, v, o.detach(), do, causal=causal)
    assert_close_to_max(got, want, 1e-10)


@pytest.mark.parametrize("shape,causal", CASES)
def test_bwd_ref_matches_the_references_vjp(shape, causal):
    q, k, v, do = draw(shape, 2)
    o_j, vjp = jax.vjp(lambda a, b, c: j_attention_ref(a, b, c, causal),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    o = fa.attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                         causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=1e-6)
    got = fa.attention_bwd_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                               o, torch.from_numpy(do), causal=causal)
    assert_close_to_max([g.numpy() for g in got], want, 1e-5)


@pytest.mark.parametrize("shape,causal", CASES)
def test_the_op_is_differentiable_on_the_cpu(shape, causal):
    q, k, v, do = (torch.from_numpy(x) for x in draw(shape, 3))
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    o = fa.attention(*qkv, causal=causal)
    o_plain = fa.attention_ref(*plain, causal=causal)
    assert torch.equal(o.detach(), o_plain.detach())
    before = fa_ops.launches_bwd
    got = torch.autograd.grad(o, qkv, do)
    assert fa_ops.launches_bwd == before       # the CPU launches nothing
    assert_close_to_max(got, torch.autograd.grad(o_plain, plain, do), 1e-5)
    direct = fa.attention_bwd(q, k, v, o.detach(), do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, direct))


def test_bf16_gradient_on_the_cpu_is_the_float32_one_rounded():
    q, k, v, do = (torch.from_numpy(x).bfloat16()
                   for x in draw((1, 4, 2, 40, 40, 128), 4))
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    o = fa.attention(*qkv)
    got = torch.autograd.grad(o, qkv, do)
    want = fa.attention_bwd_ref(*(x.float() for x in (q, k, v, o, do)))
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.bfloat16())


def test_bwd_raises_outside_the_contract():
    x = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="o and do"):
        fa.attention_bwd(x, x, x, x, x[:, :, :4])
    with pytest.raises(ValueError, match="o and do"):
        fa.attention_bwd(x, x, x, x.double(), x)
    with pytest.raises(ValueError, match="head dims"):
        y = torch.zeros(1, 2, 8, 80)
        fa.attention_bwd(y, y, y, y, y)
    with pytest.raises(ValueError, match="T == S"):
        kv = torch.zeros(1, 2, 9, 16)
        fa.attention_bwd(x, kv, kv, x, x, causal=True)


ROUNDING_CASES = [  # B, H, H_kv, T, S, D, causal
    ((1, 4, 4, 64, 64, 128), True), ((2, 4, 2, 75, 75, 128), True),
    ((1, 8, 2, 37, 37, 32), True), ((1, 4, 1, 33, 90, 128), False),
    ((2, 2, 2, 1, 70, 16), False)]


@pytest.mark.parametrize("shape,causal", ROUNDING_CASES)
def test_bf16_rounding_emulation_within_its_bound(shape, causal):
    q, k, v, do = (torch.from_numpy(x).bfloat16().float()
                   for x in draw(shape, 5))
    # The forward kernel's output, rounded to bf16.
    o = fa.attention_ref(q, k, v, causal=causal).bfloat16().float()
    ref = fa.attention_bwd_ref(q, k, v, o, do, causal=causal)
    off = fa.attention_bwd_rounded(q, k, v, o, do, causal=causal,
                                   roundings=False)
    assert all(torch.equal(a, b) for a, b in zip(off, ref))
    on = fa.attention_bwd_rounded(q, k, v, o, do, causal=causal)
    terms = fa.bf16_rounding_terms(q, k, v, o, do, causal=causal)
    for name, a, r, term in zip(("dq", "dk", "dv"), on, ref, terms):
        assert term.shape == r.shape and bool((term >= 0).all()), name
        assert torch.equal(a, a.bfloat16().float()), name
        assert not torch.equal(a, r), name       # the roundings move it
        bound = 1e-4 * float(r.abs().max()) + 2 ** -8 * r.abs() + term
        assert bool(((a - r).abs() <= bound).all()), \
            (name, float(((a - r).abs() / bound).max()))


def test_the_statistic_on_the_cpu():
    """attention_with_lse's plain path: the output of attention, and the
    rows' log-sum-exp in the log2 domain over stat_rows(T) rows, 0 past
    T; a bf16 backward on the CPU takes it or not alike, and a CPU forward
    writes no statistic."""
    q, k, v, do = (torch.from_numpy(x).bfloat16()
                   for x in draw((1, 4, 2, 40, 40, 128), 6))
    before = fa_ops.lse_written
    o, lse = fa.attention_with_lse(q, k, v)
    assert fa_ops.lse_written == before
    assert torch.equal(o, fa.attention(q, k, v))
    assert lse.shape == (1, 4, fa_ops.stat_rows(40)) == (1, 4, 128)
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(),
                          torch.repeat_interleave(k.float(), 2, dim=1))
    scores = scores / 128 ** 0.5 + torch.full((40, 40), float("-inf")).triu(1)
    want = torch.logsumexp(scores, dim=-1) / np.log(2)
    assert float((lse[..., :40] - want).abs().max()) <= 1e-5
    assert not lse[..., 40:].any()
    got = fa.attention_bwd(q, k, v, o, do, lse=lse)
    assert all(torch.equal(a, b) for a, b in zip(
        got, fa.attention_bwd(q, k, v, o, do)))
    with pytest.raises(ValueError, match="bf16 kernel"):
        fa.attention_with_lse(q.float(), k.float(), v.float())
