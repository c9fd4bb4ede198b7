"""The port's flash_attention op against the reference's.

On the CPU the port's ``ops.attention`` runs its plain version
(``ref.py``).  It is held against the reference's Pallas kernel
``flash_attention`` run in interpret mode, within 2e-4 abs + 2e-4 rel (the
bound of the reference's own kernel-vs-oracle test,
``tests/test_kernels.py``: the kernel adds blocks in another order), and
against the reference's plain ``attention_ref`` within 1e-5 abs + 1e-5 rel
(both materialise the scores; einsum and softmax round differently in XLA
and torch).  Inputs are made with numpy from a seed.  Shapes: those of
``tests/test_kernels.py`` plus GQA group 4 and D = 16; causal only at
T == S, where the Pallas kernel (diagonal top-left) and the plain
versions (bottom-right) agree.

bfloat16: the op on bf16 CPU tensors is the float32 plain version on the
same values rounded to bf16, bit for bit, and lies within
2^-8 max|v| + 2^-8 |ref| of the Pallas kernel run in interpret mode on the
same bf16 values (which feeds its products bf16 operands, rounds P to
bf16 before P.V and returns bf16).  The bound: bf16 keeps 8 significant
bits, so rounding P moves each weight by at most 2^-8 relative, 2^-8
max|v| on the output (the errors' random signs keep the sum far below
that), and rounding the output costs at most 2^-8 |o|; the float32 sum
order is far below either.  It is the bound the bf16 CUDA kernel is held
to on the card; here both sides round the output, and the cases read
0.11-0.63 of it.  The bf16 head dims are 64 and 128 (every dense config's
and Whisper's); the Pallas kernel runs at blocks of 128, or of 64 where
128 does not divide T and S.

The CUDA kernels themselves are held against the plain version on the card
by ``tests/test_torch_gpu.py``.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import attention_ref as j_attention_ref
from repro.kernels.flash_attention import flash_attention as j_flash

from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels.flash_attention import ops as fa_ops
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(2, 4, 2, 256, 256, 64), (1, 8, 8, 128, 128, 32),
          (2, 4, 1, 256, 384, 64), (1, 2, 2, 384, 128, 128),
          (1, 8, 2, 256, 256, 128), (2, 4, 4, 128, 256, 16)]


def _inputs(b, h, hkv, t, s, d):
    rng = np.random.default_rng(t + s + 7 * d + h)
    return (rng.normal(size=(b, h, t, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32))


# Causal only at T == S (the kernel contract).
CASES = [(*shape, causal) for shape in SHAPES for causal in (True, False)
         if shape[3] == shape[4] or not causal]


@pytest.mark.parametrize("b,h,hkv,t,s,d,causal", CASES)
def test_matches_reference(b, h, hkv, t, s, d, causal):
    q, k, v = _inputs(b, h, hkv, t, s, d)
    before = fa_ops.launches
    got = t_fa.attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert fa_ops.launches == before      # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (b, h, t, d)
    got = got.numpy()
    pallas = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), causal=causal))
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4)
    oracle = np.asarray(j_attention_ref(*map(jnp.asarray, (q, k, v)),
                                        causal=causal))
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


def test_plain_version_is_the_ops_result_on_cpu():
    q, k, v = map(torch.from_numpy, _inputs(1, 8, 2, 100, 100, 32))
    for causal in (True, False):
        assert torch.equal(t_fa.attention(q, k, v, causal=causal),
                           t_fa.attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("shape_q,shape_kv,causal,match", [
    ((1, 2, 128, 64), (1, 2, 256, 64), True, "T == S"),
    ((1, 2, 64, 48), (1, 2, 64, 48), False, "head dims"),
    ((1, 2, 64, 256), (1, 2, 64, 256), True, "head dims"),
    ((1, 6, 64, 32), (1, 4, 64, 32), False, "multiple of H_kv"),
    ((2, 2, 64, 32), (1, 2, 64, 32), False, "q is"),
])
def test_raises_outside_the_kernel_contract(shape_q, shape_kv, causal,
                                            match):
    q = torch.zeros(shape_q)
    kv = torch.zeros(shape_kv)
    with pytest.raises(ValueError, match=match):
        t_fa.attention(q, kv, kv, causal=causal)


BF16_TOL = 2 ** -8
BF16_CASES = [(1, 8, 2, 256, 256, 128, True), (2, 4, 1, 256, 384, 128, False),
              (2, 4, 2, 128, 128, 128, True),
              # D = 64 (Whisper's head width): non-causal T != S, and causal
              # T = S at a length the CUDA kernel's 128-row tiles cut ragged.
              (2, 4, 2, 128, 256, 64, False), (1, 4, 4, 192, 192, 64, True)]


def _bf16(arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


@pytest.mark.parametrize("b,h,hkv,t,s,d,causal", BF16_CASES + [
    (1, 4, 2, 100, 100, 128, True), (2, 2, 1, 1, 37, 128, False)])
def test_bf16_is_the_float32_plain_version_rounded(b, h, hkv, t, s, d,
                                                   causal):
    q, k, v = _bf16(_inputs(b, h, hkv, t, s, d))
    before = (fa_ops.launches, fa_ops.launches_bf16)
    got = t_fa.attention(q, k, v, causal=causal)
    assert (fa_ops.launches, fa_ops.launches_bf16) == before
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, t, d)
    want = t_fa.attention_ref(q.float(), k.float(), v.float(),
                              causal=causal).to(torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,h,hkv,t,s,d,causal", BF16_CASES)
def test_bf16_within_bound_of_pallas_kernel(b, h, hkv, t, s, d, causal):
    q, k, v = _bf16(_inputs(b, h, hkv, t, s, d))
    got = t_fa.attention(q, k, v, causal=causal).float().numpy()
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                  for x in (q, k, v))
    # The Pallas kernel's blocks divide T and S: 128, or 64 at T = 192.
    blk = math.gcd(t, s, 128)
    pallas = j_flash(jq, jk, jv, causal=causal, block_q=blk, block_k=blk)
    assert pallas.dtype == jnp.bfloat16
    pallas = np.asarray(pallas.astype(jnp.float32))
    bound = BF16_TOL * float(v.float().abs().max()) + BF16_TOL * np.abs(
        pallas)
    assert np.all(np.abs(got - pallas) <= bound), \
        float(np.max(np.abs(got - pallas) / bound))


@pytest.mark.parametrize("dtypes,d,match", [
    ((torch.bfloat16,) * 3, 32, "head dims"),
    ((torch.bfloat16,) * 3, 16, "head dims"),
    ((torch.float16,) * 3, 64, "float32 or bfloat16"),
    ((torch.bfloat16, torch.float32, torch.float32), 64, "one dtype"),
])
def test_bf16_contract_is_checked_on_the_cpu(dtypes, d, match):
    q, k, v = (torch.zeros(1, 2, 64, d, dtype=dt) for dt in dtypes)
    with pytest.raises(ValueError, match=match):
        t_fa.attention(q, k, v, causal=True)
