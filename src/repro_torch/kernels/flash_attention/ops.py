"""Public ops: attention through the flash_attention kernels, and its
gradient through the flash_attention_bwd kernel.

Two forward kernels, chosen by dtype.  float32 q, k, v launch
``csrc/flash_attention.cu`` (float32 FMA on the CUDA cores, D in {16, 32,
64, 128}); bfloat16 ones launch ``csrc/flash_attention_bf16.cu`` (bf16
``wgmma`` with float32 sums, P rounded to bf16 before P·V as the Pallas
kernel rounds it, a bf16 output; D in {64, 128}: every dense config's 128,
Whisper's 64).  Any other dtype raises.
On a CUDA tensor :func:`attention` launches the kernel or raises; on a CPU
tensor it runs the plain version (``ref.py``), for bf16 in float32 on
``.float()`` copies, rounded back to bf16.  On either device it takes the
kernels' contract: the head dims of the dtype, H a multiple of H_kv, and
T = S when causal (the kernels align the diagonal top-left, the plain
version bottom-right; they agree only at T = S).  Any T and S otherwise:
the kernels mask their ragged edges, so there is no block-multiple
condition.

:func:`attention` is differentiable (a ``torch.autograd.Function``): it
saves q, k, v and the output, and its backward is :func:`attention_bwd`,
with the same contract as the forward, dq, dk and dv in the input dtype.
On CPU tensors it runs ``attention_bwd_ref``.  On CUDA tensors float32
launches ``csrc/flash_attention_bwd.cu`` (float32 FMA on the CUDA cores,
its own pass for the softmax statistics) and bfloat16 launches
``csrc/flash_attention_bwd_bf16.cu`` (bf16 ``wgmma``, P and dS rounded
to bf16 before their products, float32 sums), which reads the forward's
log-sum-exp: when grad is enabled and q, k or v needs a gradient, the
bf16 forward kernel also writes each query row's log-sum-exp in the log2
domain (``lse2 = log2 sum_s 2^(q.k log2(e) / sqrt(D))``, float32
[B, H, Tp], Tp = T rounded up to STAT_ROWS), and the Function saves it
with q, k, v and the output.  A forward that needs no gradient (serving,
``no_grad``) writes and allocates nothing more.  A bf16 backward on the
card without the statistic raises; nothing falls back.  The gradient is
that of the float32 attention of the bf16 values: the forward's rounding
of P to bf16 has no derivative of its own, and enters only through the
saved output, in ``Delta = rowsum(do * o)``.

On the card each launch is a ``torch.library.custom_op``
(``repro_torch::flash_fwd``, ``flash_fwd_bf16``, ``flash_fwd_bf16_lse``,
``flash_bwd``, ``flash_bwd_bf16``) that :class:`_Attention` calls: the
implementation launches the kernel, checks alignment and counts
(``launches*``, ``lse_written``); its fake (``register_fake``) gives the
shapes and dtypes the kernel writes, so FakeTensorMode traces the op on
fake CUDA tensors (``launch/dryrun.py``) with nothing launched or counted.
Each op registers its kernel's FLOPs with ``torch.utils.flop_counter``
(:func:`fwd_flops`, :func:`bwd_flops`: the products over the tiles the
kernel visits, :func:`visited_pairs`).  :func:`on_card` picks the route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref, lse2_ref)

HEAD_DIMS = {torch.float32: (16, 32, 64, 128), torch.bfloat16: (64, 128)}
TILE = {torch.float32: 64, torch.bfloat16: 128}   # query rows of one block
BWD_TILE = {torch.float32: 64, torch.bfloat16: 128}   # largest backward tile
STAT_ROWS = 128        # the statistic's rows: T rounded up to this

launches = 0           # float32 kernel launches since the last reset
launches_bf16 = 0      # bf16 kernel launches since the last reset
launches_bwd = 0       # backward kernel launches (3 a call), either dtype
lse_written = 0        # bf16 forward launches that wrote the statistic


def stat_rows(t: int) -> int:
    """Rows of the statistic for T query rows (T rounded up to
    STAT_ROWS)."""
    return -(-t // STAT_ROWS) * STAT_ROWS


def _check_shapes(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention takes q [B, H, T, D] and k, v "
                         f"[B, H_kv, S, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in HEAD_DIMS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q, k, "
                         f"v of one dtype; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    b, h, t, d = q.shape
    bk, h_kv, s, dk = k.shape
    if bk != b or dk != d:
        raise ValueError(f"q is {tuple(q.shape)} but k is {tuple(k.shape)}")
    if d not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"flash_attention takes head dims "
                         f"{HEAD_DIMS[q.dtype]} in {q.dtype}, got D={d}")
    if h_kv < 1 or h % h_kv:
        raise ValueError(f"H={h} must be a multiple of H_kv={h_kv} (GQA)")
    if causal and t != s:
        raise ValueError(f"causal attention needs T == S, got T={t} S={s}")


def on_card(q: torch.Tensor) -> bool:
    """Whether attention on ``q`` takes the kernels (the custom ops below)
    rather than the plain version: a CUDA tensor, real or fake."""
    return q.is_cuda


def _launch_fwd(q, k, v, causal: bool, want_lse: bool
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The forward kernel of q's dtype on the card: (output, the statistic
    when ``want_lse``, else None)."""
    b, h, t, d = q.shape
    _, h_kv, s, _ = k.shape
    from repro_torch.kernels import _build
    global launches, launches_bf16, lse_written
    lib = _build.library()
    out = torch.empty_like(q)
    lse = None
    p = _build.ptr
    args = (p(q, q.dtype, "q"), p(k, q.dtype, "k"), p(v, q.dtype, "v"))
    if q.dtype == torch.bfloat16:
        # TMA reads the tensors through descriptors that need 16-byte
        # aligned bases.
        if any(a % 16 for a in args):
            raise ValueError("flash_attention_bf16 needs 16-byte aligned "
                             "q, k, v")
        if want_lse:
            lse = torch.empty((b, h, stat_rows(t)), dtype=torch.float32,
                              device=q.device)
        err = lib.flash_attention_bf16(*args, b, h, h_kv, t, s, d,
                                       int(causal), out.data_ptr(),
                                       lse.data_ptr() if want_lse else None,
                                       q.device.index, _build.stream_of(q))
        _build.check(err, "flash_attention_bf16")
        launches_bf16 += 1
        lse_written += want_lse
    else:
        err = lib.flash_attention(*args, b, h, h_kv, t, s, d, int(causal),
                                  out.data_ptr(), _build.stream_of(q))
        _build.check(err, "flash_attention")
        launches += 1
    return out, lse


def _launch_bwd(q, k, v, o, do, causal: bool, lse
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels of q's dtype on the card -> (dq, dk, dv)."""
    b, h, t, d = q.shape
    _, h_kv, s, _ = k.shape
    from repro_torch.kernels import _build
    global launches_bwd
    lib = _build.library()
    p = _build.ptr
    args = [p(x, q.dtype, name) for x, name in
            ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (do, "do"))]
    # Four float32 elements a load (16 bytes); TMA's 16-byte aligned bases.
    if any(a % 16 for a in args):
        raise ValueError("flash_attention_bwd needs 16-byte aligned q, k, "
                         "v, o, do")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if q.dtype == torch.bfloat16:
        delta = torch.empty((b, h, stat_rows(t)), dtype=torch.float32,
                            device=q.device)
        err = lib.flash_attention_bwd_bf16(
            *args, p(lse, torch.float32, "lse"), b, h, h_kv, t, s, d,
            int(causal), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            delta.data_ptr(), q.device.index, _build.stream_of(q))
        _build.check(err, "flash_attention_bwd_bf16")
        # Delta, dK dV and dQ where T and S > 0 (else memsets).
        if b * h and t and s:
            launches_bwd += 3
        return dq, dk, dv
    stats = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(stats)
    err = lib.flash_attention_bwd(*args, b, h, h_kv, t, s, d, int(causal),
                                  dq.data_ptr(), dk.data_ptr(),
                                  dv.data_ptr(), stats.data_ptr(),
                                  delta.data_ptr(), _build.stream_of(q))
    _build.check(err, "flash_attention_bwd")
    # The row statistics and dQ launch where T > 0, dK and dV where S > 0.
    if b * h:
        launches_bwd += 2 * (t > 0) + (s > 0)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The launches as custom ops.  On the card each op's implementation is the
# launch above; under FakeTensorMode (the dry run, launch/dryrun.py) its
# fake gives the shapes and dtypes the kernel writes, launching and
# counting nothing.  Each op carries the FLOP formula of the products its
# kernel computes (torch.utils.flop_counter).
# ---------------------------------------------------------------------------

_Tensor = torch.Tensor


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=(),
                         device_types="cuda")
def _flash_fwd(q: _Tensor, k: _Tensor, v: _Tensor, causal: bool
               ) -> _Tensor:
    return _launch_fwd(q, k, v, causal, False)[0]


@torch.library.custom_op("repro_torch::flash_fwd_bf16", mutates_args=(),
                         device_types="cuda")
def _flash_fwd_bf16(q: _Tensor, k: _Tensor, v: _Tensor, causal: bool
                    ) -> _Tensor:
    return _launch_fwd(q, k, v, causal, False)[0]


@torch.library.custom_op("repro_torch::flash_fwd_bf16_lse", mutates_args=(),
                         device_types="cuda")
def _flash_fwd_bf16_lse(q: _Tensor, k: _Tensor, v: _Tensor, causal: bool
                        ) -> tuple[_Tensor, _Tensor]:
    return _launch_fwd(q, k, v, causal, True)


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=(),
                         device_types="cuda")
def _flash_bwd(q: _Tensor, k: _Tensor, v: _Tensor, o: _Tensor, do: _Tensor,
               causal: bool) -> tuple[_Tensor, _Tensor, _Tensor]:
    return _launch_bwd(q, k, v, o, do, causal, None)


@torch.library.custom_op("repro_torch::flash_bwd_bf16", mutates_args=(),
                         device_types="cuda")
def _flash_bwd_bf16(q: _Tensor, k: _Tensor, v: _Tensor, o: _Tensor,
                    do: _Tensor, lse: _Tensor, causal: bool
                    ) -> tuple[_Tensor, _Tensor, _Tensor]:
    return _launch_bwd(q, k, v, o, do, causal, lse)


@_flash_fwd.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q)


@_flash_fwd_bf16.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q)


@_flash_fwd_bf16_lse.register_fake
def _(q, k, v, causal):
    b, h, t, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, stat_rows(t)),
                                            dtype=torch.float32)


@_flash_bwd.register_fake
def _(q, k, v, o, do, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@_flash_bwd_bf16.register_fake
def _(q, k, v, o, do, lse, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def visited_pairs(t: int, s: int, causal: bool, tile: int) -> int:
    """The (query, key) pairs in the tiles that a kernel computes: T·S
    without the mask; with it (T = S), query tile i of ``tile`` rows takes
    key tiles 0..i of ``tile`` rows.  Pairs past T or S (a ragged tile's
    padding) are not counted."""
    if not causal:
        return t * s
    return sum(min(tile, t - i * tile) * min(s, (i + 1) * tile)
               for i in range(-(-t // tile)))


def fwd_flops(q_shape, k_shape, causal: bool, dtype) -> int:
    """The forward kernel's products: Q·Kᵀ and P·V, 2·D FLOP a pair each,
    over the pairs of its tiles (TILE[dtype] rows both ways):
    4·B·H·D·visited_pairs(T, S, causal, TILE[dtype])."""
    b, h, t, d = q_shape
    return 4 * b * h * d * visited_pairs(t, k_shape[2], causal, TILE[dtype])


def bwd_flops(q_shape, k_shape, causal: bool, dtype) -> int:
    """The backward kernels' products, 2·D FLOP a pair each.  float32:
    Q·Kᵀ in the statistics pass, Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, dV += Pᵀ·dO and
    dK += dSᵀ·Q in the dK dV pass, S = Q·Kᵀ, dP = dO·Vᵀ and dQ += dS·K in
    the dQ pass, all over 64 x 64 tiles: 16·B·H·D·pairs(64).  bf16 (no
    statistics pass: it reads the forward's): the dK dV pass's four over
    64-row key blocks and 64-row query tiles, the dQ pass's three over 128
    x 128 tiles: 2·B·H·D·(4·pairs(64) + 3·pairs(128)).  Q·Kᵀ is
    recomputed in each pass; Delta's row sums are not products."""
    b, h, t, d = q_shape
    s = k_shape[2]
    p64 = visited_pairs(t, s, causal, 64)
    if dtype == torch.bfloat16:
        return 2 * b * h * d * (4 * p64 + 3 * visited_pairs(t, s, causal,
                                                            128))
    return 16 * b * h * d * p64


def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula
    ops = torch.ops.repro_torch
    for op, dtype in ((ops.flash_fwd, torch.float32),
                      (ops.flash_fwd_bf16, torch.bfloat16),
                      (ops.flash_fwd_bf16_lse, torch.bfloat16)):
        register_flop_formula(op)(
            lambda q, k, v, causal, *_, dtype=dtype, **__:
            fwd_flops(q, k, causal, dtype))
    for op, dtype in ((ops.flash_bwd, torch.float32),
                      (ops.flash_bwd_bf16, torch.bfloat16)):
        register_flop_formula(op)(
            lambda q, k, v, o, do, *rest, dtype=dtype, **__:
            bwd_flops(q, k, rest[-1], dtype))


_register_flops()


def _forward(q, k, v, causal: bool, want_lse: bool = False
             ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(output, the statistic when ``want_lse`` and q is bf16 on the
    card, else None)."""
    bf16 = q.dtype == torch.bfloat16
    if not on_card(q):
        if bf16:
            return attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal).to(torch.bfloat16), None
        return attention_ref(q, k, v, causal=causal), None
    b, h, t, d = q.shape
    if b * h >= 2 ** 31 or -(-t // TILE[q.dtype]) >= 2 ** 16:
        raise ValueError(f"grid too large: B*H={b * h}, T={t}")
    ops = torch.ops.repro_torch
    if not bf16:
        return ops.flash_fwd(q, k, v, causal), None
    if want_lse:
        out, lse = ops.flash_fwd_bf16_lse(q, k, v, causal)
        return out, lse
    return ops.flash_fwd_bf16(q, k, v, causal), None


def attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """bf16 q [B, H, T, D], k/v [B, H_kv, S, D] -> (the output, the rows'
    log-sum-exp in the log2 domain, float32 [B, H, stat_rows(T)]), the
    statistic :func:`attention_bwd` takes for bf16; not differentiable.  On
    the card the bf16 forward kernel writes both (rows past T hold finite
    values of no meaning); on the CPU the plain versions, rows past T 0."""
    _check_shapes(q, k, v, causal)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the statistic is the bf16 kernel's; got "
                         f"{q.dtype}")
    if on_card(q):
        return _forward(q, k, v, causal, want_lse=True)
    b, h, t, _ = q.shape
    lse = torch.zeros((b, h, stat_rows(t)), dtype=torch.float32)
    lse[..., :t] = lse2_ref(q.float(), k.float(), causal=causal)
    return _forward(q, k, v, causal)[0], lse


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, do: torch.Tensor, causal: bool = True,
                  lse: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`attention`: q, o, do [B, H, T, D], k, v
    [B, H_kv, S, D], all float32 or all bfloat16, ``o`` the forward's
    output and ``do`` the gradient reaching it -> (dq, dk, dv) in that
    dtype.  ``lse`` is the forward's statistic (:func:`attention_with_lse`),
    which a bf16 call on the card needs and the other paths ignore."""
    _check_shapes(q, k, v, causal)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or \
            do.dtype != q.dtype:
        raise ValueError(f"attention_bwd takes o and do like q "
                         f"{q.dtype}{tuple(q.shape)}; got "
                         f"{o.dtype}{tuple(o.shape)}, "
                         f"{do.dtype}{tuple(do.shape)}")
    bf16 = q.dtype == torch.bfloat16
    if not on_card(q):
        if bf16:
            return tuple(g.to(torch.bfloat16) for g in attention_bwd_ref(
                *(x.float() for x in (q, k, v, o, do)), causal=causal))
        return attention_bwd_ref(q, k, v, o, do, causal=causal)
    b, h, t, d = q.shape
    _, h_kv, s, _ = k.shape
    tile = BWD_TILE[q.dtype]
    if b * h >= 2 ** 31 or max(-(-t // tile), -(-s // tile)) >= 2 ** 16:
        raise ValueError(f"grid too large: B*H={b * h}, T={t}, S={s}")
    ops = torch.ops.repro_torch
    if not bf16:
        return tuple(ops.flash_bwd(q, k, v, o, do, causal))
    if lse is None or lse.shape != (b, h, stat_rows(t)) or \
            lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(
            f"a bf16 attention_bwd on the card takes the forward's "
            f"log-sum-exp, float32 {(b, h, stat_rows(t))} on {q.device} "
            f"(attention_with_lse); got "
            f"{None if lse is None else (lse.dtype, tuple(lse.shape))}")
    return tuple(ops.flash_bwd_bf16(q, k, v, o, do, lse, causal))


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, want_lse):
        out, lse = _forward(q, k, v, causal, want_lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, do.contiguous(),
                                   causal=ctx.causal, lse=lse)
        return dq, dk, dv, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """q [B, H, T, D]; k/v [B, H_kv, S, D], all float32 or all bfloat16
    -> [B, H, T, D] in that dtype; differentiable in q, k and v."""
    _check_shapes(q, k, v, causal)
    # The bf16 backward on the card reads the forward's statistic; only a
    # forward whose output can reach a backward writes it.
    want_lse = (on_card(q) and q.dtype == torch.bfloat16 and
                torch.is_grad_enabled() and
                any(x.requires_grad for x in (q, k, v)))
    return _Attention.apply(q, k, v, causal, want_lse)
