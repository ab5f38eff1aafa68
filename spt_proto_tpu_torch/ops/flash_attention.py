"""Dense causal flash attention with its backward (port of the stock TPU
kernel jax/experimental/pallas/ops/tpu/flash_attention.py, which
spt_proto_tpu/layers/attention.py calls under attn_impl='pallas').

`flash_attention(q, k, v, *, causal, sm_scale)` takes [B, H, S, d] as the
stock kernel does and is differentiable: with an input that requires grad
it runs `_FlashAttention`, a `torch.autograd.Function` that saves q, k, v,
o, l and m (the stock custom_vjp's residuals), computes di = sum(o * do)
in f32 as plain torch (the stock VJP computes it outside its kernels) and
then the dq and dk/dv kernels.

Each wrapper launches its kernel in csrc/flash_attention.cu for CUDA
tensors and runs the plain twin's math for CPU tensors:
  flash_attention_fwd  -> flash_attention_fwd_ref  (o, l, m)
  flash_attention_dq   \\
  flash_attention_dkv  -> flash_attention_bwd_ref  (dq, dk, dv)
The kernels take causal attention over S a multiple of 128 and d 64 or
128, f32 or bf16; anything else raises on CUDA tensors, naming the shape.
In bf16 the kernels read q, k, v and do in place through their strides
(the layer's [B, S, H, d] projections transposed) and write o, dq, dk, dv
in the same layout; o is allocated [B, S, H, d] and returned as its
[B, H, S, d] view, so the layer's transpose back and reshape copy nothing.
The f32 kernels copy strided inputs to contiguous [B, H, S, d].
"""
from __future__ import annotations

import ctypes

import torch

from spt_proto_tpu_torch import _build

# the stock kernel's DEFAULT_MASK_VALUE, added to masked logits
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _logits(q, k, causal: bool, sm_scale: float) -> torch.Tensor:
    """[B, H, Sq, Sk] f32: (q k^T) * sm_scale, the mask value added where
    col > row."""
    s = torch.einsum('bhqd,bhkd->bhqk', q.float(), k.float())
    if sm_scale != 1.0:
        s = s * sm_scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril()
        s = s + torch.where(keep, 0.0, MASK_VALUE)
    return s


def flash_attention_fwd_ref(q, k, v, *, causal: bool, sm_scale: float):
    """Plain twin of the forward: (o in q's dtype, l, m [B, H, S] f32),
    m the row max of the logits, l the row sum of exp(s - m); the
    unnormalised p is rounded to v's dtype before the PV product."""
    s = _logits(q, k, causal, sm_scale)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum('bhqk,bhkd->bhqd', p.to(v.dtype).float(), v.float())
    return (o / l[..., None]).to(q.dtype), l, m


def _bwd_plain(q, k, v, l, m, do, di, causal: bool, sm_scale: float):
    """(dq, dk, dv) from the saved statistics and di = sum(o * do): p =
    exp(s - m) * (1 / l), ds = (do v^T - di) * p * sm_scale; p rounded to
    do's dtype for dv, ds to do's for dk and to k's for dq."""
    s = _logits(q, k, causal, sm_scale)
    p = torch.exp(s - m[..., None]) * (1.0 / l)[..., None]
    dof = do.float()
    dv = torch.einsum('bhqk,bhqd->bhkd', p.to(do.dtype).float(), dof)
    dp = torch.einsum('bhqd,bhkd->bhqk', dof, v.float())
    ds = (dp - di[..., None]) * p
    if sm_scale != 1.0:
        ds = ds * sm_scale
    dk = torch.einsum('bhqk,bhqd->bhkd', ds.to(do.dtype).float(), q.float())
    dq = torch.einsum('bhqk,bhkd->bhqd', ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, o, l, m, do, *, causal: bool,
                            sm_scale: float):
    """Plain twin of the backward: (dq, dk, dv) in q/k/v's dtypes."""
    di = (o.float() * do.float()).sum(-1)
    return _bwd_plain(q, k, v, l, m, do, di, causal, sm_scale)


def _check(q, k, v):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f'q/k/v must share one [B, H, S, d] shape: '
                         f'{tuple(q.shape)} {tuple(k.shape)} '
                         f'{tuple(v.shape)}')


def _check_kernel(q, k, v, causal, *rest):
    """What the CUDA kernels take; raises otherwise."""
    req = _build.require
    b, h, s, d = q.shape
    req(k.dtype == q.dtype and v.dtype == q.dtype, 'q/k/v dtypes differ')
    req(causal, 'the flash kernels compute causal attention only')
    req(s % 128 == 0 and d in (64, 128),
        f'the flash kernels take S a multiple of 128 and d_head 64 or 128 '
        f'(got q {tuple(q.shape)})')
    req(all(t.dtype == torch.float32 and t.shape == (b, h, s)
            for t in rest), 'l, m and di must be [B, H, S] f32')


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, sm_scale: float):
    """The forward: (o [B, H, S, d] in q's dtype, l, m [B, H, S] f32)."""
    _check(q, k, v)
    if not _build.on_cuda(q, k, v):
        return flash_attention_fwd_ref(q, k, v, causal=causal,
                                       sm_scale=sm_scale)
    _check_kernel(q, k, v, causal)
    q, k, v, o = _fwd_operands(q, k, v)
    b, h, s, d = q.shape
    l = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    strides = (ctypes.c_longlong * 12)(*_strides(q, k, v, o))
    p = _build.ptr
    err = _build.lib().spt_flash_fwd(
        _build.dtype_code(q), p(q), p(k), p(v), p(o), p(l), p(m), b, h, s, d,
        float(sm_scale), strides, _build.stream())
    _build.check(err, 'flash_attention')
    flash_attention_fwd.launches += 1
    return o, l, m


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _operand(t: torch.Tensor) -> torch.Tensor:
    """q, k, v or do as the kernels read it: a bf16 [B, H, S, d]
    view in place when its rows are 16-byte aligned runs (d stride 1, the
    other strides multiples of 8 elements, a 16-byte aligned start); a
    contiguous copy otherwise and in f32 (whose kernels take contiguous
    [B, H, S, d])."""
    if (t.dtype == torch.bfloat16 and t.stride(-1) == 1
            and all(st % 8 == 0 for st in t.stride()[:-1]) and _aligned(t)):
        return t
    return t.contiguous()


def _fwd_operands(q, k, v):
    """(q, k, v, o) as the forward kernel takes them: q, k, v as `_operand`
    gives them; o empty, in bf16 the [B, H, S, d] view of a [B, S, H, d]
    tensor (the layer's layout), in f32 contiguous [B, H, S, d]."""
    q, k, v = (_operand(t) for t in (q, k, v))
    if q.dtype != torch.bfloat16:
        return q, k, v, torch.empty_like(q)
    b, h, s, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    return q, k, v, o.transpose(1, 2)


def _stat(t: torch.Tensor) -> torch.Tensor:
    """l, m or di contiguous with a 16-byte aligned start (the dk/dv kernel
    copies m and di 16 bytes at a time)."""
    t = t.contiguous()
    return t if _aligned(t) else t.clone()


def _bwd_operands(q, k, v, l, m, do, di, causal):
    """The checked operands of both backward kernels: q, k, v, do as
    `_operand` gives them, l, m, di as `_stat` does."""
    _check_kernel(q, k, v, causal, l, m, di)
    _build.require(do.shape == q.shape and do.dtype == q.dtype,
                   f'do must match q: {tuple(do.shape)} {do.dtype}')
    return ([_operand(t) for t in (q, k, v, do)]
            + [_stat(t) for t in (l, m, di)])


def _strides(*ts) -> list[int]:
    """(batch, head, row) element strides of each [B, H, S, d] tensor, in
    the order spt_flash_fwd (q, k, v, o) and spt_flash_bwd (q, k, v, do,
    dq, dk, dv) take them."""
    return [st for t in ts for st in t.stride()[:3]]


def _launch_bwd(ops, dq, dk, dv, sm_scale, name):
    """One spt_flash_bwd launch over `_bwd_operands`' ops: dq, or dk and
    dv (the other outputs None)."""
    q, k, v, do, l, m, di = ops
    b, h, s, d = q.shape
    outs = [q if t is None else t for t in (dq, dk, dv)]
    strides = (ctypes.c_longlong * 21)(*_strides(q, k, v, do, *outs))
    p = _build.ptr
    err = _build.lib().spt_flash_bwd(
        _build.dtype_code(q), p(q), p(k), p(v), p(do), p(l), p(m), p(di),
        p(dq), p(dk), p(dv), b, h, s, d, float(sm_scale), strides,
        _build.stream())
    _build.check(err, name)


def _dq(ops, sm_scale) -> torch.Tensor:
    dq = torch.empty_like(ops[0])          # q's layout
    _launch_bwd(ops, dq, None, None, sm_scale, 'flash_attention_dq')
    flash_attention_dq.launches += 1
    return dq


def _dkv(ops, sm_scale):
    dk, dv = torch.empty_like(ops[1]), torch.empty_like(ops[2])
    _launch_bwd(ops, None, dk, dv, sm_scale, 'flash_attention_dkv')
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_dq(q, k, v, l, m, do, di, *, causal: bool = True,
                       sm_scale: float) -> torch.Tensor:
    """dq [B, H, S, d] from the forward's l, m, the output gradient do and
    di = sum(o * do) [B, H, S] f32."""
    _check(q, k, v)
    if not _build.on_cuda(q, k, v, l, m, do, di):
        return _bwd_plain(q, k, v, l, m, do, di, causal, sm_scale)[0]
    return _dq(_bwd_operands(q, k, v, l, m, do, di, causal), sm_scale)


def flash_attention_dkv(q, k, v, l, m, do, di, *, causal: bool = True,
                        sm_scale: float):
    """(dk, dv) [B, H, S, d], from the same inputs as flash_attention_dq."""
    _check(q, k, v)
    if not _build.on_cuda(q, k, v, l, m, do, di):
        return _bwd_plain(q, k, v, l, m, do, di, causal, sm_scale)[1:]
    return _dkv(_bwd_operands(q, k, v, l, m, do, di, causal), sm_scale)


def flash_attention_bwd(q, k, v, o, l, m, do, *, causal: bool = True,
                        sm_scale: float):
    """(dq, dk, dv) from the forward's saved tensors and the output
    gradient: the two kernels for CUDA tensors (operands checked and
    prepared once for both), the plain twin (one pass) for CPU ones."""
    _check(q, k, v)
    if not _build.on_cuda(q, k, v, o, l, m, do):
        return flash_attention_bwd_ref(q, k, v, o, l, m, do, causal=causal,
                                       sm_scale=sm_scale)
    di = (o.float() * do.float()).sum(-1)              # [B, H, S] f32
    ops = _bwd_operands(q, k, v, l, m, do, di, causal)
    return (_dq(ops, sm_scale), *_dkv(ops, sm_scale))


class _FlashAttention(torch.autograd.Function):
    """The forward with l and m, the backward through the dq and dk/dv
    kernels (the stock kernel's custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, l, m = flash_attention_fwd(q, k, v, causal=causal,
                                      sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, l, m)
        ctx.kw = dict(causal=causal, sm_scale=sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, l, m, do, **ctx.kw)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float) -> torch.Tensor:
    """Softmax attention of q/k/v [B, H, S, d] -> o [B, H, S, d] in q's
    dtype; differentiable in q, k and v."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, sm_scale)
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)[0]


flash_attention_fwd.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
