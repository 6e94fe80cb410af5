"""K4, the flash-attention core of the encoder's self-attention, and its
plain PyTorch version.

``flash_attention(q, k, v)`` computes ``softmax(q k^T) v`` per (batch, head)
for bf16 q, k, v of shape (B, heads, T, d) -- q already scaled by 1/sqrt(d),
no mask, keys and queries of one length -- and returns bf16, with autograd.
The kernels are built for d = 64, 128 and 256; any other d up to 256 runs
zero-padded to the next of them (``pad_head``, exact), as the library
kernel takes any d; above 256 the wrappers raise.
It replaces the library Pallas TPU kernels that
``pika_tpu/models/transformer.py:MultiHeadedAttention._flash`` reaches
(``jax/experimental/pallas/ops/tpu/flash_attention.py``, jax 0.9.0): the
forward ``_flash_attention_impl`` (``pallas_call`` :758), and the backward
``_flash_attention_bwd_dkv`` (:1121) and ``_flash_attention_bwd_dq``
(:1456).  Numerics as those kernels: s = q k^T and every product accumulate
in float32 from bf16 operands, p = exp(s - m) is rounded to bf16 before p v,
the output to bf16; the backward rounds p and ds = p (do v^T - di) to bf16
before dv = p^T do, dk = ds^T q and dq = ds k, and returns bf16 gradients.

Bound on the H100: the products on the bf16 tensor cores (989 TFLOP/s),
4*B*h*T^2*d flops forward (0.26 TFLOP at the flagship training shape,
B=32, heads 16/16/8, T=992/974/239, summed over the three layers), 8 and 6
times B*h*T^2*d for the dk/dv and dq kernels (0.52 and 0.39 TFLOP); their
bytes are far fewer.
Design (``csrc/flash_attention.cu`` has the details): every block owns a
tile of queries (forward, dq) or keys (dk/dv) and loops over the other axis
itself; keys and queries at or past T are masked in the kernel where the
JAX wrapper pads T with segment ids; nothing crosses blocks, so there are
no atomics and the results are identical from run to run.  All three are
Hopper kernels: a TMA producer warp streams key or query tiles through a
4-stage shared-memory ring while two consumer warpgroups run wgmma, with p
and ds as the register operand of the value and gradient products; the
forward keeps the online softmax in registers and its blocks are
persistent, one per SM, so one work item's loads overlap the last one's
tail.  At d = 256 the three are simpler ``mma.sync`` kernels instead
(64-row blocks of 4 warps over 32-row streamed tiles, the dk/dv kernel's
columns split over two blocks; a 64 x 256 accumulator per warpgroup does
not fit the registers).  di = sum(o * do) is taken with
torch, once per backward (``flash_attention_di``), and handed to both
backward kernels.

The plain versions materialize the (B, h, T, T) scores; they round p to
bf16 relative to the row's max, the kernel relative to the running max of
the key tiles seen so far (as the TPU kernel does over its key blocks), so
the two agree to bf16 rounding, not bit for bit.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pika_tpu_torch.ops import cuda_build

HEAD_DIMS = (64, 128, 256)  # the head widths the kernels are built for


def _bf16_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def flash_attention_reference(q, k, v):
    """The plain version of K4's forward: ``(o, lse)``, o bf16 (B, h, T, d)
    and lse = logsumexp of the scores, float32 (B, h, T)."""
    s = q.float() @ k.float().transpose(-1, -2)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (_bf16_f32(p) @ v.float()) / l
    return o.to(torch.bfloat16), (m + torch.log(l))[..., 0]


def flash_attention_bwd_reference(q, k, v, o, lse, do):
    """The plain version of K4's backward: ``(dq, dk, dv)``, bf16, from the
    forward's output ``o`` and ``lse`` and the output cotangent ``do``."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    p = torch.exp(qf @ kf.transpose(-1, -2) - lse[..., None])
    dv = _bf16_f32(p).transpose(-1, -2) @ dof
    di = (o.float() * dof).sum(dim=-1, keepdim=True)
    ds = _bf16_f32(p * (dof @ vf.transpose(-1, -2) - di))
    dk = ds.transpose(-1, -2) @ qf
    dq = ds @ kf
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def _check_cuda(what, **tensors):
    """Raise unless every tensor is a contiguous bf16 (B, h, T, d) CUDA
    tensor of the first one's shape and device, d in HEAD_DIMS; returns
    (B*h, T, d).  Runs on every launch, so each attribute is read once."""
    first = next(iter(tensors.values()))
    device, shape = first.device, first.shape
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")
    if len(shape) != 4 or shape[3] not in HEAD_DIMS or shape[2] == 0:
        raise ValueError(f"{what}: q must be (B, heads, T > 0, d) with d in {HEAD_DIMS} "
                         f"(flash_attention zero-pads any d up to {HEAD_DIMS[-1]}; K4 has no "
                         f"kernel for d_head > {HEAD_DIMS[-1]}), got {tuple(shape)}")
    for name, x in tensors.items():
        if x.dtype != torch.bfloat16 or x.shape != shape or x.device != device:
            raise ValueError(f"{what}: {name} must be bfloat16 {tuple(shape)} on "
                             f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")
    b, h, t, d = shape
    return b * h, t, d


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_attention_fwd(q, k, v):
    """K4 forward: ``(o, lse)`` as ``flash_attention_reference``."""
    device = q.device
    if device.type == "cpu":
        return flash_attention_reference(q, k, v)
    bh, t, d = _check_cuda("flash_attention_fwd", q=q, k=k, v=v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=device)
    rc = cuda_build.library().pika_flash_attention_fwd(
        device.index, _stream(device), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, t, d)
    cuda_build.check(rc, f"flash_attention_fwd launch (BH={bh}, T={t}, d={d})")
    flash_attention_fwd.launches += 1
    return o, lse


def _check_bwd(what, q, k, v, o, lse, do, di):
    bh, t, d = _check_cuda(what, q=q, k=k, v=v, o=o, do=do)
    for name, x in (("lse", lse), ("di", di)):
        if x is None:
            continue
        if x.dtype != torch.float32 or x.shape != q.shape[:3] or x.device != q.device \
                or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous float32 "
                             f"{tuple(q.shape[:3])} on {q.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    return bh, t, d


def flash_attention_di(o, do):
    """di = sum(o * do) over the head dimension, float32 (B, h, T): the
    softmax backward's row term, shared by both backward kernels."""
    return (o.float() * do).sum(dim=-1)  # do joins the float32 product exactly, uncopied


def flash_attention_bwd_dkv(q, k, v, o, lse, do, di=None):
    """K4 backward, the dk/dv kernel: ``(dk, dv)``.  ``di`` is
    ``flash_attention_di(o, do)``, computed here when not given."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do)[1:]
    bh, t, d = _check_bwd("flash_attention_bwd_dkv", q, k, v, o, lse, do, di)
    if di is None:
        di = flash_attention_di(o, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = cuda_build.library().pika_flash_attention_bwd_dkv(
        q.device.index, _stream(q.device),
        *(x.data_ptr() for x in (q, k, v, do, lse, di, dk, dv)), bh, t, d)
    cuda_build.check(rc, f"flash_attention_bwd_dkv launch (BH={bh}, T={t}, d={d})")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, o, lse, do, di=None):
    """K4 backward, the dq kernel: ``dq``.  ``di`` as for the dk/dv kernel."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do)[0]
    bh, t, d = _check_bwd("flash_attention_bwd_dq", q, k, v, o, lse, do, di)
    if di is None:
        di = flash_attention_di(o, do)
    dq = torch.empty_like(q)
    rc = cuda_build.library().pika_flash_attention_bwd_dq(
        q.device.index, _stream(q.device), *(x.data_ptr() for x in (q, k, v, do, lse, di, dq)),
        bh, t, d)
    cuda_build.check(rc, f"flash_attention_bwd_dq launch (BH={bh}, T={t}, d={d})")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd(q, k, v, o, lse, do):
    """K4 backward: ``(dq, dk, dv)`` bf16.  On CUDA: di once, then the dk/dv
    kernel and the dq kernel."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do)
    di = flash_attention_di(o, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, o, lse, do, di=di)
    return flash_attention_bwd_dq(q, k, v, o, lse, do, di=di), dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0


class FlashAttention(torch.autograd.Function):
    """``softmax(q k^T) v`` with K4 forward and backward on CUDA tensors (the
    plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return flash_attention_bwd(*ctx.saved_tensors, do.contiguous())


def pad_head(attention, q, k, v):
    """``attention`` of q, k, v zero-padded along d to the next width of
    ``HEAD_DIMS``, its output sliced back to d.  Exact: q is scaled by the
    true d already, zero columns of q and k add nothing to the scores, zero
    columns of v give zero columns of the output, and autograd's backward of
    the pad drops the padded columns of the gradients."""
    d = q.shape[-1]
    width = next(w for w in HEAD_DIMS if w >= d)
    o = attention(*(F.pad(x, (0, width - d)) for x in (q, k, v)))
    return o[..., :d]


def flash_attention(q, k, v):
    """bf16 ``softmax(q k^T) v`` over (B, heads, T, d) q, k, v (q scaled by
    1/sqrt(d) already), differentiable.  CUDA inputs must be contiguous with
    d <= ``HEAD_DIMS[-1]`` (256); a d between the kernels' widths runs
    zero-padded (``pad_head``).  CPU inputs take the plain versions at any
    d."""
    d = q.shape[-1]
    if q.device.type == "cuda" and d not in HEAD_DIMS and 0 < d < HEAD_DIMS[-1]:
        return pad_head(FlashAttention.apply, q, k, v)
    return FlashAttention.apply(q, k, v)
