"""K1, K2 and K3, the fused RNN-T joint-channel kernels, and their plain
PyTorch versions.

``joint_channels`` (K1) computes, for every lattice cell (b, t, u), the three
channels the transducer DP needs -- logsumexp over the vocabulary, the blank
logit and the target-label logit -- without writing the (B, T, U+1, V) logit
lattice.  ``joint_channels_bwd`` (K2 and K3) takes the cotangents of those
channels back to the joint's inputs, recomputing the logits tile by tile.

K1 replaces ``pika_tpu/ops/rnnt_pallas.py:joint_channels_pallas`` (the Pallas
TPU kernel ``_fwd_kernel``).
Bound on the H100: the (B*T*U1, H) x (H, V) product, about 2*B*T*U1*H*V
flops (1.0 TFLOP at the flagship eval shape B=8, T=239, U1=41, H=1024,
V=6268), run in float32 on the SIMT units.
Design: one CUDA block owns up to 48 lattice cells (as many as shared memory
holds at this H), builds their joint hidden rows once into shared memory and
streams W2 through a double-buffered shared tile, keeping an online
max/sum-exp per row, so only 3 floats per cell reach device memory
(``csrc/joint_channels_fwd.cu`` has the details).

K2 and K3 replace ``joint_channels_pallas_bwd`` (the Pallas TPU kernels
``_bwd_in_kernel`` and ``_bwd_w_kernel``).  Each recomputes z = h W2 + b2
and dz = d_lse softmax(z) + [v=0] d_zb + [v=label] d_zy, then K2 takes
dh = dz W2^T to d_ax, d_gx, d_ay, d_gy and K3 takes dW2 = h^T dz and
db2 = sum dz.  Each does two products of 2*B*T*U1*H*V flops (about 2 TFLOP
per kernel at B=8, 8 TFLOP at B=32).
K2 (``csrc/joint_channels_bwd.cu``) runs them in float32 on the SIMT units:
its block owns a (t-tile x u-tile) of lattice cells and walks V itself, and
writes per-tile partials of the sums over u (d_ax, d_gx) and over t (d_ay,
d_gy) that torch adds up, where the TPU kernel carries dh across V tiles
in VMEM.
K3 (``csrc/joint_channels_bwd_w.cu``) computes what the TPU kernel computes
at its default ``mm_dtype=bf16``: bf16 h and W2 into z with float32 sums,
dW2 from bf16 dz, db2 from float32 dz, on the bf16 tensor cores (Hopper TMA
+ wgmma; bound 8.1 ms at B=32).  The TPU kernel keeps a whole dW2 column
tile resident across the lattice; a Hopper SM cannot hold one, so K3
materializes bf16 dz in chunks of ``k3_chunk_rows`` lattice rows (about
512 MB of scratch) and runs per chunk an h kernel, a dz kernel (z = h W2
with dz as its epilogue, plus per-block db2 partials) and a dW2 kernel
(dW2 += h^T dz), in stream order: deterministic, no atomics.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from pika_tpu_torch.ops import cuda_build
from pika_tpu_torch.ops.flash_attention import _bf16_f32

# K3's scratch: the bf16 dz of one chunk of lattice rows stays within this
DZ_SCRATCH_BYTES = 512 * 2**20
K3_TILE = 128  # K3's output tile; a chunk is a whole number of its rows


def pad64(n: int) -> int:
    """``n`` rounded up to a multiple of 64: the widths of K3's bf16 copies,
    so that every row is whole TMA boxes of 64 columns (and its stride a
    multiple of 16 bytes, as TMA needs)."""
    return -(-n // 64) * 64


def k3_chunk_rows(v: int) -> int:
    """Lattice rows per K3 chunk at vocabulary ``v``: the most whole K3 tiles
    whose bf16 dz (rows, pad64(v)) fits DZ_SCRATCH_BYTES (42,752 at V=6268:
    8 chunks at B=32, T=239, U1=41)."""
    return max(K3_TILE, DZ_SCRATCH_BYTES // (2 * pad64(v)) // K3_TILE * K3_TILE)


def chunk_channels(ax_c, gx_c, ay, gy, w2, b2, labels_ext):
    """Channels for a chunk of T: ``(lse, z_blank, z_label)``, each (B, Tc, U+1).

    Materializes the (B, Tc, U+1, V) logits of the chunk
    (``pika_tpu/ops/rnnt_loss.py:_chunk_channels``).
    """
    h = torch.tanh(ax_c[:, :, None, :] + ay[:, None, :, :]) * torch.sigmoid(
        gx_c[:, :, None, :] + gy[:, None, :, :])
    z = h @ w2 + b2
    lse = torch.logsumexp(z, dim=-1)
    idx = labels_ext.long()[:, None, :, None].expand(*z.shape[:3], 1)
    return lse, z[..., 0], torch.gather(z, -1, idx)[..., 0]


def joint_channels_reference(ax, gx, ay, gy, w2, b2, labels_ext, chunk: int = 32):
    """The plain version of K1: ``chunk_channels`` over T chunks of ``chunk``
    frames (``pika_tpu/ops/rnnt_loss.py:_all_channels``)."""
    parts = [chunk_channels(a, g, ay, gy, w2, b2, labels_ext)
             for a, g in zip(torch.split(ax, chunk, dim=1), torch.split(gx, chunk, dim=1))]
    return tuple(torch.cat(p, dim=1) for p in zip(*parts))


def _check_cuda_inputs(what, ax, gx, ay, gy, w2, b2, labels_ext, **channels):
    """Raise unless every input is a contiguous tensor of the kernel's dtype
    and shape on ax's CUDA device; returns (B, T, U1, H, V).  ``channels``
    are (B, T, U1) float32 tensors."""
    if ax.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {ax.device}")
    b, t, h = ax.shape
    u1 = ay.shape[1]
    v = w2.shape[1]
    expect = {"ax": (ax, (b, t, h)), "gx": (gx, (b, t, h)), "ay": (ay, (b, u1, h)),
              "gy": (gy, (b, u1, h)), "w2": (w2, (h, v)), "b2": (b2, (v,)),
              "labels_ext": (labels_ext, (b, u1))}
    expect.update({name: (x, (b, t, u1)) for name, x in channels.items()})
    for name, (x, shape) in expect.items():
        dtype = torch.int32 if name == "labels_ext" else torch.float32
        if x.device != ax.device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{what}: {name} must be {dtype} {shape} on {ax.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return b, t, u1, h, v


def joint_channels(ax, gx, ay, gy, w2, b2, labels_ext):
    """``(lse, z_blank, z_label)``, each (B, T, U+1) float32.

    ax, gx: (B, T, H) f32; ay, gy: (B, U+1, H) f32; w2: (H, V) f32;
    b2: (V,) f32; labels_ext: (B, U+1) int32 in [0, V).  CUDA inputs must be
    contiguous and on one device.
    """
    if ax.device.type == "cpu":
        return joint_channels_reference(ax, gx, ay, gy, w2, b2, labels_ext)
    b, t, u1, h, v = _check_cuda_inputs("joint_channels", ax, gx, ay, gy, w2, b2, labels_ext)
    lse, zb, zy = (torch.empty((b, t, u1), dtype=torch.float32, device=ax.device)
                   for _ in range(3))
    if lse.numel() == 0:
        return lse, zb, zy
    lib = cuda_build.library()
    stream = torch.cuda.current_stream(ax.device).cuda_stream
    rc = lib.pika_joint_channels_fwd(
        ax.device.index, stream,
        *(x.data_ptr() for x in (ax, gx, ay, gy, w2, b2, labels_ext, lse, zb, zy)),
        b, t, u1, h, v)
    cuda_build.check(rc, f"joint_channels launch (B={b}, T={t}, U1={u1}, H={h}, V={v})")
    joint_channels.launches += 1
    return lse, zb, zy


joint_channels.launches = 0


def joint_channels_bwd_reference(ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy,
                                 chunk: int = 32, mm_dtype=torch.float32):
    """The plain version of K2 and K3: recompute-and-vjp of ``chunk_channels``
    over T chunks of ``chunk`` frames (``pika_tpu/ops/rnnt_loss.py:_fused_bwd``,
    its XLA branch).  ``lse`` is not needed there: autograd recomputes it.
    ``mm_dtype=torch.bfloat16`` takes d_w2 and d_b2 from
    ``joint_channels_bwd_w_reference`` at bf16, as the card computes them
    (K2 stays float32)."""
    if mm_dtype != torch.float32:
        return (joint_channels_bwd_reference(ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse,
                                             d_zb, d_zy, chunk)[:4]
                + joint_channels_bwd_w_reference(ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse,
                                                 d_zb, d_zy, chunk, mm_dtype))
    with torch.enable_grad():
        ay_, gy_, w2_, b2_ = (x.detach().requires_grad_() for x in (ay, gy, w2, b2))
        d_axs, d_gxs = [ax[:, :0]], [gx[:, :0]]
        d_ay, d_gy, d_w2, d_b2 = (torch.zeros_like(x) for x in (ay, gy, w2, b2))
        for t0 in range(0, ax.shape[1], chunk):
            sl = slice(t0, t0 + chunk)
            ax_c, gx_c = (x[:, sl].detach().requires_grad_() for x in (ax, gx))
            outs = chunk_channels(ax_c, gx_c, ay_, gy_, w2_, b2_, labels_ext)
            grads = torch.autograd.grad(outs, (ax_c, gx_c, ay_, gy_, w2_, b2_),
                                        (d_lse[:, sl], d_zb[:, sl], d_zy[:, sl]))
            d_axs.append(grads[0])
            d_gxs.append(grads[1])
            for acc, g in zip((d_ay, d_gy, d_w2, d_b2), grads[2:]):
                acc += g
    return torch.cat(d_axs, dim=1), torch.cat(d_gxs, dim=1), d_ay, d_gy, d_w2, d_b2


def joint_channels_bwd_w_reference(ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy,
                                   chunk: int = 32, mm_dtype=torch.float32):
    """The plain version of K3: ``(d_w2, d_b2)``.  ``mm_dtype=torch.float32``
    is ``joint_channels_bwd_reference``'s float32 vjp.  ``torch.bfloat16``
    rounds where ``pika_tpu/ops/rnnt_pallas.py:_bwd_w_kernel`` does at its
    default mm_dtype -- h and W2 before z = h W2 + b2, dz before dW2 = h^T dz,
    db2 from the unrounded dz -- and multiplies the rounded values in
    float32, with the given ``lse``, over T chunks of ``chunk`` frames."""
    if mm_dtype == torch.float32:
        return joint_channels_bwd_reference(ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse,
                                            d_zb, d_zy, chunk)[4:]
    if mm_dtype != torch.bfloat16:
        raise ValueError(f"mm_dtype must be torch.float32 or torch.bfloat16, got {mm_dtype}")
    w = _bf16_f32(w2)
    cols = torch.arange(w2.shape[1], device=w2.device)
    labels = labels_ext.long()[:, None, :, None]
    d_w2, d_b2 = torch.zeros_like(w2), torch.zeros_like(b2)
    for t0 in range(0, ax.shape[1], chunk):
        sl = slice(t0, t0 + chunk)
        h = _bf16_f32(torch.tanh(ax[:, sl, None, :] + ay[:, None, :, :])
                      * torch.sigmoid(gx[:, sl, None, :] + gy[:, None, :, :]))
        z = h @ w + b2
        dz = d_lse[:, sl, :, None] * torch.exp(torch.clamp(z - lse[:, sl, :, None], max=40.0))
        dz = dz + torch.where(cols == 0, d_zb[:, sl, :, None], 0.0)
        dz = dz + torch.where(cols == labels, d_zy[:, sl, :, None], 0.0)
        d_w2 += h.reshape(-1, h.shape[-1]).t() @ _bf16_f32(dz).reshape(-1, dz.shape[-1])
        d_b2 += dz.sum(dim=(0, 1, 2))
    return d_w2, d_b2


def joint_channels_bwd_in(ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy):
    """K2: ``(d_ax, d_gx, d_ay, d_gy)``, inputs as ``joint_channels_bwd``.
    Its per-tile partials are summed with torch."""
    args = (ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy)
    if ax.device.type == "cpu":
        return joint_channels_bwd_reference(*args)[:4]
    b, t, u1, h, _ = _check_cuda_inputs("joint_channels_bwd_in", *args[:7], lse=lse,
                                        d_lse=d_lse, d_zb=d_zb, d_zy=d_zy)
    if b * t * u1 == 0:
        return tuple(torch.zeros_like(x) for x in (ax, gx, ay, gy))
    dev = ax.device
    lib = cuda_build.library()
    tile_t, tile_u = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.pika_joint_channels_bwd_in_tile(dev.index, t, u1, h, ctypes.byref(tile_t),
                                              ctypes.byref(tile_u))
    cuda_build.check(rc, f"joint_channels_bwd_in tile (T={t}, U1={u1}, H={h})")
    nt, nu = -(-t // tile_t.value), -(-u1 // tile_u.value)
    w2_t = w2.t().contiguous()
    dax_p, dgx_p = (torch.empty((b, t, nu, h), dtype=torch.float32, device=dev) for _ in range(2))
    day_p, dgy_p = (torch.empty((b, nt, u1, h), dtype=torch.float32, device=dev) for _ in range(2))
    rc = lib.pika_joint_channels_bwd_in(
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
        *(x.data_ptr() for x in (ax, gx, ay, gy, w2, w2_t, b2, labels_ext, lse, d_lse, d_zb, d_zy,
                                 dax_p, dgx_p, day_p, dgy_p)),
        b, t, u1, h, w2.shape[1], tile_t.value, tile_u.value)
    cuda_build.check(rc, f"joint_channels_bwd_in launch (B={b}, T={t}, U1={u1}, H={h}, "
                         f"V={w2.shape[1]})")
    joint_channels_bwd_in.launches += 1
    return dax_p.sum(2), dgx_p.sum(2), day_p.sum(1), dgy_p.sum(1)


def joint_channels_bwd_w(ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy):
    """K3: ``(d_w2, d_b2)``, inputs as ``joint_channels_bwd``.  On the card
    the bf16 function of ``joint_channels_bwd_w_reference(mm_dtype=
    torch.bfloat16)``, as the JAX package's pallas backend runs it; on CPU
    tensors the float32 plain version, as its XLA backend does off the TPU."""
    args = (ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy)
    if ax.device.type == "cpu":
        return joint_channels_bwd_reference(*args)[4:]
    return _bwd_w_cuda(*args, chunk_rows=k3_chunk_rows(w2.shape[1]))


def _bwd_w_cuda(ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy, chunk_rows: int):
    """K3's launcher: the kernels over chunks of ``chunk_rows`` lattice rows
    (a positive multiple of K3_TILE).  Builds the padded bf16 W2^T, the
    padded b2 and the scratch; the per-tile db2 partials are summed with
    torch."""
    args = (ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy)
    b, t, u1, h, v = _check_cuda_inputs("joint_channels_bwd_w", *args[:7], lse=lse,
                                        d_lse=d_lse, d_zb=d_zb, d_zy=d_zy)
    if chunk_rows <= 0 or chunk_rows % K3_TILE:
        raise ValueError(f"joint_channels_bwd_w: chunk_rows must be a positive multiple of "
                         f"{K3_TILE}, got {chunk_rows}")
    rows = b * t * u1
    if rows == 0:
        return torch.zeros_like(w2), torch.zeros_like(b2)
    dev = ax.device
    hp, vp = pad64(h), pad64(v)
    w2_t = torch.zeros((vp, hp), dtype=torch.bfloat16, device=dev)
    w2_t[:v, :h] = w2.t()
    b2_p = torch.zeros(vp, dtype=torch.float32, device=dev)
    b2_p[:v] = b2
    chunk = min(chunk_rows, rows)
    h_buf = torch.empty((chunk, hp), dtype=torch.bfloat16, device=dev)
    dz_buf = torch.empty((chunk, vp), dtype=torch.bfloat16, device=dev)
    dw2 = torch.empty((hp, vp), dtype=torch.float32, device=dev)
    db2_p = torch.empty((-(-rows // K3_TILE), vp), dtype=torch.float32, device=dev)
    rc = cuda_build.library().pika_joint_channels_bwd_w(
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
        *(x.data_ptr() for x in (ax, gx, ay, gy, w2_t, b2_p, labels_ext, lse, d_lse, d_zb, d_zy,
                                 h_buf, dz_buf, dw2, db2_p)),
        b, t, u1, h, v, chunk_rows)
    cuda_build.check(rc, f"joint_channels_bwd_w launch (B={b}, T={t}, U1={u1}, H={h}, V={v})")
    joint_channels_bwd_w.launches += 1
    return dw2[:h, :v].contiguous(), db2_p.sum(0)[:v].contiguous()


def joint_channels_bwd(ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy):
    """``(d_ax, d_gx, d_ay, d_gy, d_w2, d_b2)``, float32, shaped like
    ``(ax, gx, ay, gy, w2, b2)``, given the cotangents of K1's channels.

    ``lse`` is K1's logsumexp; ``d_lse``, ``d_zb``, ``d_zy`` are (B, T, U+1)
    float32.  Other inputs as ``joint_channels``.  On CUDA: K2
    (``joint_channels_bwd_in``) then K3 (``joint_channels_bwd_w``).
    """
    args = (ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy)
    if ax.device.type == "cpu":
        return joint_channels_bwd_reference(*args)
    return joint_channels_bwd_in(*args) + joint_channels_bwd_w(*args)


joint_channels_bwd_in.launches = 0  # K2
joint_channels_bwd_w.launches = 0   # K3
