"""K1, the fused RNN-T joint-channel forward, and its plain PyTorch version.

``joint_channels`` computes, for every lattice cell (b, t, u), the three
channels the transducer DP needs -- logsumexp over the vocabulary, the blank
logit and the target-label logit -- without writing the (B, T, U+1, V) logit
lattice.

Replaces: ``pika_tpu/ops/rnnt_pallas.py:joint_channels_pallas`` (the Pallas
TPU kernel ``_fwd_kernel``).
Bound on the H100: the (B*T*U1, H) x (H, V) product, about 2*B*T*U1*H*V
flops (1.0 TFLOP at the flagship eval shape B=8, T=239, U1=41, H=1024,
V=6268), run in float32 on the SIMT units.
Design: one CUDA block owns up to 48 lattice cells (as many as shared memory
holds at this H), builds their joint hidden rows once into shared memory and
streams W2 through a double-buffered shared tile, keeping an online
max/sum-exp per row, so only 3 floats per cell reach device memory
(``csrc/joint_channels_fwd.cu`` has the details).

On CPU tensors ``joint_channels`` runs ``joint_channels_reference``; on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from pika_tpu_torch.ops import cuda_build


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


def joint_channels(ax, gx, ay, gy, w2, b2, labels_ext):
    """``(lse, z_blank, z_label)``, each (B, T, U+1) float32.

    ax, gx: (B, T, H) f32; ay, gy: (B, U+1, H) f32; w2: (H, V) f32;
    b2: (V,) f32; labels_ext: (B, U+1) int32 in [0, V).  CUDA inputs must be
    contiguous and on one device.
    """
    if ax.device.type == "cpu":
        return joint_channels_reference(ax, gx, ay, gy, w2, b2, labels_ext)
    if ax.device.type != "cuda":
        raise ValueError(f"joint_channels: unsupported device {ax.device}")
    b, t, h = ax.shape
    u1 = ay.shape[1]
    v = w2.shape[1]
    expect = {"ax": (ax, (b, t, h)), "gx": (gx, (b, t, h)), "ay": (ay, (b, u1, h)),
              "gy": (gy, (b, u1, h)), "w2": (w2, (h, v)), "b2": (b2, (v,)),
              "labels_ext": (labels_ext, (b, u1))}
    for name, (x, shape) in expect.items():
        dtype = torch.int32 if name == "labels_ext" else torch.float32
        if x.device != ax.device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"joint_channels: {name} must be {dtype} {shape} on {ax.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"joint_channels: {name} must be contiguous")
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
