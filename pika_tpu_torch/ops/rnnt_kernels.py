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
db2 = sum dz.  Bound on the H100: two products of 2*B*T*U1*H*V flops each
per kernel (about 2 TFLOP per kernel at B=8, 8 TFLOP at B=32), float32 SIMT.
The TPU kernels carry dh across V tiles (K2) and dW2 across all lattice tiles
(K3) in VMEM because their grids run in order; CUDA blocks do not, so:
K2's block owns a (t-tile x u-tile) of lattice cells and walks V itself, and
writes per-tile partials of the sums over u (d_ax, d_gx) and over t (d_ay,
d_gy) that torch adds up; K3's block owns a 32-column V tile and one of S
parts of the lattice rows, keeps that dW2 column tile for all H in
registers, and writes an (S, H, V) partial that torch adds up.  K3 reads
h from a float32 h cache (B, T, U+1, H) that the wrapper builds with torch,
as the JAX wrapper does, because each row is read once per V tile and
recomputing tanh and sigmoid there would cost more than the read; K2 builds
its h rows from the factors, once per block (``csrc/joint_channels_bwd.cu``
has the details).

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

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
                                 chunk: int = 32):
    """The plain version of K2 and K3: recompute-and-vjp of ``chunk_channels``
    over T chunks of ``chunk`` frames (``pika_tpu/ops/rnnt_loss.py:_fused_bwd``,
    its XLA branch).  ``lse`` is not needed: autograd recomputes it."""
    del lse
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


def _w_parts(n_sm: int, v_tiles: int) -> int:
    """How many row parts K3 splits the lattice into: the S in 1..8 whose
    v_tiles * S blocks fill their last wave of n_sm best (the smaller S on
    a tie, since each part adds an (H, V) partial)."""
    def fill(s):
        blocks = v_tiles * s
        return blocks / (-(-blocks // n_sm) * n_sm)
    return max(range(1, 9), key=lambda s: (round(fill(s), 3), -s))


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
    """K3: ``(d_w2, d_b2)``, inputs as ``joint_channels_bwd``.  Builds the
    float32 h cache (B, T, U+1, H) with torch; the (S, H, V) partials are
    summed with torch."""
    args = (ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy)
    if ax.device.type == "cpu":
        return joint_channels_bwd_reference(*args)[4:]
    b, t, u1, h, v = _check_cuda_inputs("joint_channels_bwd_w", *args[:7], lse=lse,
                                        d_lse=d_lse, d_zb=d_zb, d_zy=d_zy)
    if b * t * u1 == 0:
        return torch.zeros_like(w2), torch.zeros_like(b2)
    dev = ax.device
    h_cache = ax[:, :, None, :] + ay[:, None, :, :]
    h_cache.tanh_()
    h_cache.mul_(torch.sigmoid(gx[:, :, None, :] + gy[:, None, :, :]))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    parts = _w_parts(n_sm, -(-v // W_TILE_V))
    dw2_p = torch.empty((parts, h, v), dtype=torch.float32, device=dev)
    db2_p = torch.empty((parts, v), dtype=torch.float32, device=dev)
    rc = cuda_build.library().pika_joint_channels_bwd_w(
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
        *(x.data_ptr() for x in (h_cache, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy,
                                 dw2_p, db2_p)),
        b, t, u1, h, v, parts)
    cuda_build.check(rc, f"joint_channels_bwd_w launch (B={b}, T={t}, U1={u1}, H={h}, V={v})")
    joint_channels_bwd_w.launches += 1
    return dw2_p.sum(0), db2_p.sum(0)


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


# K3's V tile: the dW2 columns one block keeps for all H (csrc/joint_channels_bwd.cu)
W_TILE_V = 32
joint_channels_bwd_in.launches = 0  # K2
joint_channels_bwd_w.launches = 0   # K3
