"""K1, K2 and K3, the fused RNN-T joint-channel kernels, and their plain
PyTorch versions.

``joint_channels`` (K1) computes, for every lattice cell (b, t, u), the three
channels the transducer DP needs -- logsumexp over the vocabulary, the blank
logit and the target-label logit -- without writing the (B, T, U+1, V) logit
lattice.  ``joint_channels_bwd`` (K2 and K3) takes the cotangents of those
channels back to the joint's inputs, recomputing the logits.

They replace the Pallas TPU kernels of ``pika_tpu/ops/rnnt_pallas.py``:
K1 ``joint_channels_pallas`` (``_fwd_kernel``), K2 and K3
``joint_channels_pallas_bwd`` (``_bwd_in_kernel``, ``_bwd_w_kernel``).  On
the card they compute what those compute at their default ``mm_dtype=bf16``:
h = tanh(ax + ay) sigmoid(gx + gy) and W2 rounded to bf16, z = h W2 + b2
with float32 sums; K1 takes lse, z_blank, z_label from z; K2 and K3 form
dz = d_lse softmax(z) + [v=0] d_zb + [v=label] d_zy in float32 and round it
to bf16 for dh = dz W2^T (K2, then through the tanh and sigmoid derivatives
to d_ax, d_gx, d_ay, d_gy) and dW2 = h^T dz (K3; db2 from the float32 dz).
One deliberate difference: the TPU kernel keeps dh in a bf16 scratch
rounded after every V tile, the port keeps it float32 across all of V.

Bound on the H100: each lattice-sized product is 2*B*T*U1*H*V flops on the
bf16 tensor cores (4.03 TFLOP, 4.07 ms at the flagship training shape B=32,
T=239, U1=41, H=1024, V=6268): one for K1, three for the backward (z, dW2,
dh).  Design (``csrc/joint_gemm.cuh``, ``csrc/joint_fwd.cu``,
``csrc/joint_bwd.cu``): Hopper TMA + wgmma GEMMs over 128 x 128 tiles, run
over chunks of the lattice (``chunk_bounds``: whole tiles of 16 frames,
about 512 MB of bf16 dz scratch); per chunk an h kernel writes bf16 h, and
K1 splits V across blocks, each writing per-row softmax partials that a
combine kernel reduces to lse; the backward forms z once, writes bf16 dz
(and db2 partials) in the z product's epilogue, then runs the dW2 product
and the dh product, whose epilogue applies the derivatives over a tile of
16 frames x 8 labels and writes per-tile partials of the sums over u (d_ax,
d_gx) and over t (d_ay, d_gy).  Partials are summed with torch: no
atomics, reruns are bit-identical.

On CPU tensors the wrappers run the float32 plain versions (as the JAX
package's XLA backend does off the TPU); on CUDA tensors they launch the
kernels or raise.
"""

from __future__ import annotations

import torch

from pika_tpu_torch.ops import cuda_build
from pika_tpu_torch.ops.flash_attention import _bf16_f32

# the bf16 dz of one chunk of lattice rows stays within this
DZ_SCRATCH_BYTES = 512 * 2**20
ROW_TILE = 128  # rows of a z tile: K3's db2 partials are per row tile of a chunk
T_TILE, U_TILE = 16, 8  # K2's dh tile of lattice cells: frames x labels
PART_K2, PART_K3 = 1, 2  # what the backward launcher computes


def pad64(n: int) -> int:
    """``n`` rounded up to a multiple of 64: the widths of the kernels' bf16
    copies, so that every row is whole TMA boxes of 64 columns (and its
    stride a multiple of 16 bytes, as TMA needs)."""
    return -(-n // 64) * 64


def chunk_tiles(u1: int, v: int) -> int:
    """t-tiles (T_TILE frames, all u1 labels each) per chunk at U+1 = ``u1``
    and vocabulary ``v``: the most whose bf16 dz (rows, pad64(v)) fits
    DZ_SCRATCH_BYTES, at least one (65 at U1 = 41, V = 6268: 8 chunks at
    B = 32, T' = 239)."""
    return max(1, DZ_SCRATCH_BYTES // (2 * pad64(v) * T_TILE * u1))


def chunk_bounds(b: int, t: int, u1: int, v: int, tiles: int | None = None
                 ) -> list[tuple[int, int]]:
    """The kernels' chunks of the lattice as ranges [bt0, bt1) of (b, t)
    rows (row b * t + frame): runs of ``tiles`` (default ``chunk_tiles``)
    t-tiles, each T_TILE frames of one utterance (its last one ragged), so a
    chunk starts on a t-tile and may be a part of one utterance.  As
    ``csrc/joint_gemm.cuh:for_each_chunk`` walks them."""
    tiles = tiles or chunk_tiles(u1, v)
    nt = -(-t // T_TILE)
    n = b * nt

    def first_bt(g: int) -> int:
        return g // nt * t + g % nt * T_TILE

    return [(first_bt(g), first_bt(min(g + tiles, n))) for g in range(0, n, tiles)]


def _check_mm_dtype(mm_dtype) -> None:
    if mm_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mm_dtype must be torch.float32 or torch.bfloat16, got {mm_dtype}")


def _hidden(ax_c, gx_c, ay, gy):
    """tanh(ax + ay) and sigmoid(gx + gy) over the chunk's cells, float32."""
    return (torch.tanh(ax_c[:, :, None, :] + ay[:, None, :, :]),
            torch.sigmoid(gx_c[:, :, None, :] + gy[:, None, :, :]))


def chunk_channels(ax_c, gx_c, ay, gy, w2, b2, labels_ext, mm_dtype=torch.float32):
    """Channels for a chunk of T: ``(lse, z_blank, z_label)``, each (B, Tc, U+1).

    Materializes the (B, Tc, U+1, V) logits of the chunk
    (``pika_tpu/ops/rnnt_loss.py:_chunk_channels``).  ``mm_dtype=
    torch.bfloat16`` rounds h and W2 before z = h W2 + b2, as
    ``pika_tpu/ops/rnnt_pallas.py:_fwd_kernel`` does at its default.
    """
    pre, gate = _hidden(ax_c, gx_c, ay, gy)
    h = pre * gate
    if mm_dtype == torch.bfloat16:
        h, w2 = _bf16_f32(h), _bf16_f32(w2)
    z = h @ w2 + b2
    lse = torch.logsumexp(z, dim=-1)
    idx = labels_ext.long()[:, None, :, None].expand(*z.shape[:3], 1)
    return lse, z[..., 0], torch.gather(z, -1, idx)[..., 0]


def joint_channels_reference(ax, gx, ay, gy, w2, b2, labels_ext, chunk: int = 32,
                             mm_dtype=torch.float32):
    """The plain version of K1: ``chunk_channels`` over T chunks of ``chunk``
    frames (``pika_tpu/ops/rnnt_loss.py:_all_channels``); ``mm_dtype`` as
    there (the card's K1 computes the bf16 function)."""
    _check_mm_dtype(mm_dtype)
    parts = [chunk_channels(a, g, ay, gy, w2, b2, labels_ext, mm_dtype)
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


def _check_tiles(what: str, tiles: int | None) -> None:
    if tiles is not None and tiles <= 0:
        raise ValueError(f"{what}: tiles must be a positive number of t-tiles, got {tiles}")


def _padded_weights(w2, b2, w2_rows: bool):
    """The kernels' bf16 copies of W2, zero-padded to (Vp, Hp) as W2^T and,
    when ``w2_rows``, to (Hp, Vp) as W2 (K2's dh product); b2 padded with 0."""
    h, v = w2.shape
    hp, vp = pad64(h), pad64(v)
    w2_t = torch.zeros((vp, hp), dtype=torch.bfloat16, device=w2.device)
    w2_t[:v, :h] = w2.t()
    w2_p = None
    if w2_rows:
        w2_p = torch.zeros((hp, vp), dtype=torch.bfloat16, device=w2.device)
        w2_p[:h, :v] = w2
    b2_p = torch.zeros(vp, dtype=torch.float32, device=w2.device)
    b2_p[:v] = b2
    return w2_t, w2_p, b2_p


def _ptrs(*tensors):
    return [None if x is None else x.data_ptr() for x in tensors]


def joint_channels(ax, gx, ay, gy, w2, b2, labels_ext):
    """``(lse, z_blank, z_label)``, each (B, T, U+1) float32.

    ax, gx: (B, T, H) f32; ay, gy: (B, U+1, H) f32; w2: (H, V) f32;
    b2: (V,) f32; labels_ext: (B, U+1) int32 in [0, V).  CUDA inputs must be
    contiguous and on one device.  On the card the bf16 function of
    ``joint_channels_reference(mm_dtype=torch.bfloat16)``; on CPU tensors
    the float32 plain version.
    """
    if ax.device.type == "cpu":
        return joint_channels_reference(ax, gx, ay, gy, w2, b2, labels_ext)
    return _fwd_cuda(ax, gx, ay, gy, w2, b2, labels_ext)


def _fwd_cuda(ax, gx, ay, gy, w2, b2, labels_ext, tiles: int | None = None):
    """K1's launcher over chunks of ``tiles`` t-tiles (``chunk_bounds``):
    builds the padded bf16 W2^T, the padded b2 and the scratch."""
    b, t, u1, h, v = _check_cuda_inputs("joint_channels", ax, gx, ay, gy, w2, b2, labels_ext)
    _check_tiles("joint_channels", tiles)
    dev = ax.device
    lse, zb, zy = (torch.empty((b, t, u1), dtype=torch.float32, device=dev) for _ in range(3))
    if lse.numel() == 0:
        return lse, zb, zy
    chunks = chunk_bounds(b, t, u1, v, tiles)
    rows = max(bt1 - bt0 for bt0, bt1 in chunks) * u1
    w2_t, _, b2_p = _padded_weights(w2, b2, w2_rows=False)
    h_buf = torch.empty((rows, pad64(h)), dtype=torch.bfloat16, device=dev)
    part = torch.empty((-(-pad64(v) // ROW_TILE), rows, 2), dtype=torch.float32, device=dev)
    rc = cuda_build.library().pika_joint_channels_fwd(
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
        *_ptrs(ax, gx, ay, gy, w2_t, b2_p, labels_ext, h_buf, part, lse, zb, zy),
        b, t, u1, h, v, tiles or chunk_tiles(u1, v))
    cuda_build.check(rc, f"joint_channels launch (B={b}, T={t}, U1={u1}, H={h}, V={v})")
    joint_channels.launches += 1
    return lse, zb, zy


joint_channels.launches = 0


def joint_channels_bwd_reference(ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy,
                                 chunk: int = 32, mm_dtype=torch.float32):
    """The plain version of K2 and K3, over T chunks of ``chunk`` frames.

    ``mm_dtype=torch.float32``: the recompute-and-vjp of ``chunk_channels``
    (``pika_tpu/ops/rnnt_loss.py:_fused_bwd``, its XLA branch); ``lse`` is
    not needed there, autograd recomputes it.  ``torch.bfloat16``: what the
    card computes, rounding where ``pika_tpu/ops/rnnt_pallas.py:
    _bwd_in_kernel`` and ``_bwd_w_kernel`` do at their default mm_dtype --
    h and W2 before z = h W2 + b2 (with the given ``lse``), dz before dh =
    dz W2^T and dW2 = h^T dz, db2 from the unrounded dz -- and multiplying
    the rounded values in float32; dh stays float32 (the TPU kernel rounds
    its running sum to bf16 after each V tile)."""
    _check_mm_dtype(mm_dtype)
    args = (ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy)
    if mm_dtype == torch.bfloat16:
        return _bwd_bf16(*args, chunk=chunk, parts=PART_K2 | PART_K3)
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


def _bwd_bf16(ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy, chunk: int,
              parts: int):
    """``joint_channels_bwd_reference`` at bf16: K2's four gradients when
    ``parts`` has PART_K2, then K3's two when it has PART_K3."""
    w = _bf16_f32(w2)
    cols = torch.arange(w2.shape[1], device=w2.device)
    labels = labels_ext.long()[:, None, :, None]
    d_axs, d_gxs = [ax[:, :0]], [gx[:, :0]]
    d_ay, d_gy, d_w2, d_b2 = (torch.zeros_like(x) for x in (ay, gy, w2, b2))
    for t0 in range(0, ax.shape[1], chunk):
        sl = slice(t0, t0 + chunk)
        pre, gate = _hidden(ax[:, sl], gx[:, sl], ay, gy)
        h = _bf16_f32(pre * gate)
        z = h @ w + b2
        dz = d_lse[:, sl, :, None] * torch.exp(torch.clamp(z - lse[:, sl, :, None], max=40.0))
        dz = dz + torch.where(cols == 0, d_zb[:, sl, :, None], 0.0)
        dz = dz + torch.where(cols == labels, d_zy[:, sl, :, None], 0.0)
        dz_mm = _bf16_f32(dz)
        if parts & PART_K2:
            dh = dz_mm @ w.t()
            d_pre = dh * gate * (1.0 - pre * pre)
            d_gate = dh * pre * gate * (1.0 - gate)
            d_axs.append(d_pre.sum(dim=2))
            d_gxs.append(d_gate.sum(dim=2))
            d_ay += d_pre.sum(dim=1)
            d_gy += d_gate.sum(dim=1)
        if parts & PART_K3:
            d_w2 += h.reshape(-1, h.shape[-1]).t() @ dz_mm.reshape(-1, dz.shape[-1])
            d_b2 += dz.sum(dim=(0, 1, 2))
    out = ()
    if parts & PART_K2:
        out += (torch.cat(d_axs, dim=1), torch.cat(d_gxs, dim=1), d_ay, d_gy)
    if parts & PART_K3:
        out += (d_w2, d_b2)
    return out


def joint_channels_bwd_w_reference(ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy,
                                   chunk: int = 32, mm_dtype=torch.float32):
    """The plain version of K3: ``(d_w2, d_b2)`` of
    ``joint_channels_bwd_reference`` at ``mm_dtype`` (at bf16 without
    computing K2's gradients)."""
    _check_mm_dtype(mm_dtype)
    args = (ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy)
    if mm_dtype == torch.float32:
        return joint_channels_bwd_reference(*args, chunk)[4:]
    return _bwd_bf16(*args, chunk=chunk, parts=PART_K3)


def _bwd_cuda(what, ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy, parts: int,
              tiles: int | None = None):
    """The backward's launcher over chunks of ``tiles`` t-tiles
    (``chunk_bounds``): K2's gradients for PART_K2, then K3's for PART_K3,
    from one z per chunk.  Builds the padded bf16 copies of W2, the padded
    b2 and the scratch; the per-tile partials are summed with torch."""
    args = (ax, gx, ay, gy, w2, b2, labels_ext)
    b, t, u1, h, v = _check_cuda_inputs(what, *args, lse=lse, d_lse=d_lse, d_zb=d_zb, d_zy=d_zy)
    _check_tiles(what, tiles)
    k2, k3 = bool(parts & PART_K2), bool(parts & PART_K3)
    if b * t * u1 == 0:
        return (tuple(torch.zeros_like(x) for x in (ax, gx, ay, gy)) * k2
                + (torch.zeros_like(w2), torch.zeros_like(b2)) * k3)
    dev = ax.device
    hp, vp = pad64(h), pad64(v)
    chunks = chunk_bounds(b, t, u1, v, tiles)
    rows = [(bt1 - bt0) * u1 for bt0, bt1 in chunks]
    w2_t, w2_p, b2_p = _padded_weights(w2, b2, w2_rows=k2)
    h_buf = torch.empty((max(rows), hp), dtype=torch.bfloat16, device=dev)
    dz_buf = torch.empty((max(rows), vp), dtype=torch.bfloat16, device=dev)

    def empty(*shape, want):
        return torch.empty(shape, dtype=torch.float32, device=dev) if want else None

    dw2 = empty(hp, vp, want=k3)
    db2_p = empty(sum(-(-r // ROW_TILE) for r in rows), vp, want=k3)
    nt, nu = -(-t // T_TILE), -(-u1 // U_TILE)
    dax_p, dgx_p = (empty(b, t, nu, h, want=k2) for _ in range(2))
    day_p, dgy_p = (empty(b, nt, u1, h, want=k2) for _ in range(2))
    rc = cuda_build.library().pika_joint_channels_bwd(
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
        *_ptrs(ax, gx, ay, gy, w2_t, w2_p, b2_p, labels_ext, lse, d_lse, d_zb, d_zy, h_buf,
               dz_buf, dw2, db2_p, dax_p, dgx_p, day_p, dgy_p),
        b, t, u1, h, v, tiles or chunk_tiles(u1, v), parts)
    cuda_build.check(rc, f"{what} launch (B={b}, T={t}, U1={u1}, H={h}, V={v})")
    out = ()
    if k2:
        out += (dax_p.sum(2), dgx_p.sum(2), day_p.sum(1), dgy_p.sum(1))
    if k3:
        out += (dw2[:h, :v].contiguous(), db2_p.sum(0)[:v].contiguous())
    return out


def joint_channels_bwd_in(ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy):
    """K2: ``(d_ax, d_gx, d_ay, d_gy)``, inputs as ``joint_channels_bwd``.
    On the card (the h, dz and dh kernels over the chunks) the bf16
    function of ``joint_channels_bwd_reference(mm_dtype=torch.bfloat16)``;
    on CPU tensors the float32 plain version."""
    args = (ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy)
    if ax.device.type == "cpu":
        return joint_channels_bwd_reference(*args)[:4]
    out = _bwd_cuda("joint_channels_bwd_in", *args, parts=PART_K2)
    joint_channels_bwd_in.launches += 1
    return out


def joint_channels_bwd_w(ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy):
    """K3: ``(d_w2, d_b2)``, inputs as ``joint_channels_bwd``.  On the card
    (the h, dz and dW2 kernels over the chunks) the bf16 function of
    ``joint_channels_bwd_w_reference(mm_dtype=torch.bfloat16)``, as the JAX
    package's pallas backend runs it; on CPU tensors the float32 plain
    version, as its XLA backend does off the TPU."""
    args = (ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy)
    if ax.device.type == "cpu":
        return joint_channels_bwd_reference(*args)[4:]
    out = _bwd_cuda("joint_channels_bwd_w", *args, parts=PART_K3)
    joint_channels_bwd_w.launches += 1
    return out


def joint_channels_bwd(ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy):
    """``(d_ax, d_gx, d_ay, d_gy, d_w2, d_b2)``, float32, shaped like
    ``(ax, gx, ay, gy, w2, b2)``, given the cotangents of K1's channels.

    ``lse`` is K1's logsumexp; ``d_lse``, ``d_zb``, ``d_zy`` are (B, T, U+1)
    float32.  Other inputs as ``joint_channels``.  On CUDA: K2 and K3 from
    one z per chunk (the h, dz, dW2 and dh kernels; one launch of each
    counted).
    """
    args = (ax, gx, ay, gy, w2, b2, labels_ext, lse, d_lse, d_zb, d_zy)
    if ax.device.type == "cpu":
        return joint_channels_bwd_reference(*args)
    out = _bwd_cuda("joint_channels_bwd", *args, parts=PART_K2 | PART_K3)
    joint_channels_bwd_in.launches += 1
    joint_channels_bwd_w.launches += 1
    return out


joint_channels_bwd_in.launches = 0  # K2
joint_channels_bwd_w.launches = 0   # K3


def joint_launches() -> dict:
    """K1-K3's launch counts since they were last set to 0 (each wrapper
    counts the launches of its kernel on the card)."""
    return {"K1": joint_channels.launches, "K2": joint_channels_bwd_in.launches,
            "K3": joint_channels_bwd_w.launches}
