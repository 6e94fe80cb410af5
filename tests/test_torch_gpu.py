"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Needs a CUDA card and nvcc; skips without a card.  This file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import importlib

import numpy as np
import pytest
import torch

from pika_tpu_torch.models.transformer import MultiHeadedAttention
from pika_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_reference,
)
from pika_tpu_torch.ops.rnnt_kernels import (
    _bwd_w_cuda,
    joint_channels,
    joint_channels_bwd,
    joint_channels_bwd_in,
    joint_channels_bwd_reference,
    joint_channels_bwd_w,
    joint_channels_bwd_w_reference,
    joint_channels_reference,
)
from pika_tpu_torch.ops.rnnt_loss import rnnt_loss_forward, rnnt_loss_fused

pytestmark = pytest.mark.gpu
# the module itself: the package re-exports a function of the same name
flash_module = importlib.import_module("pika_tpu_torch.ops.flash_attention")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(device, b, t, u1, h, v, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) * 0.5
              for s in ((b, t, h), (b, t, h), (b, u1, h), (b, u1, h))]
    arrays += [rng.standard_normal((h, v)).astype(np.float32) * 0.2,
               rng.standard_normal(v).astype(np.float32) * 0.1,
               rng.integers(0, v, (b, u1)).astype(np.int32)]
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


@pytest.mark.parametrize("shape", [(2, 37, 11, 96, 301), (1, 1, 1, 4, 1), (3, 33, 5, 64, 256),
                                   (2, 8, 3, 1030, 513), (2, 8, 3, 1500, 513),
                                   (1, 6, 3, 2000, 300), (1, 5, 2, 4000, 129)])
def test_k1_matches_reference(cuda_device, shape):
    """K1 against its plain version (both float32, summation order differs):
    1e-4 relative, 1e-4 absolute.  One launch per call.  The H values reach
    each row tile the kernel picks (48, 32, 16 and 8 rows per block)."""
    args = _case(cuda_device, *shape)
    ref = joint_channels_reference(*args)
    before = joint_channels.launches
    got = joint_channels(*args)
    torch.cuda.synchronize()
    assert joint_channels.launches == before + 1
    for name, r, g in zip(("lse", "z_blank", "z_label"), ref, got):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4, msg=name)


def test_k1_rejects_bad_inputs(cuda_device):
    ax, gx, ay, gy, w2, b2, labels = _case(cuda_device, 2, 5, 3, 8, 10)
    with pytest.raises(ValueError, match="contiguous"):
        joint_channels(ax.transpose(0, 1).contiguous().transpose(0, 1), gx, ay, gy, w2, b2, labels)
    with pytest.raises(ValueError, match="labels_ext"):
        joint_channels(ax, gx, ay, gy, w2, b2, labels.long())
    with pytest.raises(ValueError, match="w2"):
        joint_channels(ax, gx, ay, gy, w2.double(), b2, labels)
    with pytest.raises(RuntimeError, match="CUDA error"):  # h tile beyond shared memory
        joint_channels(*_case(cuda_device, 1, 2, 2, 8192, 10))


def test_loss_through_k1_matches_plain(cuda_device):
    ax, gx, ay, gy, w2, b2, labels_ext = _case(cuda_device, 3, 20, 8, 32, 70, seed=1)
    labels = labels_ext[:, :-1].clamp(min=1)
    t_len = torch.tensor([20, 11, 0], device=cuda_device)
    u_len = torch.tensor([7, 4, 2], device=cuda_device)
    got = rnnt_loss_forward(ax, gx, ay, gy, w2, b2, labels, t_len, u_len)
    ref = rnnt_loss_forward(ax, gx, ay, gy, w2, b2, labels, t_len, u_len, backend="plain")
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)
    assert got[2].item() == 0.0


def _bwd_case(device, b, t, u1, h, v, seed=0):
    """Inputs of K2/K3: the factors, K1's lse, and random channel cotangents."""
    args = _case(device, b, t, u1, h, v, seed)
    lse = joint_channels_reference(*args)[0]
    gen = torch.Generator(device).manual_seed(seed + 1)
    cots = tuple(torch.randn(lse.shape, generator=gen, device=device) * 0.1 for _ in range(3))
    return args + (lse,) + cots


GRAD_NAMES = ("d_ax", "d_gx", "d_ay", "d_gy", "d_w2", "d_b2")
# K3 against its bf16 plain version: both round h, W2 and dz to bf16 at the
# same points; they differ by float32 sums in another order, exp2 against
# exp, and the rare bf16 flip of an h or dz that this moves across a
# rounding boundary (2^-8 of one term of a sum over the lattice)
K3_REL_L2, K3_MAX_REL = 1e-4, 1e-3
# BASELINE.md's envelope of the TPU kernels' bf16 rounding against float32
# gradients at flagship scale: K3 against the float32 plain version
K3_ENVELOPE = 6.4e-3


def _assert_grads_close(got, ref, rtol, names=GRAD_NAMES):
    """Each gradient within ``rtol`` of its largest reference entry, elementwise
    (float32 sums over up to B*T*U1 cells in another order)."""
    for name, g, r in zip(names, got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32, name
        scale = max(r.abs().max().item(), 1e-6)
        err = (g - r).abs().max().item()
        assert err <= rtol * scale, f"{name}: max abs err {err} vs {rtol} x {scale}"


def _rel_l2(got, ref):
    return ((got - ref).norm() / ref.norm().clamp(min=1e-30)).item()


def _assert_k3_close(got, ref):
    """d_w2, d_b2 of K3 against the bf16 plain version."""
    for name, g, r in zip(("d_w2", "d_b2"), got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32, name
        assert torch.isfinite(g).all(), name
        rel, err = _rel_l2(g, r), (g - r).abs().max().item()
        assert rel <= K3_REL_L2 and err <= K3_MAX_REL * r.abs().max().item(), (name, rel, err)


@pytest.mark.parametrize("shape", [(2, 37, 11, 96, 301), (1, 1, 1, 4, 1), (2, 1, 5, 64, 100),
                                   (2, 9, 1, 64, 100), (3, 33, 5, 64, 256),
                                   (2, 8, 3, 1030, 513), (2, 8, 3, 1500, 513),
                                   (1, 6, 3, 2000, 300), (1, 5, 2, 3100, 129)])
def test_k2_k3_match_reference(cuda_device, shape):
    """K2 against the plain chunked vjp (float32: every gradient within 1e-4
    of its largest entry), K3 against its bf16 plain version (K3_REL_L2,
    K3_MAX_REL).  One launch of each per call.  The H values reach each row
    tile K2 picks (24, 16 and 8 cells per block) and H not a multiple of
    K3's 64-deep stages or 128-row tiles; T = 1, U1 = 1, V = 1 and V not a
    multiple of 8 or of either V tile are the degenerate shapes."""
    args = _bwd_case(cuda_device, *shape)
    ref = joint_channels_bwd_reference(*args, mm_dtype=torch.bfloat16)
    before = (joint_channels_bwd_in.launches, joint_channels_bwd_w.launches)
    got = joint_channels_bwd(*args)
    torch.cuda.synchronize()
    assert (joint_channels_bwd_in.launches, joint_channels_bwd_w.launches) == (
        before[0] + 1, before[1] + 1)
    _assert_grads_close(got[:4], ref[:4], 1e-4)
    _assert_k3_close(got[4:], ref[4:])


def test_k2_k3_blank_is_label(cuda_device):
    """Where labels_ext is 0 the blank and label cotangents both land on
    column 0."""
    args = list(_bwd_case(cuda_device, 2, 7, 4, 32, 50))
    args[6] = torch.zeros_like(args[6])
    got = joint_channels_bwd(*args)
    ref = joint_channels_bwd_reference(*args, mm_dtype=torch.bfloat16)
    _assert_grads_close(got[:4], ref[:4], 1e-4)
    _assert_k3_close(got[4:], ref[4:])


def test_k2_k3_reject_bad_inputs(cuda_device):
    args = list(_bwd_case(cuda_device, 2, 5, 3, 8, 10))
    bad = dict(enumerate(args))
    for i, x, match in ((0, args[0].transpose(0, 1).contiguous().transpose(0, 1), "contiguous"),
                        (6, args[6].long(), "labels_ext"), (4, args[4].double(), "w2"),
                        (8, args[8][:, :-1], "d_lse"), (7, args[7].cpu(), "lse")):
        for fn in (joint_channels_bwd, joint_channels_bwd_in, joint_channels_bwd_w):
            with pytest.raises(ValueError, match=match):
                fn(*{**bad, i: x}.values())
    with pytest.raises(RuntimeError, match="CUDA error"):  # h and dh tiles beyond shared memory
        joint_channels_bwd(*_bwd_case(cuda_device, 1, 2, 2, 4000, 10))


def test_loss_gradients_through_kernels_match_plain(cuda_device):
    """Autograd through K1, K2 and K3 against the plain (float32) backend,
    with empty and short utterances: losses to 1e-5, the input gradients
    within 1e-4 of their largest entry, d_w2 and d_b2 (bf16 in K3) within
    K3_ENVELOPE relative L2; the empty utterance's gradients are exactly 0."""
    ax, gx, ay, gy, w2, b2, labels_ext = _case(cuda_device, 3, 20, 8, 32, 70, seed=2)
    labels = labels_ext[:, :-1].clamp(min=1)
    t_len = torch.tensor([20, 11, 0], device=cuda_device)
    u_len = torch.tensor([7, 4, 2], device=cuda_device)
    out = {}
    for backend in ("auto", "plain"):
        leaves = [x.clone().requires_grad_() for x in (ax, gx, ay, gy, w2, b2)]
        loss = rnnt_loss_fused(*leaves, labels, t_len, u_len, 8, backend)
        loss.sum().backward()
        out[backend] = (loss.detach(), [x.grad for x in leaves])
    torch.testing.assert_close(out["auto"][0], out["plain"][0], rtol=1e-5, atol=1e-4)
    _assert_grads_close(out["auto"][1][:4], out["plain"][1][:4], 1e-4)
    for name, g, r in zip(("d_w2", "d_b2"), out["auto"][1][4:], out["plain"][1][4:]):
        assert _rel_l2(g, r) <= K3_ENVELOPE, (name, _rel_l2(g, r))
    for g in out["auto"][1][:4]:
        assert torch.count_nonzero(g[2]) == 0


@pytest.mark.parametrize("shape,chunk_rows", [((2, 37, 11, 96, 301), 256),
                                              ((2, 20, 9, 128, 6268), 128),
                                              ((1, 8, 5, 256, 6268), 128),
                                              ((3, 13, 7, 200, 513), 128)])
def test_k3_chunks_match_bf16_reference(cuda_device, shape, chunk_rows):
    """K3 over several chunks of lattice rows (the chunk size lowered through
    the launcher), the last one partial (814 = 3 x 256 + 46, 360 = 2 x 128
    + 104, 273 = 2 x 128 + 17 rows; 40 rows in one chunk), at V = 301, 513
    and 6268, against its bf16 plain version."""
    args = _bwd_case(cuda_device, *shape)
    ref = joint_channels_bwd_w_reference(*args, mm_dtype=torch.bfloat16)
    before = joint_channels_bwd_w.launches
    got = _bwd_w_cuda(*args, chunk_rows=chunk_rows)
    torch.cuda.synchronize()
    assert joint_channels_bwd_w.launches == before + 1
    _assert_k3_close(got, ref)


def test_k3_within_the_f32_envelope(cuda_device):
    """K3 (bf16, as the TPU kernel rounds) against the float32 plain version,
    with W2 scaled as the model initializes it: each gradient within
    K3_ENVELOPE relative L2, and d_w2 measurably away from float32."""
    args = list(_bwd_case(cuda_device, 2, 31, 9, 512, 1000, seed=3))
    args[4] = args[4] * (2.0 / 512 ** 0.5 / 0.2)
    args[7] = joint_channels_reference(*args[:7])[0]
    got = joint_channels_bwd_w(*args)
    ref = joint_channels_bwd_w_reference(*args)
    for name, g, r in zip(("d_w2", "d_b2"), got, ref):
        assert _rel_l2(g, r) <= K3_ENVELOPE, (name, _rel_l2(g, r))
    assert _rel_l2(got[0], ref[0]) > 1e-5


def test_k3_rerun_is_bit_identical(cuda_device):
    """No atomics, chunks in stream order: a second run gives the same bits."""
    args = _bwd_case(cuda_device, 2, 37, 11, 96, 301, seed=4)
    first = _bwd_w_cuda(*args, chunk_rows=256)
    second = _bwd_w_cuda(*args, chunk_rows=256)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_k3_rejects_bad_chunk_rows(cuda_device):
    args = _bwd_case(cuda_device, 1, 5, 3, 16, 10)
    for rows in (0, 100, -128):
        with pytest.raises(ValueError, match="chunk_rows"):
            _bwd_w_cuda(*args, chunk_rows=rows)


# ---------------------------------------------------------------------------
# K4: flash attention
# ---------------------------------------------------------------------------

def _k4_case(device, b, h, t, d, seed=0):
    """bf16 q (scaled as the layer scales it), k, v and an output cotangent."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, h, t, d)).astype(np.float32) * scale
              for scale in (2.0 / np.sqrt(d), 1.0, 1.0, 1.0)]
    return tuple(torch.from_numpy(a).to(device).to(torch.bfloat16) for a in arrays)


def _assert_k4_close(got, ref, name, tol=1e-2):
    """bf16 results: the kernel rounds p relative to the running max of its
    key tiles, the plain version relative to the row max, so they agree to
    bf16 rounding: ``tol`` relative L2 and ``tol`` of the largest entry.  A
    result that is 0 but for float noise (dk at T = 1, where ds = 0) is held
    to 1e-5 absolute."""
    assert got.shape == ref.shape and got.dtype == ref.dtype, name
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all(), name
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    if scale < 1e-5:
        assert err <= 1e-5, f"{name}: max abs {err}"
        return
    rel = ((got - ref).norm() / ref.norm()).item()
    assert rel <= tol and err <= tol * scale, f"{name}: rel L2 {rel}, max abs {err} of {scale}"


def _k4_launches():
    return (flash_attention_fwd.launches, flash_attention_bwd_dkv.launches,
            flash_attention_bwd_dq.launches)


@pytest.mark.parametrize("shape", [(1, 1, 1, 64), (2, 3, 37, 64), (2, 3, 37, 128),
                                   (1, 2, 64, 64), (2, 2, 130, 128), (1, 2, 200, 64),
                                   (2, 16, 992, 64), (1, 8, 239, 128),
                                   *((1, 2, t, d) for t in (127, 128, 129, 255, 1000)
                                     for d in (64, 128))])
def test_k4_matches_reference(cuda_device, shape):
    """K4's forward, dk/dv and dq kernels against the plain versions (the
    backward kernels fed the plain forward's o and lse): T = 1, T below,
    at and across the 64-row tile and the backward's 128-row block (127,
    128, 129, 255), T = 1000 (16 streamed tiles: the 3-stage ring wraps 5
    times), the encoder layers' T = 992 and 239; lse to 1e-4 (float32).
    One launch of each per call."""
    q, k, v, do = _k4_case(cuda_device, *shape)
    ref_o, ref_lse = flash_attention_reference(q, k, v)
    ref_dq, ref_dk, ref_dv = flash_attention_bwd_reference(q, k, v, ref_o, ref_lse, do)
    before = _k4_launches()
    o, lse = flash_attention_fwd(q, k, v)
    dk, dv = flash_attention_bwd_dkv(q, k, v, ref_o, ref_lse, do)
    dq = flash_attention_bwd_dq(q, k, v, ref_o, ref_lse, do)
    torch.cuda.synchronize()
    assert _k4_launches() == tuple(n + 1 for n in before)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    for name, got, ref in (("o", o, ref_o), ("dq", dq, ref_dq), ("dk", dk, ref_dk),
                           ("dv", dv, ref_dv)):
        _assert_k4_close(got, ref, name)


@pytest.mark.parametrize("d", [64, 128])
def test_k4_forward_rerun_is_bit_identical(cuda_device, d):
    """The forward twice on the same inputs: the same o and lse bits (every
    block owns its queries; no atomics)."""
    q, k, v, _ = _k4_case(cuda_device, 2, 3, 300, d, seed=3)
    o1, lse1 = flash_attention_fwd(q, k, v)
    o2, lse2 = flash_attention_fwd(q, k, v)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def test_k4_autograd_is_deterministic(cuda_device):
    """``flash_attention`` with autograd on the card: forward and backward
    through the three kernels (one launch each), the gradients against the
    plain backward from the kernel's own forward, bit-identical on a second
    run (no atomics)."""
    q, k, v, do = _k4_case(cuda_device, 2, 4, 150, 64, seed=1)
    runs = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        before = _k4_launches()
        o = flash_attention(*leaves)
        o.backward(do)
        torch.cuda.synchronize()
        assert _k4_launches() == tuple(n + 1 for n in before)
        runs.append([o.detach()] + [x.grad for x in leaves])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    o, lse = flash_attention_fwd(q, k, v)
    for name, got, ref in zip(("dq", "dk", "dv"), runs[0][1:],
                              flash_attention_bwd_reference(q, k, v, o, lse, do)):
        _assert_k4_close(got, ref, name)


def test_k4_backward_takes_di_once(cuda_device, monkeypatch):
    """One autograd backward evaluates di = sum(o * do) once and hands it to
    both kernels; a di passed in gives the same bits as one computed inside."""
    calls = []
    di_fn = flash_module.flash_attention_di
    monkeypatch.setattr(flash_module, "flash_attention_di",
                        lambda o, do: calls.append(1) or di_fn(o, do))
    q, k, v, do = _k4_case(cuda_device, 2, 4, 150, 128, seed=2)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_attention(*leaves).backward(do)
    torch.cuda.synchronize()
    assert len(calls) == 1
    o, lse = flash_attention_fwd(q, k, v)
    di = di_fn(o, do)
    for given, inside in ((flash_attention_bwd_dkv(q, k, v, o, lse, do, di=di),
                           flash_attention_bwd_dkv(q, k, v, o, lse, do)),
                          ((flash_attention_bwd_dq(q, k, v, o, lse, do, di=di),),
                           (flash_attention_bwd_dq(q, k, v, o, lse, do),))):
        for a, b in zip(given, inside):
            assert torch.equal(a, b)
    assert len(calls) == 3
    with pytest.raises(ValueError, match="di"):
        flash_attention_bwd_dq(q, k, v, o, lse, do, di=di.double())


def test_k4_rejects_bad_inputs(cuda_device):
    q, k, v, do = _k4_case(cuda_device, 1, 2, 40, 64)
    for args, match in (((q.float(), k, v), "bfloat16"), ((q, k.cpu(), v), "bfloat16"),
                        ((q[..., :32].contiguous(), k, v), "d in"),
                        ((q.transpose(2, 3).contiguous().transpose(2, 3), k, v), "contiguous"),
                        ((q, k, v[:, :, :-1]), "bfloat16")):
        with pytest.raises(ValueError, match=match):
            flash_attention_fwd(*args)
    o, lse = flash_attention_fwd(q, k, v)
    for fn in (flash_attention_bwd_dkv, flash_attention_bwd_dq):
        with pytest.raises(ValueError, match="lse"):
            fn(q, k, v, o, lse.double(), do)
        with pytest.raises(ValueError, match="do"):
            fn(q, k, v, o, lse, do.float())


def test_flash_layer_matches_exact_on_card(cuda_device):
    """``MultiHeadedAttention(use_flash=True)`` through K4 against the exact
    layer with the same weights, at the encoder's first layer width: output
    to 1e-2 relative L2 (bf16 rounding at other points), each parameter's
    gradient to 3e-2 (the flash backward rounds ds to bf16 before its
    products, the exact one keeps it float32).  The key bias's gradient is 0
    but for that noise: under 1e-2 of the value bias's on both paths."""
    gen = torch.Generator(cuda_device).manual_seed(0)
    x = torch.randn((2, 300, 1024), generator=gen, device=cuda_device)
    out = {}
    for use_flash in (True, False):
        torch.manual_seed(0)
        layer = MultiHeadedAttention(16, 1024, use_flash=use_flash, device=cuda_device)
        before = flash_attention_fwd.launches
        y = layer(x, x, x)
        y.square().sum().backward()
        assert flash_attention_fwd.launches == before + int(use_flash)
        out[use_flash] = (y.detach(), {n: p.grad for n, p in layer.named_parameters()})
    rel = ((out[True][0] - out[False][0]).norm() / out[False][0].norm()).item()
    assert rel <= 1e-2, rel
    scale = out[False][1]["linear_values.bias"].abs().max().item()
    for name, g in out[True][1].items():
        ref = out[False][1][name]
        if name == "linear_keys.bias":  # 0 but for rounding noise on both paths
            assert max(g.abs().max().item(), ref.abs().max().item()) <= 1e-2 * scale
            continue
        rel = ((g - ref).norm() / ref.norm()).item()
        assert rel <= 3e-2, (name, rel)
