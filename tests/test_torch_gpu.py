"""The port's CUDA kernels on the card, against their plain PyTorch versions
(K1-K4, the loss DP's two kernels and the beam's bookkeeping kernels), the
decode loops' CUDA graphs against their eager loops, the LSTM's fused
route (cuDNN) against its loop over frames, and the pruned training's
repeat to the bit.

Needs a CUDA card and nvcc; skips without a card.  This file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import importlib
import threading

import numpy as np
import pytest
import torch

from pika_tpu_torch.decode import beam as beam_module
from pika_tpu_torch.decode import beam_kernels
from pika_tpu_torch.decode.beam import (BODIES, NEG, BeamConfig, BeamLoop, beam_search,
                                        beam_search_eager)
from pika_tpu_torch.decode.fst import _build_tables, fst_advance_sets, init_state_sets
from pika_tpu_torch.decode.greedy import greedy_decode, greedy_decode_eager
from pika_tpu_torch.models.lstm import LSTM
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer
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
    PART_K2,
    PART_K3,
    _bwd_cuda,
    _fwd_cuda,
    joint_channels,
    joint_channels_bwd,
    joint_channels_bwd_in,
    joint_channels_bwd_reference,
    joint_channels_bwd_w,
    joint_channels_bwd_w_reference,
    joint_channels_reference,
)
from pika_tpu_torch.ops.rnnt_loss import (
    dp_backward,
    dp_backward_reference,
    dp_forward,
    dp_forward_reference,
    rnnt_loss_forward,
    rnnt_loss_fused,
    rnnt_occupancy,
)
from pika_tpu_torch.features.fbank import FbankConfig
from pika_tpu_torch.ops.rnnt_pruned import (
    gather_rows,
    prune_ranges,
    rnnt_loss_pruned,
    simple_channels,
)
from pika_tpu_torch.train.lr import make_optimizer
from pika_tpu_torch.train.step import FeaturizerConfig, make_featurizer, make_train_step
from pika_tpu_torch.utils.dtypes import resolve_mm_dtype

pytestmark = pytest.mark.gpu
# the module itself: the package re-exports a function of the same name
flash_module = importlib.import_module("pika_tpu_torch.ops.flash_attention")
BF16 = torch.bfloat16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(device, b, t, u1, h, v, seed=0, w_scale=0.2):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) * 0.5
              for s in ((b, t, h), (b, t, h), (b, u1, h), (b, u1, h))]
    arrays += [rng.standard_normal((h, v)).astype(np.float32) * w_scale,
               rng.standard_normal(v).astype(np.float32) * 0.1,
               rng.integers(0, v, (b, u1)).astype(np.int32)]
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def _model_case(device, b, t, u1, h, v, seed=0):
    """W2 scaled as the model initializes it (z of a few units)."""
    return _case(device, b, t, u1, h, v, seed, w_scale=2.0 / h ** 0.5)


# K1 against its bf16 plain version: both round h and W2 to bf16 and sum in
# float32, in another order, exp2 against exp in the lse; a rare bf16 flip
# of an h (tanhf and expf on the card against torch's) moves a logit by
# 2^-8 of one of its H terms
K1_RTOL, K1_ATOL = 1e-4, 1e-3
# K1 against float32 at the model's W2 scale: the bf16 rounding of h and W2
# moves each logit by about 2^-9 of the root sum of squares of its terms
K1_ENVELOPE = 2e-2


@pytest.mark.parametrize("shape", [(2, 37, 11, 96, 301), (1, 1, 1, 4, 1), (3, 33, 5, 64, 256),
                                   (2, 8, 3, 1030, 513), (2, 8, 3, 1500, 513),
                                   (1, 6, 3, 2000, 300), (1, 5, 2, 4000, 129)])
def test_k1_matches_reference(cuda_device, shape):
    """K1 against its bf16 plain version (K1_RTOL, K1_ATOL).  One launch per
    call.  H and V not multiples of the 64-deep stages or 128-wide tiles;
    T = 1, U1 = 1, V = 1."""
    args = _case(cuda_device, *shape)
    ref = joint_channels_reference(*args, mm_dtype=BF16)
    before = joint_channels.launches
    got = joint_channels(*args)
    torch.cuda.synchronize()
    assert joint_channels.launches == before + 1
    for name, r, g in zip(("lse", "z_blank", "z_label"), ref, got):
        torch.testing.assert_close(g, r, rtol=K1_RTOL, atol=K1_ATOL, msg=name)


def test_k1_within_the_f32_envelope(cuda_device):
    """K1 (bf16, as the TPU kernel rounds) against the float32 plain version
    at the model's W2 scale: within K1_ENVELOPE, and measurably away."""
    args = _model_case(cuda_device, 2, 31, 9, 512, 1000, seed=3)
    got = joint_channels(*args)
    ref = joint_channels_reference(*args)
    errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
    assert max(errs) <= K1_ENVELOPE, errs
    assert errs[0] > 1e-6, errs


@pytest.mark.parametrize("tiles", [1, 2, 3])
def test_k1_chunks_give_the_same_bits(cuda_device, tiles):
    """Each row's channels do not depend on how the lattice is cut into
    chunks (1, 2, 3 t-tiles of 16 frames: 3 x 3, 2 and 1 chunks at T = 37,
    ragged last ones, a t-tile crossing the utterance end)."""
    args = _case(cuda_device, 3, 37, 11, 96, 301, seed=5)
    ref = joint_channels(*args)
    got = _fwd_cuda(*args, tiles=tiles)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_k1_rejects_bad_inputs(cuda_device):
    ax, gx, ay, gy, w2, b2, labels = _case(cuda_device, 2, 5, 3, 8, 10)
    with pytest.raises(ValueError, match="contiguous"):
        joint_channels(ax.transpose(0, 1).contiguous().transpose(0, 1), gx, ay, gy, w2, b2, labels)
    with pytest.raises(ValueError, match="labels_ext"):
        joint_channels(ax, gx, ay, gy, w2, b2, labels.long())
    with pytest.raises(ValueError, match="w2"):
        joint_channels(ax, gx, ay, gy, w2.double(), b2, labels)
    with pytest.raises(ValueError, match="tiles"):
        _fwd_cuda(ax, gx, ay, gy, w2, b2, labels, tiles=-1)


def test_loss_through_k1_matches_plain(cuda_device):
    """The loss through K1 against the plain backend, which computes K1's
    bf16 function on the card."""
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
    lse = joint_channels_reference(*args, mm_dtype=BF16)[0]
    gen = torch.Generator(device).manual_seed(seed + 1)
    cots = tuple(torch.randn(lse.shape, generator=gen, device=device) * 0.1 for _ in range(3))
    return args + (lse,) + cots


GRAD_NAMES = ("d_ax", "d_gx", "d_ay", "d_gy", "d_w2", "d_b2")
# K2 against its bf16 plain version: both round h, W2 and dz to bf16 at the
# same points and keep dh float32; they differ by float32 sums in another
# order, exp2 against exp, and the rare bf16 flip of an h or dz that this
# moves across a rounding boundary (2^-8 of one term of a sum over V);
# measured on an H100 at 1.3e-05 relative L2 at the training shape.  K3
# against its bf16 plain version, the same (2.9e-05)
K2_REL_L2, K2_MAX_REL = 1e-4, 1e-3
K3_REL_L2, K3_MAX_REL = 1e-4, 1e-3
# BASELINE.md's envelope of the TPU kernels' bf16 rounding against float32
# gradients at flagship scale: K2 and K3 against the float32 plain version
ENVELOPE = 6.4e-3


def _rel_l2(got, ref):
    return ((got - ref).norm() / ref.norm().clamp(min=1e-30)).item()


def _assert_bf16_close(got, ref, names=GRAD_NAMES):
    """K2's gradients (K2_REL_L2, K2_MAX_REL) and K3's (K3_REL_L2,
    K3_MAX_REL) against the bf16 plain version: relative L2 and the max abs
    error as a share of the largest reference entry."""
    for name, g, r in zip(names, got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32, name
        assert torch.isfinite(g).all(), name
        rel_tol, max_tol = (K3_REL_L2, K3_MAX_REL) if name in ("d_w2", "d_b2") else (K2_REL_L2,
                                                                                   K2_MAX_REL)
        rel, err = _rel_l2(g, r), (g - r).abs().max().item()
        assert rel <= rel_tol and err <= max_tol * max(r.abs().max().item(), 1e-6), (name, rel,
                                                                                     err)


@pytest.mark.parametrize("shape", [(2, 37, 11, 96, 301), (1, 1, 1, 4, 1), (2, 1, 5, 64, 100),
                                   (2, 9, 1, 64, 100), (3, 33, 5, 64, 256),
                                   (2, 8, 3, 1030, 513), (2, 8, 3, 1500, 513),
                                   (1, 6, 3, 2000, 300), (1, 5, 2, 3100, 129),
                                   (2, 239, 41, 64, 300)])
def test_k2_k3_match_reference(cuda_device, shape):
    """The fused backward against the bf16 plain version; one launch of K2
    and of K3 counted per call.  H not a multiple of the 64-deep stages or
    the 128-column tiles; T = 37 and 239, whose last 16-frame tile crosses
    the utterance end; U1 not a multiple of the 8-label tile; T = 1, U1 = 1,
    V = 1 and V not a multiple of 8 or of a tile are the degenerate
    shapes."""
    args = _bwd_case(cuda_device, *shape)
    ref = joint_channels_bwd_reference(*args, mm_dtype=BF16)
    before = (joint_channels_bwd_in.launches, joint_channels_bwd_w.launches)
    got = joint_channels_bwd(*args)
    torch.cuda.synchronize()
    assert (joint_channels_bwd_in.launches, joint_channels_bwd_w.launches) == (
        before[0] + 1, before[1] + 1)
    _assert_bf16_close(got, ref)


def test_k2_k3_blank_is_label(cuda_device):
    """Where labels_ext is 0 the blank and label cotangents both land on
    column 0."""
    args = list(_bwd_case(cuda_device, 2, 7, 4, 32, 50))
    args[6] = torch.zeros_like(args[6])
    got = joint_channels_bwd(*args)
    ref = joint_channels_bwd_reference(*args, mm_dtype=BF16)
    _assert_bf16_close(got, ref)


def test_fused_backward_equals_the_standalone_kernels(cuda_device):
    """One z per chunk for both: the fused backward gives the standalone K2's
    and K3's bits, each wrapper counting its own launch."""
    args = _bwd_case(cuda_device, 2, 37, 11, 96, 301, seed=6)
    before = (joint_channels_bwd_in.launches, joint_channels_bwd_w.launches)
    fused = joint_channels_bwd(*args)
    alone = joint_channels_bwd_in(*args) + joint_channels_bwd_w(*args)
    assert (joint_channels_bwd_in.launches, joint_channels_bwd_w.launches) == (
        before[0] + 2, before[1] + 2)
    for name, a, b in zip(GRAD_NAMES, fused, alone):
        assert torch.equal(a, b), name


def test_k2_k3_reject_bad_inputs(cuda_device):
    args = list(_bwd_case(cuda_device, 2, 5, 3, 8, 10))
    bad = dict(enumerate(args))
    for i, x, match in ((0, args[0].transpose(0, 1).contiguous().transpose(0, 1), "contiguous"),
                        (6, args[6].long(), "labels_ext"), (4, args[4].double(), "w2"),
                        (8, args[8][:, :-1], "d_lse"), (7, args[7].cpu(), "lse")):
        for fn in (joint_channels_bwd, joint_channels_bwd_in, joint_channels_bwd_w):
            with pytest.raises(ValueError, match=match):
                fn(*{**bad, i: x}.values())
    with pytest.raises(ValueError, match="tiles"):
        _bwd_cuda("test", *args, parts=PART_K2 | PART_K3, tiles=0)


def test_loss_gradients_through_kernels_match_plain(cuda_device):
    """Autograd through K1, K2 and K3 against the plain backend (bf16 on the
    card, as the kernels), with empty and short utterances: losses to 1e-5,
    the gradients as _assert_bf16_close; the empty utterance's input
    gradients are exactly 0."""
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
    _assert_bf16_close(out["auto"][1], out["plain"][1])
    for g in out["auto"][1][:4]:
        assert torch.count_nonzero(g[2]) == 0


@pytest.mark.parametrize("shape,tiles", [((2, 37, 11, 96, 301), 2),
                                         ((2, 20, 9, 128, 6268), 1),
                                         ((1, 8, 5, 256, 6268), 1),
                                         ((3, 13, 7, 200, 513), 1),
                                         ((2, 239, 41, 64, 300), 4)])
def test_k3_chunks_match_bf16_reference(cuda_device, shape, tiles):
    """K2 and K3 over several chunks of whole 16-frame tiles (the chunk size
    lowered through the launcher; the last chunk partial: 3 tiles a
    37-frame utterance, 2 a chunk; 239 frames = 15 tiles, 4 a chunk), at
    V = 301, 513 and 6268, against the bf16 plain version; K2's gradients
    are those of the default schedule, bit for bit."""
    args = _bwd_case(cuda_device, *shape)
    ref = joint_channels_bwd_reference(*args, mm_dtype=BF16)
    got = _bwd_cuda("test", *args, parts=PART_K2 | PART_K3, tiles=tiles)
    torch.cuda.synchronize()
    _assert_bf16_close(got, ref)
    for name, a, b in zip(GRAD_NAMES, got[:4], joint_channels_bwd_in(*args)):
        assert torch.equal(a, b), name


def test_k2_k3_within_the_f32_envelope(cuda_device):
    """K2 and K3 (bf16, as the TPU kernels round) against the float32 plain
    version, with W2 scaled as the model initializes it: each gradient
    within ENVELOPE relative L2, and measurably away from float32."""
    args = list(_bwd_case(cuda_device, 2, 31, 9, 512, 1000, seed=3))
    args[4] = args[4] * (2.0 / 512 ** 0.5 / 0.2)
    args[7] = joint_channels(*args[:7])[0]
    got = joint_channels_bwd(*args)
    ref = joint_channels_bwd_reference(*args)
    for name, g, r in zip(GRAD_NAMES, got, ref):
        assert _rel_l2(g, r) <= ENVELOPE, (name, _rel_l2(g, r))
    assert _rel_l2(got[0], ref[0]) > 1e-5 and _rel_l2(got[4], ref[4]) > 1e-5


def test_k3_rerun_is_bit_identical(cuda_device):
    """No atomics, chunks in stream order: a second run of K1 and of the
    backward over several chunks gives the same bits."""
    args = _bwd_case(cuda_device, 2, 37, 11, 96, 301, seed=4)
    for run in (lambda: _fwd_cuda(*args[:7], tiles=2),
                lambda: _bwd_cuda("test", *args, parts=PART_K2 | PART_K3, tiles=2)):
        for a, b in zip(run(), run()):
            assert torch.equal(a, b)


def test_k3_rejects_bad_chunk_rows(cuda_device):
    args = _bwd_case(cuda_device, 1, 5, 3, 16, 10)
    for tiles in (0, -1):
        for parts in (PART_K2, PART_K3):
            with pytest.raises(ValueError, match="tiles"):
                _bwd_cuda("test", *args, parts=parts, tiles=tiles)


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
    result that is 0 but for float noise (dk and dq at T = 1, where ds = p
    (dp - di) with dp and di two float32 sums over d in other orders) is held
    to 1e-5 absolute, times d / 128 past d = 128."""
    assert got.shape == ref.shape and got.dtype == ref.dtype, name
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all(), name
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    noise = 1e-5 * max(1.0, got.shape[-1] / 128)
    if scale < noise:
        assert err <= noise, f"{name}: max abs {err}"
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
                                     for d in (64, 128)),
                                   (1, 1, 1, 256), (2, 3, 37, 256), (1, 2, 33, 256),
                                   (2, 8, 239, 256), (1, 2, 1000, 256)])
def test_k4_matches_reference(cuda_device, shape):
    """K4's forward, dk/dv and dq kernels against the plain versions (the
    backward kernels fed the plain forward's o and lse): T = 1, T below,
    at and across the 64-row tile and the backward's 128-row block (127,
    128, 129, 255), T = 1000 (16 streamed tiles: the 3-stage ring wraps 5
    times), the encoder layers' T = 992 and 239; the d = 256 kernels at
    T = 1, across their 32-row tile (33, 37), at 239 and 1000; lse to 1e-4
    (float32).  One launch of each per call."""
    q, k, v, do = _k4_case(cuda_device, *shape)
    before = _k4_launches()
    o, lse = flash_attention_fwd(q, k, v)
    ref_o, ref_lse = flash_attention_reference(q, k, v)
    dk, dv = flash_attention_bwd_dkv(q, k, v, ref_o, ref_lse, do)
    dq = flash_attention_bwd_dq(q, k, v, ref_o, ref_lse, do)
    torch.cuda.synchronize()
    # the plain backward after the kernels: none of its freed blocks can
    # stand in for a kernel's unwritten output
    ref_dq, ref_dk, ref_dv = flash_attention_bwd_reference(q, k, v, ref_o, ref_lse, do)
    assert _k4_launches() == tuple(n + 1 for n in before)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    for name, got, ref in (("o", o, ref_o), ("dq", dq, ref_dq), ("dk", dk, ref_dk),
                           ("dv", dv, ref_dv)):
        _assert_k4_close(got, ref, name)


@pytest.mark.parametrize("d", [64, 128, 256])
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


@pytest.mark.parametrize("shape", [(2, 3, 37, 16), (1, 16, 300, 16), (2, 3, 130, 32),
                                   (1, 8, 239, 32), (2, 2, 200, 96), (2, 2, 70, 136),
                                   (1, 8, 239, 200)])
def test_k4_pads_other_head_widths(cuda_device, shape):
    """``flash_attention`` at d = 16, 32, 96, 136 and 200 (tdnn_nhid = 256
    gives 16, 16 and 32): zero-padded to the kernels' 64, 128 or 256, forward and backward
    through the three kernels (one launch each), against the plain versions
    at the true d."""
    q, k, v, do = _k4_case(cuda_device, *shape)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = _k4_launches()
    o = flash_attention(*leaves)
    o.backward(do)
    torch.cuda.synchronize()
    assert _k4_launches() == tuple(n + 1 for n in before)
    ref_o, ref_lse = flash_attention_reference(q, k, v)
    _assert_k4_close(o.detach(), ref_o, "o")
    for name, got, ref in zip(("dq", "dk", "dv"), (x.grad for x in leaves),
                              flash_attention_bwd_reference(q, k, v, ref_o, ref_lse, do)):
        _assert_k4_close(got, ref, name)


def test_k4_rejects_head_widths_past_256(cuda_device):
    q, k, v, _ = _k4_case(cuda_device, 1, 2, 40, 320)
    with pytest.raises(ValueError, match="d_head > 256"):
        flash_attention(q, k, v)


# the decode loops on the card: one CUDA graph of the body, against the same
# body run eagerly (which launches the same kernels, so the bits agree)
DECODE_MODEL = dict(input_dim=60, vocab_size=300, hid_dim=128, encoder_type="tdnn_transformer",
                    decoder_type="rnn", dec_layers=2, embd_dim=32, tdnn_nhid=64, tdnn_layers=5)


def _decode_case(device, b=3, t=10, seed=0, model_cfg=DECODE_MODEL):
    model = init_transducer(TransducerConfig(**model_cfg),
                            torch.Generator(device).manual_seed(0), device)
    g = torch.Generator(device).manual_seed(seed)
    enc = torch.randn(b, t, model_cfg["hid_dim"], generator=g, device=device) * 2
    lens = torch.tensor([t, max(1, t // 2), 1][:b] + [t] * max(0, b - 3), device=device)
    return model, enc, lens


def _assert_same_nbest(a, b):
    for name in ("tokens", "lens", "aligns", "align_lens", "scores", "steps"):
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("beam", [4, 8])
def test_beam_graph_matches_eager(cuda_device, beam):
    """Both run the bookkeeping kernels: two selection launches, one update
    and one commit in each body run in Python (the graph's warm-up and
    capture, every eager step)."""
    model, enc, lens = _decode_case(cuda_device)
    cfg = BeamConfig(beam_size=beam, n_best=4, max_symbols=12)
    bodies, launches = BODIES["kernels"], beam_kernels.launches()
    graphed = beam_search(model, enc, lens, cfg)
    eager = beam_search_eager(model, enc, lens, cfg)
    _assert_same_nbest(graphed, eager)
    assert all(loop.graph is not None for loop in model._decode_loops.values())
    ran = BODIES["kernels"] - bodies
    assert ran > int(eager["steps"])
    assert {k: v - launches[k] for k, v in beam_kernels.launches().items()} == {
        "select": 2 * ran, "update": ran, "commit": ran}


# the bookkeeping kernels against the torch body (``_plain=True``):
# (net, beam, n_best, prune_dups, mm_dtype, sm_scale, max_symbols); max_symbols
# 4 fills the token buffers (the full-beam cap); every value of each axis.
# "rnn" is DECODE_MODEL (V 300, H 128, the LSTM net), "transformer" its
# transformer prediction net (the re-forward of the tokens the update kernel
# wrote), "flagship" the decode cells' widths (V 6268, H 1024: a dozen
# candidates a thread); beam above 8 runs the kernels' wide instantiation
KERNEL_CASES = [("rnn", 4, 4, True, None, 1.0, 12), ("rnn", 8, 8, True, "auto", 1.2, 12),
                ("rnn", 4, 8, False, "auto", 1.2, 4), ("rnn", 8, 4, False, None, 1.2, 4),
                ("rnn", 8, 8, False, "auto", 1.0, 12), ("rnn", 4, 4, True, "auto", 1.2, 4),
                ("rnn", 8, 4, True, None, 1.2, 12), ("rnn", 4, 8, True, None, 1.0, 4),
                ("rnn", 16, 16, True, "auto", 1.2, 12), ("rnn", 32, 32, False, None, 1.0, 12),
                ("rnn", 32, 8, True, "auto", 1.2, 4),
                ("transformer", 4, 4, True, None, 1.2, 12),
                ("transformer", 8, 8, False, "auto", 1.0, 4),
                ("transformer", 16, 32, True, "auto", 1.2, 6),
                ("transformer", 32, 16, True, None, 1.2, 12),
                ("flagship", 8, 8, True, "auto", 1.2, 4), ("flagship", 8, 8, True, None, 1.2, 4)]
# where two of a reference selection's first k + 1 candidates lie this close,
# the kernels' float32 log-softmax (another order of summation) may pick or
# order them otherwise.  Equal values of one beam's row are no such tie: the
# log-softmax maps a row's equal logits to equal values on both sides, and
# both put the lower index first.
TIE_MARGIN = 1e-4
# a step's scores from one state: the log-softmax sums in another order, a
# few float32 ulps at the scores' magnitude; a whole search's scores
STEP_RTOL, STEP_ATOL = 1e-6, 1e-5
SCORE_RTOL = 1e-4


def _kernel_net(name):
    return {"rnn": DECODE_MODEL, "transformer": TRANSFORMER_MODEL,
            "flagship": dict(DECODE_MODEL, vocab_size=6268, hid_dim=1024, embd_dim=100)}[name]


def _near_ties(values, idx, k, vocab):
    """(B,) True where two neighbours among the first k + 1 of a top-k's
    ``values`` (sorted, descending) lie within ``TIE_MARGIN``, unless they
    are equal and of one beam's row (a (B, K * V) selection's index // V;
    ``vocab`` 0 for the other selections)."""
    row = idx // vocab if vocab else idx
    hi, lo = values[..., :-1], values[..., 1:]
    same_row = (hi == lo) & (row[..., :-1] == row[..., 1:])
    return (((hi - lo) <= TIE_MARGIN) & (lo > NEG / 2) & ~same_row).any(-1)


def _recording_ties(monkeypatch, near, vocab):
    """Patch the torch body's ``top_k`` to OR each selection's near ties
    into ``near``."""
    top_k = beam_module.top_k

    def recording(x, k):
        values, idx = top_k(x, min(k + 1, x.shape[-1]))
        near.logical_or_(_near_ties(values, idx, k, vocab if x.shape[-1] % vocab == 0 else 0))
        return values[..., :k], idx[..., :k]

    monkeypatch.setattr(beam_module, "top_k", recording)


def _step_by_step(model, enc, lens, cfg, monkeypatch):
    """The kernels against the torch body one step at a time from the same
    state, over a whole search: each step the kernels' loop takes the torch
    body's state (and the encoder rows at its time pointers), both run the
    step, and every utterance whose selections had no near tie must come out
    the same: the integer buffers and the net's state to the bit, the live
    and finished scores within STEP_RTOL / STEP_ATOL, the encoder rows the
    update kernel gathered those at the new pointers.  Returns the count of
    utterance-steps compared."""
    dev = enc.device
    net = model.decode_net(resolve_mm_dtype(cfg.mm_dtype, dev))
    b, t_max, _ = enc.shape
    ref = BeamLoop(net, cfg, b, t_max, dev, plain=True)
    got = BeamLoop(net, cfg, b, t_max, dev)
    ref.reset(enc, lens)
    got.reset(enc, lens)
    ks, ax_all, gx_all = got.kernels, ref.inputs["ax_all"], ref.inputs["gx_all"]

    def at_pointers(t_idx):
        g = t_idx.clamp(0, t_max - 1)[..., None].expand(-1, -1, ax_all.shape[-1])
        return ax_all.gather(1, g), gx_all.gather(1, g)

    near = torch.zeros(b, dtype=torch.bool, device=dev)
    compared = steps = 0
    with monkeypatch.context() as patch:
        _recording_ties(patch, near, net.config.vocab_size)
        while bool(ref.state["running"]):
            assert steps < ref.max_bodies
            for name, x in ref.state.items():
                got.state[name].copy_(x)
            for name, x in zip(("ax_sel", "gx_sel"), at_pointers(ref.state["t_idx"])):
                ks.scratch[name].copy_(x)
            near.zero_()
            ref.torch_body()
            got.kernel_body()
            ok = ~near
            for name, x in ref.state.items():
                y = got.state[name]
                if x.dim() == 0:
                    assert torch.equal(x, y), (steps, name)
                    continue
                x, y = (x[:, ok], y[:, ok]) if name in ref.dec_names else (x[ok], y[ok])
                if name in ("scores", "fin_scores"):
                    torch.testing.assert_close(y, x, rtol=STEP_RTOL, atol=STEP_ATOL,
                                               msg=lambda m: f"step {steps} {name}: {m}")
                else:
                    assert torch.equal(x, y), (steps, name)
            for name, x in zip(("ax_sel", "gx_sel"), at_pointers(got.state["t_idx"])):
                assert torch.equal(ks.scratch[name][ok], x[ok]), (steps, name)
            compared += int(ok.sum())
            steps += 1
    return compared


@pytest.mark.parametrize("net,beam,n_best,prune,mm_dtype,sm_scale,max_symbols", KERNEL_CASES)
def test_beam_kernels_match_the_torch_body(cuda_device, monkeypatch, net, beam, n_best, prune,
                                           mm_dtype, sm_scale, max_symbols):
    """Ragged lengths (one utterance of one frame): step by step from the
    same state (``_step_by_step``), some utterance-step compared; then the
    graphed search on the kernels against the torch body's: the same
    tokens, lengths and alignments for each utterance whose search had no
    near tie, scores within SCORE_RTOL."""
    model, enc, lens = _decode_case(cuda_device, b=4, t=12, model_cfg=_kernel_net(net))
    cfg = BeamConfig(beam_size=beam, n_best=n_best, prune_dups=prune, mm_dtype=mm_dtype,
                     sm_scale=sm_scale, max_symbols=max_symbols)
    assert _step_by_step(model, enc, lens, cfg, monkeypatch) > 0, "every step had a near tie"
    near = torch.zeros(4, dtype=torch.bool, device=cuda_device)
    with monkeypatch.context() as patch:
        _recording_ties(patch, near, model.config.vocab_size)
        ref = beam_search_eager(model, enc, lens, cfg, _plain=True)
    launches = beam_kernels.launches()
    got = beam_search(model, enc, lens, cfg)
    assert beam_kernels.launches()["commit"] > launches["commit"]
    for b in torch.nonzero(~near)[:, 0].tolist():
        for name in ("tokens", "lens", "aligns", "align_lens"):
            assert torch.equal(got[name][b], ref[name][b]), (b, name)
        torch.testing.assert_close(got["scores"][b], ref["scores"][b], rtol=SCORE_RTOL, atol=0)
    if not near.any():
        assert torch.equal(got["steps"], ref["steps"])


def test_beam_kernels_tie_rule(cuda_device):
    """A zero joint gives every token of a live beam the same log-prob, so
    the beams tie across tokens and with each other: the kernels pick the
    lower flat index, as ``top_k`` does, to the bit."""
    model, enc, lens = _decode_case(cuda_device)
    with torch.no_grad():
        model.fc2.weight.zero_()
        model.fc2.bias.zero_()
    for prune in (True, False):
        cfg = BeamConfig(beam_size=8, n_best=4, max_symbols=6, prune_dups=prune)
        got = beam_search(model, enc, lens, cfg)
        _assert_same_nbest(got, beam_search_eager(model, enc, lens, cfg, _plain=True))


def test_beam_graph_replays_give_identical_bits(cuda_device):
    """Two searches replay one captured graph and give the same bits."""
    model, enc, lens = _decode_case(cuda_device)
    cfg = BeamConfig(beam_size=8, n_best=8, max_symbols=12)
    first = beam_search(model, enc, lens, cfg)
    graph = next(iter(model._decode_loops.values())).graph
    _assert_same_nbest(first, beam_search(model, enc, lens, cfg))
    assert len(model._decode_loops) == 1
    assert next(iter(model._decode_loops.values())).graph is graph


def test_beam1_equals_greedy_on_card(cuda_device):
    model, enc, _ = _decode_case(cuda_device)
    lens = torch.full((3,), enc.shape[1], device=cuda_device)
    hyps, hyp_lens = greedy_decode(model, enc, lens, max_symbols=12)
    out = beam_search(model, enc, lens, BeamConfig(beam_size=1, n_best=1, max_symbols=12))
    assert torch.equal(out["lens"][:, 0], hyp_lens)
    assert torch.equal(out["tokens"][:, 0], hyps)


def test_decode_bf16_on_card(cuda_device):
    """``"auto"`` is bf16 on the card: finite scores, graph equal to eager."""
    model, enc, lens = _decode_case(cuda_device)
    cfg = BeamConfig(beam_size=8, n_best=4, max_symbols=12, mm_dtype="auto")
    out = beam_search(model, enc, lens, cfg)
    assert torch.isfinite(out["scores"][:, 0]).all()
    _assert_same_nbest(out, beam_search_eager(model, enc, lens, cfg))
    loop = next(iter(model._decode_loops.values()))
    assert loop.state["dec_h"].dtype == torch.bfloat16
    for a, b in zip(greedy_decode(model, enc, lens, 12, mm_dtype="auto"),
                    greedy_decode_eager(model, enc, lens, 12, mm_dtype="auto")):
        assert torch.equal(a, b)


def test_graph_recaptured_on_shape_change(cuda_device):
    """A new (B, T') captures a new graph; each matches its eager loop."""
    model, enc, lens = _decode_case(cuda_device)
    cfg = BeamConfig(beam_size=4, n_best=2, max_symbols=8)
    for b, t in ((3, 10), (3, 12), (5, 10)):
        _, enc, lens = _decode_case(cuda_device, b, t, seed=t)
        _assert_same_nbest(beam_search(model, enc, lens, cfg),
                           beam_search_eager(model, enc, lens, cfg))
        hyps = greedy_decode(model, enc, lens, max_symbols=8)
        for x, y in zip(hyps, greedy_decode_eager(model, enc, lens, max_symbols=8)):
            assert torch.equal(x, y)
    loops = model._decode_loops
    assert len(loops) == 6 and all(loop.graph is not None for loop in loops.values())


def test_graph_captured_beside_a_pinning_thread(cuda_device):
    """The decode loops capture while another thread pins host memory and
    copies it to the card on its own stream, as the training CLIs' prefetch
    thread pins batches (the host allocator queries CUDA events and
    allocates at any moment): every capture succeeds and each graph matches
    its eager loop."""
    stop, errors = threading.Event(), []

    def pin():
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
                while not stop.is_set():
                    torch.ones(1 << 14).pin_memory().to(cuda_device, non_blocking=True)
        except BaseException as exc:
            errors.append(exc)

    thread = threading.Thread(target=pin, daemon=True)
    thread.start()
    try:
        cfg = BeamConfig(beam_size=4, n_best=2, max_symbols=8)
        for t in range(8, 24):
            model, enc, lens = _decode_case(cuda_device, 3, t, seed=t)
            _assert_same_nbest(beam_search(model, enc, lens, cfg),
                               beam_search_eager(model, enc, lens, cfg))
    finally:
        stop.set()
        thread.join()
    assert not errors, errors


def _fst_tables(vocab, seed=0, n_states=20):
    """A random backoff LM over the decode model's tokens (ilabel = token +
    1): state 0 a final unigram state, contexts backing off to it."""
    rng = np.random.default_rng(seed)
    arcs, finals = {}, {0: 0.3}
    for s in range(n_states):
        labels = rng.choice(np.arange(2, vocab + 1), size=vocab - 10 if s == 0 else 40,
                            replace=False)
        arcs[s] = [(int(l), float(rng.uniform(0.0, 3.0)), int(rng.integers(1, n_states)))
                   for l in labels]
        if s:
            arcs[s].append((0, float(rng.uniform(0.0, 1.0)), 0))
            if rng.random() < 0.5:
                finals[s] = float(rng.uniform(0.0, 2.0))
    return _build_tables(n_states, arcs, finals, start=0, backoff_id=0)


@pytest.mark.parametrize("fusion,cache_mb", [(dict(), 1), (dict(lm_per_token=True, lm_topm=8), 1),
                                             (dict(lm_per_token=True, lm_topm=0), 1),
                                             (dict(lm_per_token=True, lm_topm=8), 0)])
def test_fst_beam_graph_matches_eager(cuda_device, fusion, cache_mb):
    """FST fusion in each mode (per-beam, per-token top-8 with the advance
    cache, exact, top-8 walk): the captured graph against the eager body,
    bit for bit; the tables are read in place, not copied into the loop."""
    model, enc, lens = _decode_case(cuda_device)
    tables = _fst_tables(DECODE_MODEL["vocab_size"])
    dev = tables.device_arrays(cuda_device, n_ilabels=DECODE_MODEL["vocab_size"] + 1,
                               cache_max_bytes=cache_mb << 20)
    assert ("adv_cost" in dev) == bool(cache_mb)
    cfg = BeamConfig(beam_size=8, n_best=4, max_symbols=12, lm_scale=0.8, nonblk_reward=0.3,
                     **fusion)
    launches, bodies = beam_kernels.launches(), dict(BODIES)
    graphed = beam_search(model, enc, lens, cfg, dev, tables.start)
    _assert_same_nbest(graphed, beam_search_eager(model, enc, lens, cfg, dev, tables.start))
    _assert_same_nbest(graphed, beam_search(model, enc, lens, cfg, dev, tables.start))
    loop = next(iter(model._decode_loops.values()))
    assert loop.graph is not None and loop.fst["arc_weight"] is dev["arc_weight"]
    # the FST searches keep the torch body: no bookkeeping kernel ran
    assert loop.route == "fst" and beam_kernels.launches() == launches
    assert BODIES["fst"] > bodies["fst"] and BODIES["kernels"] == bodies["kernels"]


def test_fst_walk_on_card_equals_cpu(cuda_device):
    """The walk (binary searches of a fixed step count, backoff levels,
    dedup) on the card gives the CPU's bits."""
    tables = _fst_tables(300, seed=1)
    dev, cpu = tables.device_arrays(cuda_device), tables.device_arrays("cpu")
    g = torch.Generator().manual_seed(0)
    sets_dev = init_state_sets(tables, (4, 8), 4, cuda_device)
    sets_cpu = init_state_sets(tables, (4, 8), 4, "cpu")
    for _ in range(8):
        labels = torch.randint(1, 302, (4, 8), generator=g)
        *sets_dev, lm_dev = fst_advance_sets(dev, *sets_dev, labels.to(cuda_device), 6, 0.2)
        *sets_cpu, lm_cpu = fst_advance_sets(cpu, *sets_cpu, labels, 6, 0.2)
        for a, b in zip(sets_dev + [lm_dev], sets_cpu + [lm_cpu]):
            assert torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# the training options on the card: remat with the card's generator, chunking
# ---------------------------------------------------------------------------

def test_remat_gradients_bit_for_bit_on_card(cuda_device):
    """Remat on the card restores the CUDA generator's state (Philox seed
    and offset) for the recomputation: with transformer dropout and the
    head-shared chunked mask on, outputs, gradients and the generator's
    later draws equal the run without remat, bit for bit (cuDNN pinned to
    its deterministic algorithms, so that only remat could differ)."""
    from pika_tpu_torch.models.tdnn_transformer import TDNNTransformerEncoder

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        gen = torch.Generator(cuda_device).manual_seed(0)
        x = torch.randn(2, 120, 24, generator=gen, device=cuda_device)
        results = []
        for remat in (False, True):
            enc = TDNNTransformerEncoder(24, 16, 64, 6, transformer_dropout=0.3, attn_chunk=32,
                                         remat=remat, device=cuda_device)
            with torch.no_grad():
                init = torch.Generator(cuda_device).manual_seed(1)
                for p in enc.parameters():
                    p.normal_(0, 0.2, generator=init)
            g = torch.Generator(cuda_device).manual_seed(2)
            xt = x.clone().requires_grad_()
            out = enc.train()(xt, generator=g)
            out.square().sum().backward()
            results.append((out.detach(), xt.grad, [p.grad for p in enc.parameters()],
                            torch.rand(8, generator=g, device=cuda_device)))
        (o0, gx0, gp0, r0), (o1, gx1, gp1, r1) = results
        assert torch.equal(o0, o1) and torch.equal(gx0, gx1) and torch.equal(r0, r1)
        assert all(torch.equal(a, b) for a, b in zip(gp0, gp1))
    finally:
        torch.backends.cudnn.deterministic = deterministic


def test_chunked_attention_matches_full_on_card(cuda_device):
    """The query-blocked core on the card is the full core's function."""
    x = torch.randn(2, 300, 64, generator=torch.Generator(cuda_device).manual_seed(0),
                    device=cuda_device)
    full = MultiHeadedAttention(4, 64, device=cuda_device)
    chunked = MultiHeadedAttention(4, 64, q_chunk=64, device=cuda_device)
    chunked.load_state_dict(full.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(chunked(x, x, x), full(x, x, x), rtol=1e-5, atol=1e-6)


# the second-stage recipes on the card: the MBR step (graphed decode with
# weights that change every step; K1-K3 against the plain loss backend) and
# LAS rescoring against the CPU
MBR_BEAM = dict(beam_size=4, n_best=4, sm_scale=1.2, max_symbols=12, prune_dups=False,
                mm_dtype="auto")
# a gradient leaf whose largest entry is below this share of the whole
# gradient's largest is zero to rounding (test_mbr_step_on_kernels_matches_
# plain_backend; the same rule as chip_smoke.py's hold_gradients)
ZERO_GRAD = 1e-4


def _mbr_case(device):
    """A small model (made on the CPU, then moved, so its weights do not
    depend on the card's generator), a batch of features and an SGD step."""
    from pika_tpu_torch.train.lr import make_optimizer
    from pika_tpu_torch.train.mbr import make_mbr_step

    model = init_transducer(TransducerConfig(**{**DECODE_MODEL, "dropout": 0.0,
                                                "tdnn_transformer_dropout": 0.0}),
                            torch.Generator().manual_seed(0), "cpu").to(device)
    g = torch.Generator().manual_seed(1)
    batch = {"feats": torch.randn(3, 40, DECODE_MODEL["input_dim"], generator=g),
             "feat_lens": torch.tensor([40, 33, 25]),
             "labels": torch.randint(1, 300, (3, 5), generator=g),
             "label_lens": torch.tensor([5, 3, 4])}
    batch = {n: x.to(device) for n, x in batch.items()}
    opt = make_optimizer(model.parameters(), "sgd", 0.05, 0.05, 10, 0.9, 3.0)
    step = make_mbr_step(model, opt, lambda x, lens, generator=None: (x, lens),
                         BeamConfig(**MBR_BEAM), rnnt_scale=0.1, sm_scale=1.2)
    return model, batch, step


def _nbest_of(model, batch, fn):
    model.eval()
    with torch.no_grad():
        enc = model.encode(batch["feats"])
        return fn(model, enc, model.encoder_out_len(batch["feat_lens"]), BeamConfig(**MBR_BEAM))


def test_mbr_graphed_nbest_after_an_update(cuda_device):
    """After each MBR step (an SGD update of every weight), the captured
    decode loop refreshes its bf16 copy of the prediction net and joint: its
    graphed N-best equals the eager loop's on the updated model, and the
    N-best of the first step's weights is not reused."""
    model, batch, step = _mbr_case(cuda_device)
    before = _nbest_of(model, batch, beam_search)
    for _ in range(2):
        step(batch, torch.Generator(cuda_device).manual_seed(0))
        graphed = _nbest_of(model, batch, beam_search)
        _assert_same_nbest(graphed, _nbest_of(model, batch, beam_search_eager))
    assert len(model._decode_loops) == 1
    loop = next(iter(model._decode_loops.values()))
    assert torch.equal(loop.net.fc2.weight, model.fc2.weight.to(torch.bfloat16))
    assert not torch.equal(before["scores"], graphed["scores"])


def test_mbr_step_on_kernels_matches_plain_backend(cuda_device):
    """The MBR objective and its gradients with K1-K3 against the plain loss
    backend on one N-best, at the recipe's rnnt_scale 0.02.  The references
    are the top hypotheses with their first token replaced, so that the K
    hypotheses' edit distances differ and the surrogate carries a real
    share of the gradient (checked).  The objective and the RNN-T term to
    1e-5 relative; each parameter's gradient to 1e-2 relative L2, except
    those whose reference gradient is zero to rounding: its largest entry
    below ZERO_GRAD of the whole gradient's.  The encoder's key biases are
    such leaves: softmax ignores them, and what is left of their gradient is
    the rounding of the attention's bf16 probability gradients (3.8e-5 of
    the largest entry on the card, 5e-5 on the CPU, also with the rest of
    the model in float64; the least real leaf above 2e-3).
    On the kernels such a leaf must be zero to rounding by the same rule:
    its difference held to ZERO_GRAD of the largest entry, absolute.  K1,
    K2 and K3 launched once each."""
    from pika_tpu_torch.train.mbr import mbr_losses, mbr_risk

    model, batch, _ = _mbr_case(cuda_device)
    nbest = _nbest_of(model, batch, beam_search)
    labels = nbest["tokens"][:, 0].long()
    labels[:, 0] = labels[:, 0] % (DECODE_MODEL["vocab_size"] - 1) + 1
    batch["labels"], batch["label_lens"] = labels, nbest["lens"][:, 0].clone()
    seq_grad = mbr_risk(nbest, batch["labels"], batch["label_lens"])[2]
    assert seq_grad.abs().max() > 1e-2, seq_grad

    def grads(backend, rnnt_scale):
        model.train()
        model.zero_grad(set_to_none=True)
        for fn in (joint_channels, joint_channels_bwd_in, joint_channels_bwd_w):
            fn.launches = 0
        total, metrics = mbr_losses(model, batch["feats"], batch["feat_lens"], batch["labels"],
                                    batch["label_lens"], nbest, rnnt_scale, 1.2,
                                    loss_backend=backend)
        total.backward()
        return (total.item(), metrics["rnnt_loss"].item(),
                {n: p.grad.clone() for n, p in model.named_parameters()},
                [fn.launches for fn in (joint_channels, joint_channels_bwd_in,
                                        joint_channels_bwd_w)])

    (t_k, r_k, g_k, n_k), (t_p, r_p, g_p, n_p) = grads("auto", 0.02), grads("plain", 0.02)
    surrogate = grads("auto", 0.0)[2]
    assert n_k == [1, 1, 1] and n_p == [0, 0, 0]
    assert abs(t_k - t_p) <= 1e-5 * abs(t_p) and abs(r_k - r_p) <= 1e-5 * abs(r_p)
    whole = torch.cat([g.flatten() for g in g_p.values()])
    share = torch.cat([g.flatten() for g in surrogate.values()]).norm() / whole.norm()
    print(f"MBR card case: surrogate's share of the gradient's norm {share.item():.3f}, "
          f"objective {t_k} vs {t_p}, RNN-T term {r_k} vs {r_p}")
    assert share > 0.1
    scale = whole.abs().max().item()
    least = min((g.abs().max().item(), n) for n, g in g_p.items()
                if g.abs().max().item() >= ZERO_GRAD * scale)
    print(f"  the least held leaf: {least[1]} at {least[0] / scale:.2e} of the largest entry")
    failed = []
    for name, ref in g_p.items():
        got = g_k[name]
        if ref.abs().max().item() < ZERO_GRAD * scale:  # zero to rounding
            err, tol, rule = (got - ref).abs().max().item(), ZERO_GRAD * scale, "abs"
        else:
            err, tol, rule = _rel_l2(got, ref), 1e-2, "rel L2"
        print(f"  {name}: {rule} {err:.3e} (tol {tol:.3e}), reference max "
              f"{ref.abs().max().item():.3e}")
        if err > tol:
            failed.append((name, rule, err, tol))
    assert not failed, failed


def test_las_loss_with_ctc_on_card_equals_cpu(cuda_device):
    """``las_loss`` with the CTC auxiliary loss (enc_loss_scale 0.5, label
    sequences that fit their frames) on the card against the CPU: the loss,
    both terms and the gradients to 1e-4 relative.  ``F.ctc_loss`` on the
    card takes ATen's native CUDA route here (int64 targets on the device;
    cuDNN's route needs int32 targets on the host): its log-alpha kernel
    runs, and no cuDNN CTC kernel."""
    from torch.profiler import ProfilerActivity, profile

    from pika_tpu_torch.models.las import LASConfig, init_las
    from pika_tpu_torch.train.las_step import las_loss

    cfg = LASConfig(input_dim=32, output_dim=50, pad_idx=50, rnn_size=64, enc_layers=2,
                    dec_layers=2, embd_dim=16, brnn=True)
    cpu = init_las(cfg, torch.Generator().manual_seed(0), "cpu")
    card = init_las(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda_device)
    g = torch.Generator().manual_seed(1)
    src = torch.randn(3, 40, 32, generator=g)
    src_lens = torch.tensor([40, 31, 24])
    targets = torch.full((3, 9), 50)
    for i, n in enumerate((7, 3, 5)):  # SOS 0, labels in 2..48, EOS 49, then pad
        targets[i, :n + 2] = torch.cat([torch.tensor([0]), torch.randint(2, 49, (n,), generator=g),
                                        torch.tensor([49])])
    results = []
    for model, dev in ((cpu, "cpu"), (card, cuda_device)):
        model.train()
        model.zero_grad(set_to_none=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loss, metrics = las_loss(model, src.to(dev), src_lens.to(dev), targets.to(dev),
                                     enc_loss_scale=0.5)
            loss.backward()
            if model is card:
                torch.cuda.synchronize()
        kernels = sorted({e.key for e in prof.key_averages() if "ctc" in e.key.lower()})
        results.append((loss.item(), metrics["dec_loss"].item(), metrics["enc_loss"].item(),
                        {n: p.grad.cpu() for n, p in model.named_parameters()}, kernels))
    (l_c, d_c, e_c, g_c, _), (l_g, d_g, e_g, g_g, kernels) = results
    print(f"CTC on the card: loss {l_g} vs {l_c} (CPU), CTC term {e_g} vs {e_c}; ops and "
          f"kernels named ctc: {kernels}")
    assert all(np.isfinite([l_c, e_c]))
    for got, ref in ((l_g, l_c), (d_g, d_c), (e_g, e_c)):
        assert abs(got - ref) <= 1e-4 * abs(ref)
    for name, ref in g_c.items():
        assert _rel_l2(g_g[name], ref) <= 1e-4, name
    assert any("ctc_loss_log_alpha" in k for k in kernels), kernels
    assert "aten::_cudnn_ctc_loss" not in kernels, kernels


def test_las_score_hyps_on_card_equals_cpu(cuda_device):
    """Forward and reversed, with coverage and a bidirectional encoder:
    the card (float32, TF32 off) against the CPU to 1e-4 relative."""
    from pika_tpu_torch.decode.rescore import las_score_hyps
    from pika_tpu_torch.models.las import LASConfig, init_las

    cfg = LASConfig(input_dim=32, output_dim=50, pad_idx=50, rnn_size=64, enc_layers=2,
                    dec_layers=2, embd_dim=16, brnn=True, coverage_attn=True)
    cpu = init_las(cfg, torch.Generator().manual_seed(0), "cpu")
    card = init_las(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda_device)
    g = torch.Generator().manual_seed(1)
    enc = torch.randn(2, 30, 32, generator=g)
    enc_lens = torch.tensor([30, 21])
    tokens = torch.randint(1, 49, (2, 4, 9), generator=g)
    lens = torch.tensor([[9, 4, 0, 7], [1, 9, 3, 2]])
    tokens[torch.arange(9)[None, None] >= lens[..., None]] = -1
    for reverse in (False, True):
        ref = las_score_hyps(cpu, enc, enc_lens, tokens, lens, 0, 49, reverse)
        got = las_score_hyps(card, *(x.to(cuda_device) for x in (enc, enc_lens, tokens, lens)),
                             0, 49, reverse)
        for r, x in zip(ref, got):
            torch.testing.assert_close(x.cpu(), r, rtol=1e-4, atol=1e-4)


def _bmuf_rounds(device, variant: str) -> dict:
    """Two BMUF rounds at world size 1 on ``device``: a 4-d quadratic per
    row (the JAX package's BMUF test step), Adam as the local optimizer, a
    statistic averaged at the sync, inside the process group of
    ``device``'s backend (NCCL on the card, gloo on the CPU)."""
    from pika_tpu_torch.parallel import BMUF, BMUFConfig, process_group
    from pika_tpu_torch.train.lr import make_optimizer

    rng = np.random.default_rng(3)
    w0 = rng.standard_normal(4).astype(np.float32)
    rounds = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    with process_group(device):
        w = torch.nn.Parameter(torch.from_numpy(w0).to(device))
        stat = torch.zeros(4, device=device)
        opt = make_optimizer([w], "adam", 0.05, 0.01, 20)
        bmuf = BMUF([w], BMUFConfig(variant, block_momentum=0.5, sync_period=3), buffers=[stat])

        def local_step(rows):
            rows = torch.from_numpy(rows).to(device)
            loss = 0.5 * ((w[None] - rows) ** 2).sum()
            opt.zero_grad()
            loss.backward()
            opt.step()
            with torch.no_grad():
                stat.mul_(0.9).add_(0.1 * rows.mean(0))
            return {"loss": loss.detach()}

        out = []
        for i, rnd in enumerate(rounds):
            ok, metrics = bmuf.round(opt, local_step, list(rnd), 3 * i)
            out.append({"ok": ok, "w": w.detach().cpu().clone(), "stat": stat.cpu().clone(),
                        "loss": metrics["loss"].cpu().clone(),
                        **{k: [x.cpu().clone() for x in v]  # copies: the state moves on
                           for k, v in bmuf.state_dict().items() if isinstance(v, list)}})
    return out


@pytest.mark.parametrize("variant", ["bmuf", "blockadam", "bmufadam"])
def test_bmuf_round_over_nccl_equals_gloo_on_cpu(cuda_device, variant):
    """One BMUF round (two, so the block state carries over) at world size
    1 over NCCL on the card equals the same rounds over gloo on the CPU, to
    rtol 1e-5 and 4 float32 ulps of the largest parameter: the card's Adam
    (its foreach form) and the CPU's round differently, and the delta is a
    difference of two parameters, which is its rounding floor (as in
    ``tests/test_torch_bmuf.py``)."""
    card = _bmuf_rounds(torch.device("cuda", torch.cuda.current_device()), variant)
    cpu = _bmuf_rounds(torch.device("cpu"), variant)
    atol = 4 * torch.finfo(torch.float32).eps * max(cpu[0]["w"].abs().max().item(), 1.0)
    for a, b in zip(card, cpu):
        assert a["ok"] and b["ok"]
        for k in a:
            if k == "ok":
                continue
            for x, y in zip(a[k] if isinstance(a[k], list) else [a[k]],
                            b[k] if isinstance(b[k], list) else [b[k]]):
                torch.testing.assert_close(x, y, rtol=1e-5, atol=atol,
                                           msg=lambda m, k=k: f"{variant} {k}: {m}")


# the transformer prediction net's decode loops: the re-forward of every
# prefix captured in the graph, against the eager loop, bit for bit
TRANSFORMER_MODEL = dict(DECODE_MODEL, decoder_type="transformer", dec_d_model=64, dec_heads=4,
                         dec_d_ff=128)


@pytest.mark.parametrize("mm_dtype", [None, "auto"])
def test_transformer_decoder_graph_matches_eager(cuda_device, mm_dtype):
    model, enc, lens = _decode_case(cuda_device, model_cfg=TRANSFORMER_MODEL)
    cfg = BeamConfig(beam_size=4, n_best=4, max_symbols=12, mm_dtype=mm_dtype)
    graphed = beam_search(model, enc, lens, cfg)
    _assert_same_nbest(graphed, beam_search_eager(model, enc, lens, cfg))
    assert torch.isfinite(graphed["scores"][:, 0]).all()
    for a, b in zip(greedy_decode(model, enc, lens, 12, mm_dtype=mm_dtype),
                    greedy_decode_eager(model, enc, lens, 12, mm_dtype=mm_dtype)):
        assert torch.equal(a, b)
    assert all(loop.graph is not None for loop in model._decode_loops.values())


# ---------------------------------------------------------------------------
# the loss DP's kernels (csrc/rnnt_dp.cu) against the plain row loops
# ---------------------------------------------------------------------------

DP_CASES = {  # (T, U+1, t_len, u_len)
    "ragged": (9, 6, [9, 1, 0, 5], [5, 0, 3, 2]),  # t_len 0 and 1, u_len 0
    "no_labels": (7, 1, [7, 3], [0, 0]),            # U+1 = 1
    "one_frame": (1, 5, [1, 1, 0], [4, 2, 1]),      # T = 1
    "cell": (239, 41, [239, 200, 120, 1], [40, 33, 5, 0]),  # the training cell's T' x (U+1)
    "u97": (60, 97, [60, 37, 2], [96, 50, 0]),       # four warps
    "chunked": (20, 1100, [20, 13], [1099, 700]),   # rows wider than a block: two chunks
}
# the kernels sum the chain in double and round their outputs to float32;
# the loops sum in float32 (G + logcumsumexp(f - G)) and lose ulps of their
# alphas (up to 2,800 nats here) along the chain.  An emulation of the
# kernels on the CPU parted from the loops by up to 8.2e-7 relative in
# alpha, 5.5e-7 in the loss, and 6.7e-5 (the cell) and 4.1e-4 (U+1 = 1100)
# in the cotangents (posteriors times g_loss, |g_loss| <= 1.5): the loops'
# own error, 6-10x the kernels' against a float64 DP
DP_RTOL, DP_ATOL = 1e-5, 1e-4
DP_GRAD_ATOL = 2e-3


def _dp_case(device, t, u1, t_len, u_len, seed=0):
    """Channel log-probs in [-5.1, -0.1] (alphas of a few thousand nats at
    the widest shape), the lengths and a loss cotangent with negative
    weights (MBR's)."""
    g = torch.Generator(device).manual_seed(seed)
    b = len(t_len)
    blank, emit = (-torch.rand((b, t, u1), generator=g, device=device) * 5 - 0.1
                   for _ in range(2))
    return (blank, emit, torch.tensor(t_len, device=device), torch.tensor(u_len, device=device),
            torch.linspace(-0.5, 1.5, b, device=device))


@pytest.mark.parametrize("case", list(DP_CASES))
def test_dp_kernels_match_plain_loops(cuda_device, case):
    """dp_forward and dp_backward (one launch each) against the row loops on
    the card: alpha and the loss on the valid region (DP_RTOL, DP_ATOL; the
    loss of an empty utterance exactly 0), the cotangents everywhere
    (DP_GRAD_ATOL; exact zeros outside the lattice)."""
    t, u1, t_len, u_len = DP_CASES[case]
    blank, emit, tl, ul, g_loss = _dp_case(cuda_device, t, u1, t_len, u_len)
    launches = dp_forward.launches, dp_backward.launches
    loss, alpha = dp_forward(blank, emit, tl, ul)
    grads = dp_backward(blank, emit, tl, ul, alpha, loss, g_loss)
    torch.cuda.synchronize()
    assert (dp_forward.launches, dp_backward.launches) == (launches[0] + 1, launches[1] + 1)
    ref_loss, ref_alpha = dp_forward_reference(blank, emit, tl, ul)
    ref_grads = dp_backward_reference(blank, emit, tl, ul, ref_alpha, ref_loss, g_loss)
    valid = ((torch.arange(t, device=cuda_device)[None, :, None] < tl[:, None, None])
             & (torch.arange(u1, device=cuda_device)[None, None, :] <= ul[:, None, None]))
    torch.testing.assert_close(alpha[valid], ref_alpha[valid], rtol=DP_RTOL, atol=DP_ATOL)
    torch.testing.assert_close(loss, ref_loss, rtol=DP_RTOL, atol=DP_ATOL)
    assert not loss[tl <= 0].any()
    for name, got, ref in zip(("d_zb", "d_zy", "d_lse"), grads, ref_grads):
        torch.testing.assert_close(got, ref, rtol=0, atol=DP_GRAD_ATOL, msg=name)
    assert not grads[0][~valid].any() and not grads[2][~valid].any()
    assert torch.equal(grads[2], -(grads[0] + grads[1]))


def test_dp_kernels_rerun_bit_identical(cuda_device):
    """One block per utterance and no atomics: two launches of each kernel
    give the same bits."""
    blank, emit, tl, ul, g_loss = _dp_case(cuda_device, *DP_CASES["cell"], seed=1)
    runs = []
    for _ in range(2):
        loss, alpha = dp_forward(blank, emit, tl, ul)
        runs.append((loss, alpha, *dp_backward(blank, emit, tl, ul, alpha, loss, g_loss)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_dp_kernels_reject_bad_inputs(cuda_device):
    blank, emit, tl, ul, g_loss = _dp_case(cuda_device, *DP_CASES["ragged"])
    with pytest.raises(ValueError, match="emit_lp"):
        dp_forward(blank, emit.double(), tl, ul)
    with pytest.raises(ValueError, match="contiguous"):
        dp_forward(blank, emit.transpose(1, 2).contiguous().transpose(1, 2), tl, ul)
    with pytest.raises(ValueError, match="t_len"):
        dp_forward(blank, emit, tl.cpu(), ul)
    loss, alpha = dp_forward(blank, emit, tl, ul)
    with pytest.raises(ValueError, match="g_loss"):
        dp_backward(blank, emit, tl, ul, alpha, loss, g_loss[:2])


def test_train_step_launches_each_dp_kernel_once(cuda_device):
    """One "auto" training step (the grammar recipe's model, full loss)
    launches each of K1, K2, K3 and the two DP kernels once."""
    counted = (joint_channels, joint_channels_bwd_in, joint_channels_bwd_w, dp_forward,
               dp_backward)
    for fn in counted:
        fn.launches = 0
    losses, _ = _seeded_training(cuda_device, "recipe", steps=1)
    assert np.isfinite(losses).all()
    assert [fn.launches for fn in counted] == [1] * 5


# the pruned loss on the card: with the full band it is the fused loss, whose
# kernels round h, W2 and dz to bf16 (the pruned loss is float32): within
# BASELINE.md's bf16 envelope
def test_full_band_pruned_loss_matches_kernels(cuda_device):
    ax, gx, ay, gy, w2, b2, labels_ext = _case(cuda_device, 3, 20, 8, 32, 70, seed=2)
    labels = labels_ext[:, :-1].clamp(min=1)
    t_len = torch.tensor([20, 11, 6], device=cuda_device)
    u_len = torch.tensor([7, 4, 2], device=cuda_device)
    f1 = [x.clone().requires_grad_() for x in (ax, gx, ay, gy, w2, b2)]
    f2 = [x.clone().requires_grad_() for x in (ax, gx, ay, gy, w2, b2)]
    got = rnnt_loss_pruned(*f1, labels, t_len, u_len,
                           torch.zeros(3, 20, dtype=torch.long, device=cuda_device), 8, chunk=7)
    ref = rnnt_loss_fused(*f2, labels, t_len, u_len)
    got.sum().backward()
    ref.sum().backward()
    assert _rel_l2(got.detach(), ref.detach()) <= ENVELOPE
    for name, a, b in zip(GRAD_NAMES, f1, f2):
        assert _rel_l2(a.grad, b.grad) <= ENVELOPE, name


def _band_mass(blank_lp, emit_lp, t_len, u_len, sb, s_range):
    """Each utterance's posterior mass inside its band (float64, CPU)."""
    g_blank, g_emit = rnnt_occupancy(blank_lp, emit_lp, t_len, u_len)
    u = torch.arange(blank_lp.shape[2])
    band = (u >= sb[..., None]) & (u < sb[..., None] + s_range)
    return (-(g_blank + g_emit).double() * band).sum(dim=(1, 2))


@pytest.mark.parametrize("s_range", [3, 5])
def test_prune_ranges_on_card_equals_cpu(cuda_device, s_range):
    """The card's band starts equal the CPU's on every utterance but those
    whose two bands hold the same posterior mass to float32 rounding (a
    tie between windows); both meet the first-frame and cap invariants."""
    g = torch.Generator().manual_seed(4)
    b, t, u, v = 16, 60, 12, 40
    am, lm = torch.randn(b, t, v, generator=g) * 2, torch.randn(b, u + 1, v, generator=g) * 2
    labels = torch.randint(1, v, (b, u), generator=g)
    t_len = torch.randint(u // 2, t + 1, (b,), generator=g)
    u_len = torch.randint(0, u + 1, (b,), generator=g)
    blank_lp, emit_lp = simple_channels(am, lm, labels)
    cpu = prune_ranges(blank_lp, emit_lp, t_len, u_len, s_range)
    card = prune_ranges(*(x.to(cuda_device) for x in (blank_lp, emit_lp, t_len, u_len)),
                        s_range).cpu()
    for sb in (cpu, card):
        assert (sb[:, 0] == 0).all() and (sb.diff(dim=1) >= 0).all()
        assert (sb <= (u_len + 1 - s_range).clamp(min=0)[:, None]).all()
    differ = (card != cpu).any(dim=1)
    mass = _band_mass(blank_lp, emit_lp, t_len, u_len, card, s_range)
    mass_ref = _band_mass(blank_lp, emit_lp, t_len, u_len, cpu, s_range)
    assert ((mass - mass_ref).abs()[differ] <= 1e-5 * mass_ref.abs().clamp(min=1.0)[differ]).all()
    assert int(differ.sum()) < b // 2


# ---------------------------------------------------------------------------
# The LSTM's fused route (cuDNN) against its loop over frames
# ---------------------------------------------------------------------------

def _lstm_run(mod, route, x, lengths, cots, generator=None, initial_state=None):
    mod.zero_grad()
    xr = x.clone().requires_grad_()
    out, (h, c) = getattr(mod, route)(xr, generator, lengths, initial_state)
    sum((v * w).sum() for v, w in zip((out, h, c), cots)).backward()
    return {"out": out.detach(), "h": h.detach(), "c": c.detach(), "dx": xr.grad,
            **{f"d{k}": p.grad.clone() for k, p in mod.named_parameters()}}


def _lstm_case(device, b, t, d, h, layers, lengths, dropout=0.0):
    g = torch.Generator().manual_seed(b * t + layers)
    mod = LSTM(d, h, layers, dropout=dropout, bidirectional=True, device=device)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) / (h // 2) ** 0.5)
    x = torch.randn(b, t, d, generator=g).to(device)
    cots = [torch.randn(b, t, h, generator=g).to(device),
            *[torch.randn(layers * 2, b, h // 2, generator=g).to(device) for _ in range(2)]]
    return mod, x, torch.tensor(lengths, device=device), cots


def _rel_l2(got, ref) -> float:
    return float((got.double() - ref.double()).norm() / ref.double().norm().clamp(min=1e-30))


@pytest.mark.parametrize("train", [False, True])
def test_lstm_fused_route_equals_the_loop(cuda_device, train):
    """Masked, bidirectional, ragged (full, 1 and lengths between, unsorted):
    outputs, final states and every gradient to 1e-5 relative L2 at float32;
    in train mode dropout between the layers draws the same masks from the
    same generator."""
    torch.backends.cudnn.allow_tf32 = False
    mod, x, lengths, cots = _lstm_case(cuda_device, 6, 50, 24, 32, 3,
                                       [50, 1, 37, 12, 50, 29], dropout=0.3)
    mod.train(train)
    runs = [_lstm_run(mod, route, x, lengths, cots,
                      torch.Generator(cuda_device).manual_seed(2) if train else None)
            for route in ("forward", "forward_loop")]
    for k in runs[1]:
        assert _rel_l2(runs[0][k], runs[1][k]) <= 1e-5, k
    assert not runs[0]["out"][1, 1:].any() and not runs[0]["out"][3, 12:].any()


def test_lstm_fused_route_keeps_an_empty_row_as_the_loop_does(cuda_device):
    """A length of 0 (which a packed sequence cannot hold): zero outputs, the
    initial state as the final state, and the loop's gradients."""
    torch.backends.cudnn.allow_tf32 = False
    mod, x, lengths, cots = _lstm_case(cuda_device, 3, 9, 5, 8, 2, [9, 0, 4])
    g = torch.Generator().manual_seed(5)
    state = tuple(torch.randn(4, 3, 4, generator=g).to(cuda_device) for _ in range(2))
    fused, loop = (_lstm_run(mod, route, x, lengths, cots, initial_state=state)
                   for route in ("forward", "forward_loop"))
    assert not fused["out"][1].any()
    assert torch.equal(fused["h"][:, 1], state[0][:, 1])
    assert torch.equal(fused["c"][:, 1], state[1][:, 1])
    for k in loop:
        assert _rel_l2(fused[k], loop[k]) <= 1e-5, k


def test_lstm_fused_route_takes_the_matmuls_precision(cuda_device):
    """cuDNN's own TF32 flag left on (PyTorch's default) and the matmuls'
    off: the fused route still runs its products, forward and backward, in
    float32 and meets the loop to 1e-5 relative L2 at a width where TF32
    would miss it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        mod, x, lengths, cots = _lstm_case(cuda_device, 8, 120, 120, 512, 2,
                                           [120, 1, 77, 120, 30, 64, 119, 5])
        fused, loop = (_lstm_run(mod, route, x, lengths, cots)
                       for route in ("forward", "forward_loop"))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    for k in loop:
        assert _rel_l2(fused[k], loop[k]) <= 1e-5, k


# the prediction net's form (unidirectional, unmasked, no initial state) at
# (batch, U+1, embedding, hidden, layers): the grammar recipe's
# (egs/mini_grammar.sh: --embd_dim 64, --rnn_size 256, --dec_layers 1; the
# label bucket 17) and the flagship's (embedding 100, H 1024, 2 layers, 40
# labels)
PREDICTION_NETS = {"recipe": (16, 18, 64, 256, 1), "flagship": (32, 41, 100, 1024, 2)}


@pytest.mark.parametrize("shape", sorted(PREDICTION_NETS))
def test_lstm_prediction_net_route_equals_the_loop(cuda_device, shape):
    """Train mode with cuDNN's TF32 flag left on, as the CLIs leave it: the
    fused route's outputs, final states and the gradients of the input and
    of every parameter to 1e-5 relative L2 of the loop's."""
    b, t, d, h, layers = PREDICTION_NETS[shape]
    g = torch.Generator().manual_seed(t)
    mod = LSTM(d, h, layers, device=cuda_device).train()
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) / h ** 0.5)
    x = torch.randn(b, t, d, generator=g).to(cuda_device)
    cots = [torch.randn(b, t, h, generator=g).to(cuda_device),
            *[torch.randn(layers, b, h, generator=g).to(cuda_device) for _ in range(2)]]
    torch.backends.cudnn.allow_tf32 = True
    try:
        fused, loop = (_lstm_run(mod, route, x, None, cots)
                       for route in ("forward", "forward_loop"))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert set(fused) == set(loop) and len(loop) == 4 + 3 * layers
    for k in loop:
        assert _rel_l2(fused[k], loop[k]) <= 1e-5, k


def test_gather_rows_backward_repeats_and_is_the_segment_sum(cuda_device):
    """The flagship band's rows of ay (B 32, U+1 41, H 1024; each row read by
    about 29 cells): the backward twice gives equal bits, and each row is
    the float64 sum of its cells' cotangents to float32 rounding."""
    g = torch.Generator().manual_seed(3)
    b, u1, h, cells = 32, 41, 1024, 239 * 5
    table = torch.randn(b * u1, h, generator=g).to(cuda_device)
    flat = torch.randint(0, u1, (b, cells), generator=g).sort(dim=1).values
    index = (torch.arange(b)[:, None] * u1 + flat).reshape(-1).to(cuda_device)
    cot = torch.randn(b * cells, h, generator=g).to(cuda_device)
    grads = []
    for _ in range(2):
        leaf = table.clone().requires_grad_()
        out = gather_rows(leaf, index)
        assert torch.equal(out, table[index])
        out.backward(cot)
        grads.append(leaf.grad)
    assert torch.equal(grads[0], grads[1])
    ref = torch.zeros(b * u1, h, dtype=torch.float64, device=cuda_device)
    ref.index_add_(0, index, cot.double())
    mag = torch.zeros_like(ref).index_add_(0, index, cot.double().abs())
    count = torch.bincount(index, minlength=b * u1).double()[:, None]
    assert ((grads[0].double() - ref).abs() <= count * 2.0 ** -24 * mag + 1e-30).all()


# the pruned training's shapes: the flagship (bench.py's batch of 32 x 10 s,
# 40 labels of 6268; sgd) and the grammar recipe's acoustic model
# (egs/mini_grammar.sh: 40 mel bins, tdnn_nhid 256, rnn_size 256, 31 outputs,
# dropout 0.1; batch 16 of up to 4 s and 17 labels; adam)
PRUNED_TRAININGS = {
    "flagship": dict(model=dict(input_dim=240, vocab_size=6268, hid_dim=1024, embd_dim=100,
                                dec_layers=2, tdnn_nhid=1024),
                     mel=80, batch=32, seconds=10.0, labels=40,
                     optim=dict(optim="sgd", initial_lr=0.003, final_lr=0.0001,
                                total_batches=100000, momentum=0.9, grad_clip=3.0)),
    "recipe": dict(model=dict(input_dim=120, vocab_size=31, hid_dim=256, embd_dim=64,
                              dec_layers=1, tdnn_nhid=256, dropout=0.1,
                              tdnn_transformer_dropout=0.1),
                   mel=40, batch=16, seconds=4.0, labels=17,
                   optim=dict(optim="adam", initial_lr=0.001, final_lr=0.0008,
                              total_batches=1880, momentum=0.9, grad_clip=3.0)),
}


def _seeded_training(device, shape: str, steps: int = 3, **step_kw):
    """``steps`` training steps (``step_kw`` to ``make_train_step``: the
    pruned objective's arguments) from seed 0 on a seeded batch of noise
    with ragged lengths: the losses and the model's state."""
    cfg = PRUNED_TRAININGS[shape]
    rng = np.random.default_rng(0)
    n = int(16000 * cfg["seconds"])
    b, u = cfg["batch"], cfg["labels"]
    wav_lens = np.concatenate([[n], rng.integers(n // 2, n + 1, b - 1)]).astype(np.int32)
    label_lens = np.concatenate([[u], rng.integers(u // 2, u + 1, b - 1)]).astype(np.int32)
    vocab = cfg["model"]["vocab_size"]
    batch = {"wavs": torch.from_numpy((rng.standard_normal((b, n)) * 4000).astype(np.float32)),
             "wav_lens": torch.from_numpy(wav_lens),
             "labels": torch.from_numpy(rng.integers(1, vocab, (b, u)).astype(np.int32)),
             "label_lens": torch.from_numpy(label_lens)}
    batch = {k: v.to(device) for k, v in batch.items()}
    model = init_transducer(TransducerConfig(encoder_type="tdnn_transformer", decoder_type="rnn",
                                             enc_layers=9, tdnn_layers=9, simple_joint=True,
                                             **cfg["model"]),
                            torch.Generator(device).manual_seed(0), device)
    fbank = dict(sample_frequency=16000, window_type="hamming", low_freq=40.0,
                 high_freq=-200.0, num_mel_bins=cfg["mel"])
    feat_cfg = dict(max_samples=n, lctx=1, rctx=1)
    with torch.no_grad():
        plain = make_featurizer(FeaturizerConfig(fbank=FbankConfig(dither=0.0, **fbank),
                                                 **feat_cfg), device=device)
        feats, _ = plain(batch["wavs"], batch["wav_lens"])
        frames = feats.reshape(-1, feats.shape[-1])
        offset, scale = -frames.mean(0), 1.0 / frames.std(0)
    featurizer = make_featurizer(FeaturizerConfig(fbank=FbankConfig(dither=1.0, **fbank),
                                                  spec_augment=True, **feat_cfg),
                                 offset, scale, device=device)
    step = make_train_step(model, make_optimizer(model.parameters(), **cfg["optim"]), featurizer,
                           **step_kw)
    gen = torch.Generator(device).manual_seed(1)
    losses = [step(batch, gen)["loss"].item() for _ in range(steps)]
    return losses, {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("shape", sorted(PRUNED_TRAININGS))
def test_pruned_training_repeats_bit_for_bit(cuda_device, shape):
    """Three pruned steps run twice from the same seeds give the same losses
    and the same parameters and BatchNorm statistics, bit for bit (the
    band's and the simple joint's gathers sum their gradients in a fixed
    order), with cuDNN's TF32 flag left on, as the CLIs leave it."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        (losses, state), (losses2, state2) = (
            _seeded_training(cuda_device, shape, pruned_range=5, simple_scale=0.5)
            for _ in range(2))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert all(np.isfinite(losses)) and losses == losses2
    assert set(state) == set(state2)
    assert [k for k in state if not torch.equal(state[k], state2[k])] == []
