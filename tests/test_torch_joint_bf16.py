"""K1 and K2's plain versions at the TPU kernels' bf16 rounding, against the
JAX package's Pallas kernels run in interpret mode at ``mm_dtype=bf16``; the
CPU paths of the wrappers and of the plain loss backend (float32, bit for
bit); K4's zero-padding of other head widths; the chunk schedule that K1, K2
and K3 share.  The kernels themselves run only on the card:
tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pika_tpu.ops.rnnt_loss import _chunk_channels
from pika_tpu.ops.rnnt_pallas import joint_channels_pallas, joint_channels_pallas_bwd
from pika_tpu_torch.ops.flash_attention import FlashAttention, pad_head
from pika_tpu_torch.ops.rnnt_kernels import (
    DZ_SCRATCH_BYTES,
    T_TILE,
    chunk_bounds,
    chunk_tiles,
    joint_channels,
    joint_channels_bwd_in,
    joint_channels_bwd_reference,
    joint_channels_reference,
    pad64,
)
from pika_tpu_torch.ops.rnnt_loss import plain_mm_dtype, rnnt_loss_fused

torch.set_num_threads(1)

GRADS = ("d_ax", "d_gx", "d_ay", "d_gy")
# K1's plain version and the Pallas kernel round the same h and W2 to bf16
# and sum the same products in float32 in another order
K1_BF16_TOL = 1e-5
# with one V tile the Pallas backward differs from the plain version only by
# its one bf16 rounding of dh (at most 2^-9 of each entry, 1.1e-3 RMS)
# before the derivatives; the sums over u or t cancel part of the gradient
# but not of that error, so the gradients move by up to twice it (measured
# 1.2e-3 to 2.7e-3 relative L2 over three seeds of these shapes)
DH_ROUNDING = 2.0 ** -8


def _factors(rng, b, t, u1, h, v, label0=False):
    """Joint factors, W2 scaled as the model initializes it (z of a few
    units), and labels_ext (the last column the blank); numpy."""
    arrays = [rng.standard_normal(s).astype(np.float32) * 0.5
              for s in ((b, t, h), (b, t, h), (b, u1, h), (b, u1, h))]
    arrays += [(rng.standard_normal((h, v)) * 2 / np.sqrt(h)).astype(np.float32),
               (rng.standard_normal(v) * 0.1).astype(np.float32)]
    labels = np.zeros((b, u1), np.int32) if label0 else rng.integers(1, v, (b, u1)).astype(np.int32)
    labels[:, -1] = 0
    return arrays + [labels]


def _bwd_case(rng, b, t, u1, h, v, label0=False):
    """The factors, K1's lse (the JAX reference at float32) and random
    channel cotangents; numpy."""
    arrays = _factors(rng, b, t, u1, h, v, label0)
    lse = np.array(_chunk_channels(*map(jnp.asarray, arrays))[0])
    cots = [(rng.standard_normal(lse.shape) * 0.1).astype(np.float32) for _ in range(3)]
    return arrays + [lse] + cots


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


@pytest.mark.parametrize("shape,label0", [((2, 13, 5, 24, 37), False), ((1, 9, 4, 16, 45), True),
                                          ((2, 20, 6, 32, 301), False), ((1, 1, 1, 8, 3), True)])
def test_k1_bf16_reference_matches_pallas_interpret(rng, shape, label0):
    """K1's plain version at bf16 against _fwd_kernel at mm_dtype=bf16 in
    interpret mode: ragged V (37, 45, 301, 3: not multiples of 8 or of the
    Pallas V tile), labels all 0 (z_label is z_blank)."""
    args = _factors(rng, *shape, label0=label0)
    ref = joint_channels_pallas(*map(jnp.asarray, args), mm_dtype=jnp.bfloat16,
                                block_t=8, block_u=2, block_v=16)
    got = joint_channels_reference(*map(torch.from_numpy, args), chunk=4,
                                   mm_dtype=torch.bfloat16)
    for name, r, g in zip(("lse", "z_blank", "z_label"), ref, got):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), r, rtol=K1_BF16_TOL, atol=K1_BF16_TOL, err_msg=name)
    if label0:
        assert torch.equal(got[1], got[2])


def test_k1_bf16_reference_is_not_the_f32_one(rng):
    args = list(map(torch.from_numpy, _factors(rng, 2, 20, 6, 32, 301)))
    bf16 = joint_channels_reference(*args, mm_dtype=torch.bfloat16)
    f32 = joint_channels_reference(*args)
    errs = [(a - b).abs().max().item() for a, b in zip(bf16, f32)]
    assert 1e-5 < max(errs) <= 2e-2, errs


@pytest.mark.parametrize("shape,label0", [((2, 13, 5, 24, 37), False), ((1, 9, 4, 16, 45), True),
                                          ((2, 20, 6, 32, 61), False)])
def test_k2_bf16_reference_matches_pallas_one_v_tile(rng, shape, label0):
    """K2's four gradients of the bf16 plain version against _bwd_in_kernel
    at mm_dtype=bf16 in interpret mode with block_v >= V: the only
    difference is the TPU kernel's one bf16 rounding of dh, so each
    gradient is within DH_ROUNDING relative L2 (where the float32 plain
    version is 2e-3 to 4e-3 away)."""
    args = _bwd_case(rng, *shape, label0=label0)
    ref = joint_channels_pallas_bwd(*map(jnp.asarray, args), mm_dtype=jnp.bfloat16,
                                    block_t=8, block_u=2, block_v=pad64(shape[-1]))[:4]
    got = joint_channels_bwd_reference(*map(torch.from_numpy, args), chunk=4,
                                       mm_dtype=torch.bfloat16)[:4]
    for name, r, g in zip(GRADS, ref, got):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == torch.float32, name
        assert _rel_l2(g, r) <= DH_ROUNDING, (name, _rel_l2(g, r))


def test_k2_bf16_reference_is_closer_to_pallas_than_f32(rng):
    """With several V tiles (the TPU kernel rounds its running dh to bf16
    after each of the 19 tiles of 16 columns) the bf16 plain version is
    still closer to the Pallas kernel at bf16 than the float32 one is."""
    args = _bwd_case(rng, 2, 20, 6, 32, 301)
    ref = joint_channels_pallas_bwd(*map(jnp.asarray, args), mm_dtype=jnp.bfloat16,
                                    block_t=8, block_u=2, block_v=16)[:4]
    pt = list(map(torch.from_numpy, args))
    bf16 = joint_channels_bwd_reference(*pt, chunk=4, mm_dtype=torch.bfloat16)[:4]
    f32 = joint_channels_bwd_reference(*pt, chunk=4)[:4]
    for name, r, b, f in zip(GRADS, ref, bf16, f32):
        assert _rel_l2(b, r) < _rel_l2(f, r), (name, _rel_l2(b, r), _rel_l2(f, r))


def test_bf16_reference_does_not_depend_on_the_chunk(rng):
    pt = list(map(torch.from_numpy, _bwd_case(rng, 2, 11, 4, 16, 29)))
    one = joint_channels_bwd_reference(*pt, chunk=1, mm_dtype=torch.bfloat16)
    all_t = joint_channels_bwd_reference(*pt, chunk=11, mm_dtype=torch.bfloat16)
    for a, b in zip(one, all_t):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_reference_rejects_other_dtypes(rng):
    pt = list(map(torch.from_numpy, _bwd_case(rng, 1, 3, 2, 8, 5)))
    with pytest.raises(ValueError, match="mm_dtype"):
        joint_channels_reference(*pt[:7], mm_dtype=torch.float16)
    with pytest.raises(ValueError, match="mm_dtype"):
        joint_channels_bwd_reference(*pt, mm_dtype=torch.float16)


def test_cpu_wrappers_stay_float32(rng):
    """On CPU tensors K1's and K2's wrappers are the float32 plain versions,
    bit for bit (the CPU parity with the JAX package's XLA backend rests on
    it)."""
    pt = list(map(torch.from_numpy, _bwd_case(rng, 2, 9, 5, 16, 37)))
    for got, ref in zip(joint_channels(*pt[:7]), joint_channels_reference(*pt[:7])):
        assert torch.equal(got, ref)
    for got, ref in zip(joint_channels_bwd_in(*pt), joint_channels_bwd_reference(*pt)[:4]):
        assert torch.equal(got, ref)


def test_plain_backend_follows_the_device(rng):
    """The plain loss backend computes the kernels' function on each
    device: float32 on CPU tensors (its loss and gradients those of the
    float32 plain versions, bit for bit), bf16 on the card."""
    assert plain_mm_dtype(torch.device("cpu")) == torch.float32
    assert plain_mm_dtype(torch.device("cuda", 0)) == torch.bfloat16
    ax, gx, ay, gy, w2, b2, labels_ext = map(torch.from_numpy, _factors(rng, 2, 11, 5, 16, 29))
    labels = labels_ext[:, :-1].clamp(min=1)
    t_len, u_len = torch.tensor([11, 7]), torch.tensor([4, 2])
    out = {}
    for backend in ("auto", "plain"):
        leaves = [x.clone().requires_grad_() for x in (ax, gx, ay, gy, w2, b2)]
        loss = rnnt_loss_fused(*leaves, labels, t_len, u_len, 32, backend)
        loss.sum().backward()
        out[backend] = [loss.detach()] + [x.grad for x in leaves]
    for a, b in zip(out["auto"], out["plain"]):
        assert torch.equal(a, b)


def _k4_case(rng, b, h, t, d):
    arrays = [rng.standard_normal((b, h, t, d)).astype(np.float32) * scale
              for scale in (2.0 / np.sqrt(d), 1.0, 1.0, 1.0)]
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


@pytest.mark.parametrize("d", [16, 32, 96])
def test_k4_padding_is_exact(rng, d):
    """The plain K4 on q, k, v zero-padded along d to 64 or 128, its output
    sliced back, against the plain K4 at the true d: the forward and the
    three gradients agree to float32 summation order (bf16 results, one
    bf16 step of the largest entry at most) -- what the card runs for d not
    in HEAD_DIMS."""
    q, k, v, do = _k4_case(rng, 2, 3, 37, d)
    out = {}
    for padded in (True, False):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = pad_head(FlashAttention.apply, *leaves) if padded else FlashAttention.apply(*leaves)
        o.backward(do)
        out[padded] = [o.detach()] + [x.grad for x in leaves]
    for name, a, b in zip(("o", "dq", "dk", "dv"), out[True], out[False]):
        assert a.shape == b.shape == (2, 3, 37, d) and a.dtype == torch.bfloat16, name
        a, b = a.float(), b.float()
        assert (a - b).abs().max().item() <= 2 ** -7 * b.abs().max().item(), name
        assert _rel_l2(a, b) <= 1e-3, name


def test_chunks_are_whole_tile_runs():
    """Chunks tile the (b, t) rows in order, each starting on a 16-frame
    tile of one utterance; the last tile of an utterance is ragged."""
    b, t = 3, 37
    for tiles in (1, 2, 4, 100):
        chunks = chunk_bounds(b, t, 5, 301, tiles)
        assert chunks[0][0] == 0 and chunks[-1][1] == b * t
        assert all(c1 == n0 for (_, c1), (n0, _) in zip(chunks, chunks[1:]))
        assert all(bt0 % t % T_TILE == 0 for bt0, _ in chunks)
        assert len(chunks) == -(-b * 3 // tiles)  # 3 tiles of 16 frames an utterance
    assert chunk_bounds(3, 37, 5, 301, 2)[:3] == [(0, 32), (32, 53), (53, 74)]


def test_chunks_at_the_flagship_shapes():
    """At V = 6268: the training lattice (B = 32, T' = 239, U+1 = 41) takes
    8 chunks, each within the 512 MiB dz scratch; at 60 s (T' = 1489, U+1 =
    241) a chunk is a part of one utterance."""
    rows = [(bt1 - bt0) * 41 for bt0, bt1 in chunk_bounds(32, 239, 41, 6268)]
    assert len(rows) == 8 and sum(rows) == 32 * 239 * 41
    assert max(rows) * pad64(6268) * 2 <= DZ_SCRATCH_BYTES
    long = chunk_bounds(4, 1489, 241, 6268)
    assert all(bt1 - bt0 < 1489 for bt0, bt1 in long)
    assert long[0][1] < 1489 and len(long) >= 4 * 1489 // (long[0][1] - long[0][0])
    assert chunk_tiles(241, 6268) * T_TILE * 241 * pad64(6268) * 2 <= DZ_SCRATCH_BYTES
