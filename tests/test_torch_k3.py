"""K3's plain version at the TPU kernel's bf16 rounding, against the JAX
package's Pallas backward run in interpret mode at its default
``mm_dtype=bf16``; the CPU path of K3's wrapper; the pure-Python helpers of
K3's launcher.  K3 itself runs only on the card: tests/test_torch_gpu.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pika_tpu.ops.rnnt_loss import _chunk_channels
from pika_tpu.ops.rnnt_pallas import joint_channels_pallas_bwd
from pika_tpu_torch.ops.rnnt_kernels import (
    DZ_SCRATCH_BYTES,
    T_TILE,
    chunk_bounds,
    chunk_tiles,
    joint_channels_bwd_reference,
    joint_channels_bwd_w,
    joint_channels_bwd_w_reference,
    pad64,
)

torch.set_num_threads(1)

# Both sides round h, W2 and dz to bf16 at the same points and multiply the
# rounded values with float32 sums: they differ by the order of those sums
# (and could by a rare one-ulp flip of bf16(dz)), measured at 3.4e-07 at
# most; the float32 function is 1e-3 to 4e-3 away at these shapes.
BF16_REL = 1e-5
# BASELINE.md's measured envelope of the TPU kernels' bf16 rounding against
# true float32 gradients at flagship scale
ENVELOPE = 6.4e-3


def _case(rng, b, t, u1, h, v, label0=False):
    """Joint factors (W2 scaled as the model initializes it: z of a few
    units), K1's lse from the JAX reference and random channel cotangents;
    numpy arrays."""
    arrays = [rng.standard_normal(s).astype(np.float32) * 0.5
              for s in ((b, t, h), (b, t, h), (b, u1, h), (b, u1, h))]
    arrays += [(rng.standard_normal((h, v)) * 2 / np.sqrt(h)).astype(np.float32),
               (rng.standard_normal(v) * 0.1).astype(np.float32)]
    labels = np.zeros((b, u1), np.int32) if label0 else rng.integers(1, v, (b, u1)).astype(np.int32)
    labels[:, -1] = 0  # the column past the last label is the blank, as in labels_ext
    arrays.append(labels)
    lse = np.array(_chunk_channels(*map(jnp.asarray, arrays))[0])
    cots = [(rng.standard_normal(lse.shape) * 0.1).astype(np.float32) for _ in range(3)]
    return arrays + [lse] + cots


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


@pytest.mark.parametrize("shape,label0", [((2, 13, 5, 24, 37), False), ((1, 9, 4, 16, 45), True),
                                          ((2, 20, 6, 32, 301), False), ((1, 1, 1, 8, 3), True)])
def test_bf16_reference_matches_pallas_interpret(rng, shape, label0):
    """d_w2 and d_b2 of the bf16 plain version against _bwd_w_kernel at
    mm_dtype=bf16 in interpret mode: ragged shapes (V = 37, 45, 301, 3: not
    multiples of 8 or of the Pallas V tile), and labels all 0 (the blank and
    label cotangents land on one column)."""
    args = _case(rng, *shape, label0=label0)
    ref = joint_channels_pallas_bwd(*map(jnp.asarray, args), mm_dtype=jnp.bfloat16,
                                    block_t=8, block_u=2, block_v=16)[4:]
    got = joint_channels_bwd_w_reference(*map(torch.from_numpy, args), chunk=4,
                                         mm_dtype=torch.bfloat16)
    for name, r, g in zip(("d_w2", "d_b2"), ref, got):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == torch.float32, name
        assert _rel_l2(g, r) <= BF16_REL, (name, _rel_l2(g, r))
        assert np.abs(g.numpy() - r).max() <= BF16_REL * np.abs(r).max(), name


def test_bf16_reference_is_not_the_f32_one(rng):
    """The bf16 rounding moves d_w2 by more than float32 summation order
    would, and stays inside the TPU kernels' envelope against float32."""
    args = list(map(torch.from_numpy, _case(rng, 2, 20, 6, 32, 301)))
    bf16 = joint_channels_bwd_w_reference(*args, mm_dtype=torch.bfloat16)
    f32 = joint_channels_bwd_w_reference(*args)
    assert 1e-4 < _rel_l2(bf16[0], f32[0]) <= ENVELOPE
    assert _rel_l2(bf16[1], f32[1]) <= ENVELOPE


def test_bf16_reference_does_not_depend_on_the_chunk(rng):
    args = list(map(torch.from_numpy, _case(rng, 2, 11, 4, 16, 29)))
    one = joint_channels_bwd_w_reference(*args, chunk=1, mm_dtype=torch.bfloat16)
    all_t = joint_channels_bwd_w_reference(*args, chunk=11, mm_dtype=torch.bfloat16)
    for a, b in zip(one, all_t):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_cpu_wrapper_returns_the_f32_plain_version(rng):
    """On CPU tensors K3's wrapper is the float32 vjp, bit for bit (the CPU
    train-step parity with JAX's XLA backend rests on it); the full
    reference at bf16 rounds K2's four gradients too (its d_w2 and d_b2 are
    K3's bf16 plain version's, bit for bit)."""
    args = list(map(torch.from_numpy, _case(rng, 2, 9, 5, 16, 37)))
    f32 = joint_channels_bwd_reference(*args)
    for got, ref in zip(joint_channels_bwd_w(*args), f32[4:]):
        assert torch.equal(got, ref)
    for got, ref in zip(joint_channels_bwd_w_reference(*args), f32[4:]):
        assert torch.equal(got, ref)
    mixed = joint_channels_bwd_reference(*args, mm_dtype=torch.bfloat16)
    for got, ref in zip(mixed[:4], f32[:4]):
        assert not torch.equal(got, ref) and _rel_l2(got, ref) <= ENVELOPE
    for got, ref in zip(mixed[4:], joint_channels_bwd_w_reference(*args,
                                                                  mm_dtype=torch.bfloat16)):
        assert torch.equal(got, ref)


def test_reference_rejects_other_dtypes(rng):
    args = list(map(torch.from_numpy, _case(rng, 1, 3, 2, 8, 5)))
    with pytest.raises(ValueError, match="mm_dtype"):
        joint_channels_bwd_w_reference(*args, mm_dtype=torch.float16)


@pytest.mark.parametrize("n,padded", [(1, 64), (64, 64), (65, 128), (1024, 1024), (6268, 6272)])
def test_pad64(n, padded):
    assert pad64(n) == padded


def test_chunk_rows_at_the_training_shape():
    """At V = 6268 a chunk's bf16 dz stays within 512 MiB, one more t-tile
    would not fit, and the flagship training lattice (B=32, T'=239, U+1=41)
    takes 8 chunks of whole t-tiles; a vocabulary too large for one t-tile's
    scratch still gets one."""
    tiles = chunk_tiles(41, 6268)
    tile_bytes = T_TILE * 41 * pad64(6268) * 2
    assert tiles * tile_bytes <= DZ_SCRATCH_BYTES < (tiles + 1) * tile_bytes
    chunks = chunk_bounds(32, 239, 41, 6268)
    assert len(chunks) == 8
    assert max(bt1 - bt0 for bt0, bt1 in chunks) * 41 * pad64(6268) * 2 <= DZ_SCRATCH_BYTES
    assert chunk_tiles(41, 10**7) == 1
