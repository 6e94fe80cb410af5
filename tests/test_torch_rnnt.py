"""The port's RNN-T forward (pika_tpu_torch.ops) against the JAX package:
K1's plain version against ``_chunk_channels`` and the interpret-mode
Pallas kernel, ``rnnt_alpha`` and the forward loss against JAX and the
numpy oracle.  K1 itself runs only on the card: tests/test_torch_gpu.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pika_tpu.ops.rnnt_loss import (
    _all_channels,
    _chunk_channels,
    rnnt_alpha as rnnt_alpha_jax,
    rnnt_loss_fused,
    rnnt_loss_numpy as rnnt_loss_numpy_jax,
)
from pika_tpu.ops.rnnt_pallas import joint_channels_pallas
from pika_tpu_torch.ops import cuda_build
from pika_tpu_torch.ops.rnnt_kernels import joint_channels, joint_channels_reference
from pika_tpu_torch.ops.rnnt_loss import rnnt_alpha, rnnt_loss_forward, rnnt_loss_numpy

torch.set_num_threads(1)


def _case(rng, b=2, t=37, u1=11, h=24, v=301):
    """Joint factors at ragged sizes (no dimension a multiple of a tile)."""
    ax, gx = (rng.standard_normal((b, t, h)).astype(np.float32) * 0.5 for _ in range(2))
    ay, gy = (rng.standard_normal((b, u1, h)).astype(np.float32) * 0.5 for _ in range(2))
    w2 = rng.standard_normal((h, v)).astype(np.float32) * 0.2
    b2 = rng.standard_normal(v).astype(np.float32) * 0.1
    labels_ext = rng.integers(0, v, (b, u1)).astype(np.int32)
    return ax, gx, ay, gy, w2, b2, labels_ext


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("chunk", [8, 32, 64])
def test_reference_matches_jax_all_channels(rng, chunk):
    """f32 throughout: agreement to 1e-5 relative."""
    args = _case(rng)
    ref = _all_channels(*map(jnp.asarray, args), chunk)
    got = joint_channels_reference(*_torch(*args), chunk=chunk)
    for name, r, g in zip(("lse", "zb", "zy"), ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 37, 11, 24, 301), (1, 5, 1, 8, 3), (3, 16, 4, 32, 64)])
def test_reference_matches_pallas_interpret(rng, shape):
    """K1's plain version against the Pallas K1 run in interpret mode at f32
    (tolerance as tests/test_rnnt_pallas.py: 2e-5)."""
    b, t, u1, h, v = shape
    args = _case(rng, b, t, u1, h, v)
    ref = joint_channels_pallas(*map(jnp.asarray, args), mm_dtype=jnp.float32,
                                block_t=16, block_u=4, block_v=32)
    got = joint_channels(*_torch(*args))  # CPU tensors: the plain version
    for name, r, g in zip(("lse", "zb", "zy"), ref, got):
        assert g.shape == (b, t, u1)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5, atol=2e-5, err_msg=name)


def test_chunk_channels_match(rng):
    args = _case(rng, t=9)
    ref = _chunk_channels(*map(jnp.asarray, args))
    got = joint_channels_reference(*_torch(*args), chunk=9)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_rnnt_alpha_matches_jax(rng):
    b, t, u1 = 3, 13, 7
    blank = np.log(rng.uniform(0.05, 0.9, (b, t, u1))).astype(np.float32)
    emit = np.log(rng.uniform(0.05, 0.9, (b, t, u1))).astype(np.float32)
    u_len = np.array([6, 3, 0], np.int32)
    ref = np.asarray(rnnt_alpha_jax(jnp.asarray(blank), jnp.asarray(emit), jnp.asarray(u_len)))
    got = rnnt_alpha(*_torch(blank, emit, u_len)).numpy()
    valid = np.arange(u1)[None, None, :] <= u_len[:, None, None]
    np.testing.assert_allclose(got[np.broadcast_to(valid, got.shape)],
                               ref[np.broadcast_to(valid, ref.shape)], rtol=1e-5, atol=1e-5)
    assert np.all(np.isfinite(got))


def _loss_case(rng, b=3, t=17, u=6, h=16, v=29):
    ax, gx, ay, gy, w2, b2, _ = _case(rng, b, t, u + 1, h, v)
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    t_len = np.array([t, t - 4, 0], np.int32)[:b]
    u_len = np.array([u, u - 2, 3], np.int32)[:b]
    return ax, gx, ay, gy, w2, b2, labels, t_len, u_len


@pytest.mark.parametrize("backend", ["auto", "plain"])
def test_loss_forward_matches_jax_fused(rng, backend):
    """Per-utterance losses against rnnt_loss_fused(backend='xla') at 1e-5
    relative; the t_len=0 row is exactly 0."""
    args = _loss_case(rng)
    ref = np.asarray(rnnt_loss_fused(*map(jnp.asarray, args), 8, "xla"))
    got = rnnt_loss_forward(*_torch(*args), chunk=8, backend=backend).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert got[2] == 0.0


def test_loss_forward_matches_numpy_oracle(rng):
    """Against the literal DP over the full log-softmax lattice (1e-4: the
    oracle sums in float64)."""
    ax, gx, ay, gy, w2, b2, labels, t_len, u_len = _loss_case(rng, b=2)
    h = np.tanh(ax[:, :, None] + ay[:, None]) / (1 + np.exp(-(gx[:, :, None] + gy[:, None])))
    z = h.astype(np.float64) @ w2 + b2
    lp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    ref = rnnt_loss_numpy(lp, labels, t_len, u_len)
    np.testing.assert_allclose(ref, rnnt_loss_numpy_jax(lp, labels, t_len, u_len))
    got = rnnt_loss_forward(*_torch(ax, gx, ay, gy, w2, b2, labels, t_len, u_len)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_loss_backward_raises(rng):
    """The backward is not ported: the loss carries no graph, so a backward
    raises instead of returning a wrong gradient."""
    ax, gx, ay, gy, w2, b2, labels, t_len, u_len = _torch(*_loss_case(rng))
    ax.requires_grad_(True)
    loss = rnnt_loss_forward(ax, gx, ay, gy, w2, b2, labels, t_len, u_len)
    with pytest.raises(RuntimeError):
        loss.sum().backward()


def test_loss_unknown_backend(rng):
    with pytest.raises(ValueError):
        rnnt_loss_forward(*_torch(*_loss_case(rng)), backend="pallas")


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build()
