"""The pruned loss's fixed-order gathers (``ops/rnnt_pruned.py:gather_rows``)
on the CPU, against what they replace and against the JAX package:

* ``gather_rows``' forward equals indexing and ``gather`` bit for bit, and
  its backward is the float64 segment sum of the same float32 cotangents to
  float32 rounding (per target: its count of terms times 2^-24 times the
  sum of their magnitudes), at the two index patterns of the pruned loss
  (the band's rows of ``ay``/``gy`` shared by many cells, the simple
  joint's ``am`` entries shared by repeated labels) and on rows that repeat
  hundreds of times;
* ``_band_chunk`` and ``simple_channels`` take their differentiable
  gathers through it, and give the values of the plain ``gather`` forms
  (copied below) bit for bit, their gradients within float32 rounding;
* the whole pruned loss and its six gradients, and the simple loss and its
  two, against the JAX package's ``rnnt_loss_pruned`` and
  ``rnnt_loss_simple`` at ``tests/test_torch_pruned.py``'s tolerances, on
  a case where labels repeat (V = 5) and bands overlap (s_range 3 and 5).

The card's repeat (three pruned steps run twice give equal parameters) is
held in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``: on the CPU both
forms repeat."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pika_tpu.ops.rnnt_pruned as pruned_jax
from pika_tpu_torch.ops import rnnt_pruned
from pika_tpu_torch.ops.rnnt_loss import _labels_ext
from pika_tpu_torch.ops.rnnt_pruned import (
    _band_chunk,
    gather_rows,
    prune_ranges,
    rnnt_loss_pruned,
    rnnt_loss_simple,
    simple_channels,
)

torch.set_num_threads(1)

B, T, U, V, H = 4, 16, 8, 5, 16
T_LEN = np.array([16, 12, 5, 16], np.int32)
U_LEN = np.array([8, 5, 3, 0], np.int32)
U32 = 2.0 ** -24


def _case(seed=5):
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(am=randn(B, T, V, scale=2.0), lm=randn(B, U + 1, V, scale=2.0),
                ax=randn(B, T, H), gx=randn(B, T, H), ay=randn(B, U + 1, H),
                gy=randn(B, U + 1, H), w2=randn(H, V), b2=randn(V),
                labels=rng.integers(1, V, (B, U)).astype(np.int32), t_len=T_LEN, u_len=U_LEN)


def _t(case, *names):
    return [torch.from_numpy(case[n]) for n in names]


def _j(case, *names):
    return [jnp.asarray(case[n]) for n in names]


def gather_simple_channels(am, lm, labels):
    """``simple_channels`` with ``am``'s label logits by ``gather`` (the
    form it replaces)."""
    b, t_max, v = am.shape
    labels_ext = _labels_ext(labels, v).long()
    amx, lmx = am.detach().amax(-1), lm.detach().amax(-1)
    z = torch.exp(am - amx[..., None]) @ torch.exp(lm - lmx[..., None]).transpose(1, 2)
    lse = torch.log(z.clamp(min=1e-30)) + amx[:, :, None] + lmx[:, None, :]
    am_y = am.gather(2, labels_ext[:, None, :].expand(b, t_max, -1))
    lm_y = lm.gather(2, labels_ext[:, :, None])[..., 0][:, None, :]
    blank_lp = am[..., 0][:, :, None] + lm[..., 0][:, None, :] - lse
    return blank_lp, am_y + lm_y - lse


def gather_band_chunk(ax_c, gx_c, sb_c, ay, gy, w2, b2, labels_ext, s_range):
    """``_band_chunk`` with the band's rows by ``gather`` (the form it
    replaces)."""
    b, tc, h = ax_c.shape
    u1 = ay.shape[1]
    u_idx = (sb_c[..., None] + torch.arange(s_range)).clamp(0, u1 - 1)
    flat = u_idx.reshape(b, tc * s_range)
    ay_b = ay.gather(1, flat[..., None].expand(-1, -1, h)).reshape(b, tc, s_range, h)
    gy_b = gy.gather(1, flat[..., None].expand(-1, -1, h)).reshape(b, tc, s_range, h)
    lbl_b = labels_ext.gather(1, flat).reshape(b, tc, s_range)
    hh = torch.tanh(ax_c[:, :, None] + ay_b) * torch.sigmoid(gx_c[:, :, None] + gy_b)
    z = hh @ w2 + b2
    return z.logsumexp(-1), z[..., 0], z.gather(-1, lbl_b[..., None])[..., 0]


def _assert_segment_sum(table, index, grad, got):
    """``got`` (the table's gradient) is the float64 sum of ``grad``'s rows
    into their targets to float32 rounding of that sum."""
    flat = grad.reshape(grad.shape[0], -1).double()
    ref = torch.zeros(table.shape[0], flat.shape[1], dtype=torch.float64)
    ref.index_add_(0, index, flat)
    mag = torch.zeros_like(ref).index_add_(0, index, flat.abs())
    count = torch.bincount(index, minlength=table.shape[0]).double()[:, None]
    err = (got.reshape(ref.shape).double() - ref).abs()
    assert (err <= count * U32 * mag + 1e-30).all(), float((err / mag.clamp(min=1e-30)).max())


def _band_starts(case, s_range):
    with torch.no_grad():
        blp, elp = simple_channels(*_t(case, "am", "lm", "labels"))
    return prune_ranges(blp, elp, *_t(case, "t_len", "u_len"), s_range)


@pytest.fixture
def recorded(monkeypatch):
    """Every differentiable ``gather_rows`` call of the pruned loss: (table,
    index, output), table and output keeping their gradients (the table is
    a view of its tensor that only this call reads)."""
    calls = []

    def record(table, index):
        out = gather_rows(table, index)
        if out.requires_grad:
            table.retain_grad()
            out.retain_grad()
            calls.append((table, index, out))
        return out

    monkeypatch.setattr(rnnt_pruned, "gather_rows", record)
    return calls


@pytest.mark.parametrize("dup", [1, 7, 300])
@pytest.mark.parametrize("width", [None, 1, 33])
def test_gather_rows_is_indexing_with_a_segment_sum_backward(dup, width):
    """Indices repeating up to ``dup`` times each, in shuffled order."""
    g = torch.Generator().manual_seed(dup)
    rows = 17
    table = torch.randn((rows,) if width is None else (rows, width), generator=g) * 3
    index = torch.arange(rows).repeat_interleave(torch.randint(0, dup + 1, (rows,), generator=g))
    index = index[torch.randperm(len(index), generator=g)]
    leaf = table.clone().requires_grad_()
    out = gather_rows(leaf, index)
    assert torch.equal(out, table[index]) and torch.equal(out, table.index_select(0, index))
    if width is not None:
        assert torch.equal(out, table.gather(0, index[:, None].expand(-1, width)))
    cot = torch.randn(out.shape, generator=g) * 5
    out.backward(cot)
    _assert_segment_sum(table, index, cot, leaf.grad)
    again = table.clone().requires_grad_()
    gather_rows(again, index).backward(cot)
    assert torch.equal(again.grad, leaf.grad)


@pytest.mark.parametrize("s_range", [3, 5])
def test_band_chunk_gathers_its_rows_in_a_fixed_order(recorded, s_range):
    """``_band_chunk`` takes ay's and gy's band rows through ``gather_rows``:
    the channels equal the ``gather`` form's bit for bit; the gradients of
    ay and gy are the float64 segment sums of the gathered rows' cotangents
    (and equal the ``gather`` form's to that rounding)."""
    case = _case()
    sb = _band_starts(case, s_range)
    assert not recorded
    labels_ext = _labels_ext(torch.from_numpy(case["labels"]), V).long()
    ax, gx, ay, gy, w2, b2 = _t(case, "ax", "gx", "ay", "gy", "w2", "b2")
    leaves = [x.clone().requires_grad_() for x in (ay, gy)]
    got = _band_chunk(ax, gx, sb, *leaves, w2, b2, labels_ext, s_range)
    ref_leaves = [x.clone().requires_grad_() for x in (ay, gy)]
    ref = gather_band_chunk(ax, gx, sb, *ref_leaves, w2, b2, labels_ext, s_range)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert [c[0].shape for c in recorded] == [(B * (U + 1), H)] * 2
    cots = [torch.randn(x.shape, generator=torch.Generator().manual_seed(i))
            for i, x in enumerate(got)]
    torch.autograd.backward(got, cots)
    torch.autograd.backward(ref, cots)
    for leaf, ref_leaf, (table, index, out) in zip(leaves, ref_leaves, recorded):
        assert torch.bincount(index).max() > 2  # cells share rows
        _assert_segment_sum(table, index, out.grad, leaf.grad)
        _assert_segment_sum(table, index, out.grad, ref_leaf.grad)


def test_simple_channels_gather_am_in_a_fixed_order(recorded):
    """``simple_channels`` takes am's label logits through ``gather_rows``:
    the channels equal the ``gather`` form's bit for bit; am's gradient is
    the float64 segment sum of the gathered entries' cotangents plus the
    rest of its graph, to float32 rounding of the ``gather`` form's."""
    case = _case()
    am, lm, labels = _t(case, "am", "lm", "labels")
    leaves = [x.clone().requires_grad_() for x in (am, lm)]
    ref_leaves = [x.clone().requires_grad_() for x in (am, lm)]
    got = simple_channels(*leaves, labels)
    ref = gather_simple_channels(*ref_leaves, labels)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    (table, index, out), = recorded
    assert table.shape == (B * T * V,) and torch.bincount(index).max() > 2  # labels repeat
    cots = [torch.randn(x.shape, generator=torch.Generator().manual_seed(9 + i))
            for i, x in enumerate(got)]
    torch.autograd.backward(got, cots)
    torch.autograd.backward(ref, cots)
    _assert_segment_sum(table, index, out.grad, table.grad)
    np.testing.assert_allclose(leaves[0].grad.numpy(), ref_leaves[0].grad.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(leaves[1].grad, ref_leaves[1].grad)  # lm's gather has no shared target


def test_simple_loss_matches_jax_with_repeated_labels():
    case = _case()

    def loss(am, lm):
        losses, _ = pruned_jax.rnnt_loss_simple(am, lm, *_j(case, "labels", "t_len", "u_len"))
        return losses.sum(), losses

    (_, losses_ref), grads_ref = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(*_j(case, "am", "lm"))
    am, lm = (x.requires_grad_() for x in _t(case, "am", "lm"))
    losses, _ = rnnt_loss_simple(am, lm, *_t(case, "labels", "t_len", "u_len"))
    losses.sum().backward()
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(losses_ref), rtol=1e-5,
                               atol=1e-6)
    for got, want in zip((am.grad, lm.grad), grads_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s_range", [3, 5])
def test_pruned_loss_matches_jax_with_shared_rows(s_range):
    """The loss and its six gradients on the JAX band starts, T-chunks of 7."""
    case = _case()
    sb = np.asarray(_band_starts(case, s_range))

    def loss(*f):
        losses = pruned_jax.rnnt_loss_pruned(*f, *_j(case, "labels", "t_len", "u_len"),
                                             jnp.asarray(sb), s_range, chunk=7)
        return losses.sum(), losses

    (_, losses_ref), grads_ref = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(6)), has_aux=True))(
        *_j(case, "ax", "gx", "ay", "gy", "w2", "b2"))
    factors = [x.requires_grad_() for x in _t(case, "ax", "gx", "ay", "gy", "w2", "b2")]
    losses = rnnt_loss_pruned(*factors, *_t(case, "labels", "t_len", "u_len"),
                              torch.from_numpy(sb), s_range, chunk=7)
    losses.sum().backward()
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(losses_ref), rtol=1e-5,
                               atol=1e-6)
    assert (losses[:3] > 0).all()
    for name, x, want in zip(("ax", "gx", "ay", "gy", "w2", "b2"), factors, grads_ref):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
