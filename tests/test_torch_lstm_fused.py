"""The LSTM's fused route (``LSTM.forward_fused``: one ATen LSTM call per
layer, packed ragged batches; cuDNN on the card) called explicitly on the
CPU, against the loop over frames (``forward_loop``, the plain version) and
the JAX package's ``pika_tpu/models/lstm.py`` on converted weights: masked
and bidirectional with ragged lengths (a full row, a row of length 1 and
one of length 0), with and without an initial state; outputs, final states
and the gradients of the input, the initial state and every parameter to
1e-5 relative L2; the prediction net's form (unidirectional, unmasked)
through a backward to the same; and train-mode dropout between layers
drawn from the same generator."""

import numpy as np
import pytest
import torch

from pika_tpu_torch.convert import load_flax_variables, state_dict_from_flax
from pika_tpu_torch.models.lstm import LSTM

torch.set_num_threads(1)

TOL = 1e-5


def _rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _inputs(seed, layers, bidirectional, initial):
    rng = np.random.default_rng(seed)
    b, t, d, h = 4, 11, 6, 8
    dirs = 2 if bidirectional else 1
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    lengths = np.array([11, 1, 6, 0], np.int64)
    state = None
    if initial:
        state = tuple(rng.standard_normal((layers * dirs, b, h // dirs)).astype(np.float32)
                      for _ in range(2))
    # cotangents of the outputs and of the final states
    cots = [rng.standard_normal((b, t, h)).astype(np.float32),
            rng.standard_normal((layers * dirs, b, h // dirs)).astype(np.float32),
            rng.standard_normal((layers * dirs, b, h // dirs)).astype(np.float32)]
    return x, lengths, state, cots, (d, h)


def _torch_run(mod, route, x, lengths, state, cots, generator=None):
    """Outputs, states and the gradients of x, the initial state and every
    parameter under ``route``."""
    mod.zero_grad()
    xt = torch.from_numpy(x).requires_grad_()
    st = None if state is None else tuple(torch.from_numpy(s).requires_grad_() for s in state)
    lengths = None if lengths is None else torch.from_numpy(lengths)
    out, (h, c) = getattr(mod, route)(xt, generator, lengths, st)
    loss = sum((v * torch.from_numpy(w)).sum() for v, w in zip((out, h, c), cots))
    loss.backward()
    grads = {"x": xt.grad}
    if st is not None:
        grads["h0"], grads["c0"] = st[0].grad, st[1].grad
    grads.update({k: p.grad for k, p in mod.named_parameters()})
    return [out.detach(), h.detach(), c.detach()], grads


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("initial", [False, True])
def test_fused_route_matches_the_loop_and_jax(layers, bidirectional, initial):
    import jax
    import jax.numpy as jnp

    from pika_tpu.models.lstm import LSTM as LSTMJax

    x, lengths, state, cots, (d, h) = _inputs(layers * 4 + bidirectional * 2 + initial, layers,
                                              bidirectional, initial)
    mod = LSTMJax(h, layers, bidirectional=bidirectional)
    variables = mod.init(jax.random.PRNGKey(layers), jnp.asarray(x))

    def jax_loss(params, xj, st):
        out, (hh, cc) = mod.apply(params, xj, jnp.asarray(lengths), st)
        return sum((v * w).sum() for v, w in zip((out, hh, cc), cots)), (out, hh, cc)

    st_j = None if state is None else tuple(map(jnp.asarray, state))
    (_, ref), (g_params, g_x, g_st) = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(variables, jnp.asarray(x), st_j)
    ref_grads = {"x": g_x, **state_dict_from_flax(jax.tree.map(np.asarray, g_params))}
    if state is not None:
        ref_grads["h0"], ref_grads["c0"] = g_st

    pt = load_flax_variables(LSTM(d, h, layers, bidirectional=bidirectional),
                             jax.tree.map(np.asarray, variables))
    fused, fused_g = _torch_run(pt, "forward_fused", x, lengths, state, cots)
    loop, loop_g = _torch_run(pt, "forward_loop", x, lengths, state, cots)
    assert set(fused_g) == set(loop_g) == set(ref_grads)
    for name, got, want, ref_v in zip(("out", "h", "c"), fused, loop, ref):
        assert _rel_l2(got, want) <= TOL, name
        assert _rel_l2(got, ref_v) <= TOL, name
    for name in fused_g:
        assert _rel_l2(fused_g[name], loop_g[name]) <= TOL, name
        assert _rel_l2(fused_g[name], ref_grads[name]) <= TOL, name
    out = fused[0]
    assert not out[1, 1:].any() and not out[2, 6:].any() and not out[3].any()
    # the empty row keeps its initial state, as the loop does
    init_h = torch.zeros_like(fused[1][:, 3]) if state is None else torch.from_numpy(state[0][:, 3])
    assert torch.equal(fused[1][:, 3], init_h)


def test_fused_route_draws_the_loops_dropout():
    """Train mode: dropout between the layers from the same generator, so
    the same masks in the same order."""
    x, lengths, _, cots, (d, h) = _inputs(7, 3, True, False)
    torch.manual_seed(0)
    mod = LSTM(d, h, 3, dropout=0.3, bidirectional=True)
    for p in mod.parameters():
        torch.nn.init.uniform_(p, -0.3, 0.3)
    mod.train()
    runs = [_torch_run(mod, route, x, lengths, None, cots, torch.Generator().manual_seed(3))
            for route in ("forward_fused", "forward_loop")]
    (fused, fused_g), (loop, loop_g) = runs
    for got, want in zip(fused, loop):
        assert _rel_l2(got, want) <= TOL
    for name in fused_g:
        assert _rel_l2(fused_g[name], loop_g[name]) <= TOL, name
    eval_out = mod.eval().forward_fused(torch.from_numpy(x), None, torch.from_numpy(lengths))[0]
    assert _rel_l2(fused[0], eval_out.detach()) > 1e-2  # the masks acted


def test_fused_route_without_lengths_matches_the_loop():
    """The prediction net's form (``Transducer.predict``: unidirectional,
    unmasked, no initial state) in train mode, one and two layers, through
    the backward: the outputs, final states and the gradients of the input
    and of every parameter, against the loop and the JAX package."""
    import jax
    import jax.numpy as jnp

    from pika_tpu.models.lstm import LSTM as LSTMJax

    for layers in (1, 2):
        x, _, _, cots, (d, h) = _inputs(20 + layers, layers, False, False)
        mod = LSTMJax(h, layers)
        variables = mod.init(jax.random.PRNGKey(layers), jnp.asarray(x))

        def jax_loss(params, xj):
            out, (hh, cc) = mod.apply(params, xj)
            return sum((v * w).sum() for v, w in zip((out, hh, cc), cots)), (out, hh, cc)

        (_, ref), (g_params, g_x) = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                                       has_aux=True)(variables, jnp.asarray(x))
        ref_grads = {"x": g_x, **state_dict_from_flax(jax.tree.map(np.asarray, g_params))}
        pt = load_flax_variables(LSTM(d, h, layers), jax.tree.map(np.asarray, variables)).train()
        fused, fused_g = _torch_run(pt, "forward_fused", x, None, None, cots)
        loop, loop_g = _torch_run(pt, "forward_loop", x, None, None, cots)
        assert set(fused_g) == set(loop_g) == set(ref_grads)
        for name, got, want, ref_v in zip(("out", "h", "c"), fused, loop, ref):
            assert _rel_l2(got, want) <= TOL, (layers, name)
            assert _rel_l2(got, ref_v) <= TOL, (layers, name)
        for name in fused_g:
            assert _rel_l2(fused_g[name], loop_g[name]) <= TOL, (layers, name)
            assert _rel_l2(fused_g[name], ref_grads[name]) <= TOL, (layers, name)


def test_fused_route_takes_the_matmuls_tf32_flag_and_restores_cudnns(monkeypatch):
    """Forward and backward of a layer run with cuDNN's TF32 flag at the
    matmuls' (which cuDNN reads again when it builds the backward); the
    flag is restored after each, and the weights-copy warning is silenced
    only inside the calls."""
    import warnings

    from pika_tpu_torch.models import lstm as lstm_mod

    seen = []
    vf_lstm, grad = lstm_mod._vf_lstm, torch.autograd.grad
    monkeypatch.setattr(lstm_mod, "_vf_lstm", lambda *a: (
        seen.append(("forward", torch.backends.cudnn.allow_tf32)), vf_lstm(*a))[1])
    monkeypatch.setattr(torch.autograd, "grad", lambda *a, **k: (
        seen.append(("backward", torch.backends.cudnn.allow_tf32)), grad(*a, **k))[1])
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        mod = LSTM(3, 4, 2, bidirectional=True)
        x = torch.randn(2, 5, 3, requires_grad=True)
        out, (h, c) = mod.forward_fused(x, lengths=torch.tensor([5, 2]))
        assert torch.backends.cudnn.allow_tf32
        (out.sum() + h.sum() + c.sum()).backward()
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert seen == [("forward", False)] * 2 + [("backward", False)] * 2
    assert not any(f[1] is not None and "RNN module weights" in f[1].pattern
                   for f in warnings.filters)
