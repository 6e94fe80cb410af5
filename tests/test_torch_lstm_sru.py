"""The LAS rescorer's recurrent layers in the port against the JAX package
on the CPU, from the same weights (flax variables through ``convert.py``)
on the same numpy inputs: the LSTM bidirectional, with ragged ``lengths``
and an ``initial_state``; the SRU cell and the SRU in both directions over
1-3 layers (tolerance 1e-5)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pika_tpu.models.lstm import LSTM as LSTMJax
from pika_tpu.models.sru import SRU as SRUJax, SRUCell as SRUCellJax
from pika_tpu_torch.convert import load_flax_variables
from pika_tpu_torch.models.lstm import LSTM
from pika_tpu_torch.models.sru import SRU, SRUCell

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, ref, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), err_msg=what, **TOL)


# ---------------------------------------------------------------------------
# LSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("ragged,initial", [(False, False), (True, False), (True, True)])
def test_lstm_matches_jax(layers, bidirectional, ragged, initial):
    """Outputs (0 past each length) and final (h, c) stacked (layers x dirs,
    B, H_dir), to 1e-5."""
    rng = np.random.default_rng(layers * 4 + bidirectional * 2 + ragged + initial)
    b, t, d, h = 3, 9, 5, 8
    dirs = 2 if bidirectional else 1
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    lengths = np.array([9, 4, 1], np.int32) if ragged else None
    state = None
    if initial:
        state = tuple(rng.standard_normal((layers * dirs, b, h // dirs)).astype(np.float32)
                      for _ in range(2))
    mod = LSTMJax(h, layers, bidirectional=bidirectional)
    variables = mod.init(jax.random.PRNGKey(layers), jnp.asarray(x))
    ref_out, (ref_h, ref_c) = mod.apply(
        variables, jnp.asarray(x), None if lengths is None else jnp.asarray(lengths),
        None if state is None else tuple(map(jnp.asarray, state)))
    pt = load_flax_variables(LSTM(d, h, layers, bidirectional=bidirectional),
                             jax.tree.map(np.asarray, variables))
    out, (hh, cc) = pt(torch.from_numpy(x), lengths=None if lengths is None
                       else torch.from_numpy(lengths),
                       initial_state=None if state is None else tuple(map(torch.from_numpy, state)))
    _close(out, ref_out, "out")
    _close(hh, ref_h, "h")
    _close(cc, ref_c, "c")
    if ragged:
        assert not out[1, 4:].any() and not out[2, 1:].any()


# ---------------------------------------------------------------------------
# SRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("n_in,n_out", [(6, 4), (8, 4), (4, 4)])
def test_sru_cell_matches_jax(bidirectional, n_in, n_out):
    """Both directions, the highway from a fourth projection (k = 4) and from
    x itself (k = 3), with and without an initial c."""
    rng = np.random.default_rng(n_in + bidirectional)
    x = rng.standard_normal((2, 11, n_in)).astype(np.float32)
    dirs = 2 if bidirectional else 1
    c0 = rng.standard_normal((2, n_out * dirs)).astype(np.float32)
    cell = SRUCellJax(n_in, n_out, bidirectional)
    variables = cell.init(jax.random.PRNGKey(0), jnp.asarray(x))
    pt = load_flax_variables(SRUCell(n_in, n_out, bidirectional),
                             jax.tree.map(np.asarray, variables))
    for init in (None, c0):
        ref_h, ref_c = cell.apply(variables, jnp.asarray(x),
                                  None if init is None else jnp.asarray(init))
        h, c = pt(torch.from_numpy(x), None if init is None else torch.from_numpy(init))
        _close(h, ref_h, "h")
        _close(c, ref_c, "c")


@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_sru_matches_jax(layers, bidirectional):
    rng = np.random.default_rng(layers)
    x = rng.standard_normal((3, 17, 6)).astype(np.float32)
    mod = SRUJax(6, 4, layers, bidirectional)
    variables = mod.init(jax.random.PRNGKey(layers), jnp.asarray(x))
    ref_out, ref_c = mod.apply(variables, jnp.asarray(x))
    pt = load_flax_variables(SRU(6, 4, layers, bidirectional), jax.tree.map(np.asarray, variables))
    out, c = pt(torch.from_numpy(x))
    _close(out, ref_out, "out")
    _close(c, ref_c, "c")
