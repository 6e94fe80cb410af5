"""The port's LAS rescorer model against the JAX package on the CPU, from
the same weights (flax variables through ``convert.py``) on the same numpy
inputs: the LAS forward over its attention types, coverage, context gates,
downsampler, bidirectional encoder and SRU encoder, the decoder-only
pretraining path and scheduled sampling at probability 0 and 1 (tolerance
1e-5), and sampling at 0.5 by the share of steps replaced.  Its recurrent
layers are in ``test_torch_lstm_sru.py``."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pika_tpu.models.las import LAS as LASJax, LASConfig as LASConfigJax, init_las as init_las_jax
import pika_tpu_torch.models.las as las_pt
from pika_tpu_torch.convert import load_flax_variables
from pika_tpu_torch.models.las import LASConfig, init_las

torch.set_num_threads(1)

VOCAB = 10  # SOS 0, EOS 9, pad 10
TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, ref, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), err_msg=what, **TOL)


# ---------------------------------------------------------------------------
# LAS
# ---------------------------------------------------------------------------

def _cfg(**kw):
    base = dict(input_dim=8, output_dim=VOCAB, pad_idx=VOCAB, rnn_size=16, enc_layers=1,
                dec_layers=1, embd_dim=6)
    base.update(kw)
    return base


@functools.lru_cache(maxsize=None)
def _jax_las(items):
    cfg = LASConfigJax(**dict(items))
    variables = jax.jit(lambda key: init_las_jax(key, cfg)[1])(jax.random.PRNGKey(11))
    return LASJax(cfg), jax.tree.map(np.asarray, variables)


def _models(**kw):
    cfg = _cfg(**kw)
    model, variables = _jax_las(tuple(sorted(cfg.items())))
    pt = load_flax_variables(init_las(LASConfig(**cfg), torch.Generator().manual_seed(0),
                                      device="cpu"), variables)
    return model, variables, pt


def _inputs(seed, b=3, t=12, u=7):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((b, t, 8)).astype(np.float32)
    lens = np.array([t, t - 3, 5][:b], np.int32)
    tgt = rng.integers(0, VOCAB + 1, (b, u)).astype(np.int32)
    tgt[:, 0] = 0
    return src, lens, tgt


VARIANTS = [
    dict(attn_type="dot"),
    dict(attn_type="general", coverage_attn=True, context_gate="both"),
    dict(attn_type="mlp", coverage_attn=True, context_gate="source"),
    dict(attn_type="dot", coverage_attn=True, context_gate="target"),
    dict(use_downsampler=True, downsampler_rate=3, brnn=True),
    dict(brnn=True, enc_layers=2, dec_layers=2, coverage_attn=True),
    dict(rnn_type="SRU", brnn=True, enc_layers=2, dec_layers=2, attn_type="general"),
    dict(rnn_type="SRU", use_downsampler=True, context_gate="both"),
]


@pytest.mark.parametrize("kw", VARIANTS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_las_forward_matches_jax(kw):
    """Decoder outputs, attentions, encoder outputs and both heads' logits,
    eval mode, ragged source lengths, to 1e-5."""
    model, variables, pt = _models(**kw)
    src, lens, tgt = _inputs(1)

    def forward(v, *args):
        out, attn, enc = model.apply(v, *args)
        return (out, attn, enc, model.apply(v, out, method=LASJax.output_logits),
                model.apply(v, enc, method=LASJax.encoder_logits))

    ref = jax.jit(forward)(variables, *map(jnp.asarray, (src, tgt, lens)))
    out, attn, enc = pt(*map(torch.from_numpy, (src, tgt, lens)))
    got = (out, attn, enc, pt.output_logits(out), pt.encoder_logits(enc))
    for name, g, r in zip(("outputs", "attentions", "enc_out", "dec_proj", "enc_proj"), got, ref):
        _close(g, r, name)


def test_las_pretrain_decode_matches_jax():
    model, variables, pt = _models()
    _, _, tgt = _inputs(2)
    ref, _, _ = model.apply(variables, jnp.zeros((3, 1, 8)), jnp.asarray(tgt), None, True, False)
    out, attn, enc = pt(torch.zeros(3, 1, 8), torch.from_numpy(tgt), None, True, False)
    assert attn is None and enc is None
    _close(out, ref)


@pytest.mark.parametrize("prob", [0.0, 1.0])
@pytest.mark.parametrize("kw", [dict(), dict(coverage_attn=True, context_gate="both")])
def test_las_scheduled_sampling_matches_jax(prob, kw):
    """At probability 0 no step samples; at 1 every step from the second on
    feeds the argmax of the previous output's projection in place of the ids
    in (1, pad): the same outputs as the JAX decoder."""
    model, variables, pt = _models(**kw)
    src, lens, tgt = _inputs(3)
    # (the JAX decoder indexes its embedding table with traced ids: jnp arrays)
    ref, _, _ = model.apply(jax.tree.map(jnp.asarray, variables),
                            *map(jnp.asarray, (src, tgt, lens)), sampling_prob=prob,
                            sampling_key=jax.random.PRNGKey(0))
    out, _, _ = pt(*map(torch.from_numpy, (src, tgt, lens)), sampling_prob=prob,
                   generator=torch.Generator().manual_seed(0))
    _close(out, ref)
    if prob == 1.0:
        forced, _, _ = pt(*map(torch.from_numpy, (src, tgt, lens)))
        assert not torch.allclose(out, forced)


def test_las_scheduled_sampling_share(monkeypatch):
    """At probability 0.5 the share of steps that sample is 0.5 (one toss per
    step, uniform in [0, 1)), and ids outside (1, pad) are never replaced:
    a target of ids 0, 1 and pad decodes as teacher-forced at probability 1."""
    _, _, pt = _models()
    src, lens, tgt = (torch.from_numpy(x) for x in _inputs(4, u=40))
    tosses = []
    rand = torch.rand

    def spy(*args, **kw):
        x = rand(*args, **kw)
        tosses.append(float(x))
        return x

    monkeypatch.setattr(las_pt.torch, "rand", spy)
    gen = torch.Generator().manual_seed(0)
    for _ in range(25):
        pt(src, tgt, lens, sampling_prob=0.5, generator=gen)
    monkeypatch.setattr(las_pt.torch, "rand", rand)
    assert len(tosses) == 25 * 39
    share = np.mean(np.array(tosses) < 0.5)
    assert 0.45 < share < 0.55, share  # 975 tosses: 3 standard deviations is 0.048
    fixed = torch.tensor([[0, 1, 1, VOCAB, 0, 1, VOCAB]] * 3)
    sampled, _, _ = pt(src, fixed, lens, sampling_prob=1.0, generator=gen)
    forced, _, _ = pt(src, fixed, lens)
    assert torch.equal(sampled, forced)
