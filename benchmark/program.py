"""The system under test, built only through the port's own API from a
configuration file and the benchmark's weights: the model
(``Transducer``, loaded with ``weights.make_state``), the featurizer
(``make_featurizer``), the optimizer (``make_optimizer``), the training
step (``make_train_step``) and the beam search (``beam_search_features``,
which with the featurizer composes ``beam_search_waveforms``)."""

from __future__ import annotations

import dataclasses

import torch

from benchmark import weights
from benchmark.reference import model as reference_model
from pika_tpu_torch.decode.beam import BeamConfig, beam_search_features  # noqa: F401
from pika_tpu_torch.features.fbank import FbankConfig
from pika_tpu_torch.models.transducer import Transducer, TransducerConfig
from pika_tpu_torch.train.lr import make_optimizer  # noqa: F401
from pika_tpu_torch.train.step import (  # noqa: F401
    FeaturizerConfig,
    make_featurizer,
    make_train_step,
)


def set_precision(config: dict) -> None:
    """The configuration's TF32 flags for the program: cuDNN's (the TDNN's
    convolutions) and the matmuls'."""
    prec = config["precision"]
    torch.backends.cudnn.allow_tf32 = prec["conv_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = prec["matmul_tf32"]


def transducer_config(config: dict) -> TransducerConfig:
    """The port's configuration from the ``model`` keys that are its
    fields.  A key that is neither a field nor read by the reference's
    parts (``reference.model.keys``) is refused: the port would build its
    default in its place."""
    model = config["model"]
    fields = {f.name for f in dataclasses.fields(TransducerConfig)}
    unread = sorted(set(model) - fields - reference_model.keys(model))
    if unread:
        raise ValueError(f"configuration {config.get('name', '?')}: model key(s) "
                         f"{', '.join(unread)} neither a TransducerConfig field nor read "
                         f"by a reference part")
    return TransducerConfig(**{k: v for k, v in model.items() if k in fields})


def build_model(config: dict, seed: int, device) -> tuple:
    """The port's model on ``device`` with the benchmark's weights for
    ``seed``, in eval mode, and its layout: name -> (shape, dtype) of every
    weight and buffer, and the parameters' names.  Built on the device
    directly: a first module on the meta device imports ``torch._dynamo``,
    8-9 s of set-up on the H100's host."""
    model = Transducer(transducer_config(config), device=device)
    shapes = {n: (tuple(t.shape), t.dtype) for n, t in model.state_dict().items()}
    model.load_state_dict(weights.make_state(shapes, seed, device))
    return model.eval(), {"shapes": shapes, "names": [n for n, _ in model.named_parameters()]}


def featurizer(config: dict, samples: int, device, spec_augment: bool = False,
               max_freq_span: int = 15, max_time_span: int = 35, cmvn=(None, None)):
    feat = config["features"]
    fbank = FbankConfig(**{k: feat[k] for k in ("sample_frequency", "window_type", "dither",
                                                  "low_freq", "high_freq", "num_mel_bins")})
    return make_featurizer(FeaturizerConfig(
        fbank=fbank, max_samples=samples, lctx=feat["lctx"], rctx=feat["rctx"], stride=1,
        spec_augment=spec_augment, max_freq_span=max_freq_span, max_time_span=max_time_span),
        *cmvn, device=device)
