"""Model bundles: the configuration and the weights in one directory (port of
``pika_tpu/train/bundle.py``).

A bundle holds ``model.json`` -- ``{"kind", "config", "metadata"}``, the
JAX package's spec -- and ``model.pt``, a torch state dict, in place of the
JAX package's Orbax checkpoint.  A JAX bundle converts with
``bundle_from_flax`` from its variables as numpy arrays; reading the Orbax
checkpoint needs JAX, so that step happens outside this package (README).
The kinds are ``transducer`` (``models/transducer.py``) and ``las``
(``models/las.py``, whose metadata carries ``epoch``, ``reverse_labels`` and
``las_input``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Tuple, Union

import torch

from pika_tpu_torch.convert import state_dict_from_flax
from pika_tpu_torch.device import resolve_device
from pika_tpu_torch.models.las import LAS, LASConfig
from pika_tpu_torch.models.transducer import Transducer, TransducerConfig

WEIGHTS = "model.pt"
KINDS = {"transducer": (Transducer, TransducerConfig), "las": (LAS, LASConfig)}


def _write(directory: str, spec: dict, state_dict: dict) -> str:
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "model.json"), "w") as f:
        json.dump(spec, f, indent=2)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(directory, WEIGHTS))
    return directory


def save_bundle(directory: str, model: Union[Transducer, LAS], metadata: dict = None,
                state_dict: dict = None) -> str:
    """Write ``model`` (its configuration and state dict, or ``state_dict``
    when given: a host copy taken earlier) as a bundle of kind
    ``transducer`` or ``las``; returns the directory."""
    kind = "las" if isinstance(model, LAS) else "transducer"
    spec = {"kind": kind, "config": dataclasses.asdict(model.config),
            "metadata": metadata or {}}
    return _write(directory, spec, model.state_dict() if state_dict is None else state_dict)


def bundle_from_flax(directory: str, spec: dict, variables_np: dict) -> str:
    """Write a port bundle from a JAX bundle's ``model.json`` spec and its
    flax variables as numpy arrays (``jax.tree.map(np.asarray, variables)``)."""
    return _write(directory, spec, state_dict_from_flax(variables_np))


def load_bundle(directory: str, device=None, **config) -> Tuple[Union[Transducer, LAS], dict]:
    """Returns (model in eval mode on ``device`` -- the card unless the
    caller names another --, metadata): a ``Transducer`` or a ``LAS`` by the
    bundle's kind; ``config`` fields replace the bundle's (the CLI's
    ``--attn_chunk 0``)."""
    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "model.json")) as f:
        spec = json.load(f)
    if spec["kind"] not in KINDS:
        raise ValueError(f"bundle kind {spec['kind']!r}: expected one of {sorted(KINDS)}")
    module, config_cls = KINDS[spec["kind"]]
    # a bundle saved by a newer build may carry fields this one does not
    # know: drop them, loudly
    known = {f.name for f in dataclasses.fields(config_cls)}
    unknown = sorted(set(spec["config"]) - known)
    if unknown:
        print(f"load_bundle: ignoring unknown config fields {unknown}", file=sys.stderr)
    cfg = config_cls(**{k: v for k, v in {**spec["config"], **config}.items() if k in known})
    device = resolve_device(device)
    with torch.device("meta"):
        model = module(cfg)
    model = model.to_empty(device=device)
    state = torch.load(os.path.join(directory, WEIGHTS), map_location=device, weights_only=True)
    model.load_state_dict(state)
    return model.eval(), spec.get("metadata", {})
