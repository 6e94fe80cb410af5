"""Bridge from a flax variable tree of the JAX package to this package's
modules.

A flax tree ``{"params": ..., "batch_stats": ...}`` of numpy arrays maps onto
a torch ``state_dict`` whose keys are the flax paths joined by dots, because
the torch modules here carry the flax module names.  Layout rules:

* Dense ``kernel`` (in, out)       -> Linear ``weight`` (out, in)
* Conv ``kernel`` (k, in, out)     -> Conv1d ``weight`` (out, in, k)
* Embed ``embedding`` (V+1, E)     -> Embedding ``weight`` (pad row V kept)
* BatchNorm ``scale``/``bias`` + ``batch_stats`` ``mean``/``var``
                                   -> ``weight``/``bias``/``running_mean``/``running_var``
* LayerNorm ``scale``/``bias``     -> ``weight``/``bias``
  (the transformer prediction net's ``conv_{i}``, ``transformer_{i}``,
  ``layer_norm`` and ``linear_out``, the attention's
  ``relative_positions_embeddings`` table and the pruned loss's
  ``simple_am``/``simple_lm`` heads come under these rules)
* LSTM ``l{k}_d0_wih`` (in, 4H), ``l{k}_d0_whh`` (H, 4H), ``l{k}_d0_b`` (4H,)
                                   -> ``weight_ih_l{k}`` (4H, in), ``weight_hh_l{k}`` (4H, H),
                                      ``bias_l{k}``; gate order i, f, g, o on both sides;
                                      ``l{k}_d1_*`` -> the same with the suffix ``_reverse``
                                      (the prediction net, the rnn encoder, the LAS LSTMs)
* SRU cell ``weight`` (in, k*n_out*dirs), ``bias``
                                   -> the same names and layouts
* LAS decoder leaves ``dec_cell_{i}_{wih,whh,b}``, ``attn_*``, ``gate_*``
                                   -> the same names and layouts (the LAS module
                                      keeps the JAX (in, out) layout for them)
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

_LSTM_KEY = re.compile(r"^l(\d+)_d(\d+)_(wih|whh|b)$")
_LAS_RAW_KEY = re.compile(r"^(dec_cell_\d+_(wih|whh|b)|attn_\w+|gate_\w+)$")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _convert_node(path: str, node: dict, stats: dict | None, out: dict) -> None:
    leaves = {k: v for k, v in node.items() if not isinstance(v, dict)}
    for k, v in node.items():
        if isinstance(v, dict):
            _convert_node(f"{path}{k}.", v, (stats or {}).get(k), out)
    if not leaves:
        return
    keys = set(leaves)
    if "kernel" in keys and keys <= {"kernel", "bias"}:
        kernel = np.asarray(leaves["kernel"])
        if kernel.ndim == 2:
            out[path + "weight"] = _t(kernel.T)
        elif kernel.ndim == 3:
            out[path + "weight"] = _t(kernel.transpose(2, 1, 0))
        else:
            raise ValueError(f"{path}kernel: unsupported rank {kernel.ndim}")
        if "bias" in keys:
            out[path + "bias"] = _t(leaves["bias"])
    elif keys == {"embedding"}:
        out[path + "weight"] = _t(leaves["embedding"])
    elif keys == {"scale", "bias"}:
        out[path + "weight"] = _t(leaves["scale"])
        out[path + "bias"] = _t(leaves["bias"])
        if stats is not None:  # BatchNorm
            out[path + "running_mean"] = _t(stats["mean"])
            out[path + "running_var"] = _t(stats["var"])
            out[path + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    elif all(_LSTM_KEY.match(k) for k in keys):
        for k, v in leaves.items():
            layer, direction, kind = _LSTM_KEY.match(k).groups()
            name = {"wih": "weight_ih", "whh": "weight_hh", "b": "bias"}[kind]
            suffix = "_reverse" if direction == "1" else ""
            out[f"{path}{name}_l{layer}{suffix}"] = _t(v.T if kind != "b" else v)
    elif keys == {"weight", "bias"} or all(_LAS_RAW_KEY.match(k) for k in keys):
        for k, v in leaves.items():
            out[path + k] = _t(v)
    else:
        raise ValueError(f"{path.rstrip('.')}: unrecognised flax leaves {sorted(keys)}")


def state_dict_from_flax(variables_np: dict) -> dict:
    """A torch state dict from a flax ``{"params", "batch_stats"}`` tree of
    numpy arrays (``jax.tree.map(np.asarray, variables)``)."""
    out: dict = {}
    _convert_node("", variables_np["params"], variables_np.get("batch_stats"), out)
    return out


def load_flax_variables(module: nn.Module, variables_np: dict) -> nn.Module:
    """Copy a flax variable tree into ``module``.  Raises unless every flax
    leaf finds a tensor of the same shape and every tensor of the module is
    covered."""
    sd = state_dict_from_flax(variables_np)
    expected = module.state_dict()
    missing, unexpected = sorted(set(expected) - set(sd)), sorted(set(sd) - set(expected))
    if missing or unexpected:
        raise ValueError(f"flax tree does not match the module: missing {missing}, "
                         f"unexpected {unexpected}")
    bad = [f"{k}: {tuple(sd[k].shape)} vs {tuple(v.shape)}"
           for k, v in expected.items() if sd[k].shape != v.shape]
    if bad:
        raise ValueError(f"shape mismatch: {bad}")
    module.load_state_dict(sd)
    return module
