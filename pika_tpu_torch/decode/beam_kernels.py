"""The plain beam search's bookkeeping on the card: ``csrc/beam_step.cu``.

A step of the plain beam (no FST fusion) on a CUDA tensor runs the net's
calls (the joint, the prediction net, its joint factors) between four
launches of these kernels, in place of the ~145 small kernels of the torch
body (``decode/beam.py:BeamLoop.torch_body``, the plain version, which the
CPU and the FST-fusion searches run):

* ``select`` (two launches): the loop's condition, duplicate pruning, the
  float32 log-softmax, the masks, the finished candidates with their top-N
  merge and the top-K of the K * V candidates, with ``jax.lax.top_k``'s tie
  rule; the scalars of the state in place;
* ``update`` (one): the buffers gathered by beam in place, the token and
  the alignment step written, the finished store merged, the next joint's
  encoder factors gathered;
* ``commit`` (one): the net's outputs where the beam emitted.

The prediction net's state (``Transducer.dec_state``) goes through the
kernels' fixed slots: ``dec_h`` and ``dec_c`` (the LSTM net's), gathered by
``update`` and written by ``commit`` from ``new_h`` and ``new_c``
(``NET_STATE``).  A state tensor without a slot raises: it would go
ungathered.

Every write is skipped once the device flag ``running`` is false.  On a
CUDA tensor a wrapper launches or raises; a CPU tensor raises (the CPU runs
the torch body).  Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from pika_tpu_torch.ops import cuda_build

# the most the kernels take (csrc/beam_step.cu: kMaxBeam, kMaxBest, kMaxVocab,
# kMaxLayers): beam_size, n_best, the vocabulary (a row's candidates in
# shared memory) and the LSTM prediction net's layers
MAX_BEAM = 32
MAX_NBEST = 32
MAX_VOCAB = 57088
MAX_LAYERS = 8

# csrc/beam_step.cu's enum Slot and enum Dim, in order
SLOTS = ("running", "step", "scores", "t_idx", "lens", "align_lens", "hashes", "tokens", "aligns",
         "fin_scores", "fin_lens", "fin_align_lens", "fin_tokens", "fin_aligns", "enc_lens",
         "ax_all", "gx_all", "dec_ay", "dec_gy", "dec_h", "dec_c",
         "row_key", "fin_cand", "prev_k", "tok", "pos", "apos", "fin_idx", "ax_sel", "gx_sel",
         "logits", "new_ay", "new_gy", "new_h", "new_c")
DIMS = ("B", "K", "N", "V", "Um", "S", "T", "H", "layers", "blank", "prune", "logits_bf16",
        "elem_bytes")
NET_DTYPES = (torch.float32, torch.bfloat16)
# the prediction net's state tensors the kernels carry, each with its commit slot
NET_STATE = {"dec_h": "new_h", "dec_c": "new_c"}


class BeamStep:
    """What the kernels read and write for one search loop: its state and
    inputs (``BeamLoop.state``, ``BeamLoop.inputs``, read and written in
    place), the step's scratch, and the sizes.  Checked once, when made:
    beam and n_best up to ``MAX_BEAM`` and ``MAX_NBEST``, every tensor
    contiguous on one CUDA device in the loop's dtypes, and a slot for
    every tensor of the state."""

    def __init__(self, state: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                 vocab: int, blank: int, sm_scale: float, prune_dups: bool):
        unknown = [name for name in state if name not in SLOTS]
        if unknown:
            raise ValueError(f"beam kernels: no slot for the state's {', '.join(unknown)} (the "
                             f"net's state may hold {', '.join(NET_STATE)})")
        b, k = state["scores"].shape
        n = state["fin_scores"].shape[1]
        if k > MAX_BEAM or n > MAX_NBEST:
            raise ValueError(f"beam kernels: beam_size {k} and n_best {n} must be at most "
                             f"{MAX_BEAM} and {MAX_NBEST}")
        dev = state["scores"].device
        if dev.type != "cuda":
            raise ValueError(f"beam kernels: unsupported device {dev}")
        if not 0 <= blank < vocab <= MAX_VOCAB:
            raise ValueError(f"beam kernels: blank {blank} and a vocabulary of {vocab} (at most "
                             f"{MAX_VOCAB})")
        net_dtype = state["dec_ay"].dtype
        _, t, h = inputs["ax_all"].shape
        if net_dtype not in NET_DTYPES or h * net_dtype.itemsize % 4:
            raise ValueError(f"beam kernels: unsupported net dtype {net_dtype} at width {h} (rows "
                             f"move as 4-byte words)")
        um, s = state["tokens"].shape[2], state["aligns"].shape[2]
        layers = state["dec_h"].shape[0] if "dec_h" in state else 0
        if layers > MAX_LAYERS:
            raise ValueError(f"beam kernels: {layers} LSTM layers, at most {MAX_LAYERS}")
        i32, i64 = dict(dtype=torch.int32, device=dev), dict(dtype=torch.long, device=dev)
        self.scratch = {
            "row_key": torch.zeros(b, k, k, **i64), "fin_cand": torch.zeros(b, k, device=dev),
            "prev_k": torch.zeros(b, k, **i32), "tok": torch.zeros(b, k, **i64),
            "pos": torch.zeros(b, k, **i32), "apos": torch.zeros(b, k, **i32),
            "fin_idx": torch.zeros(b, n, **i32),
            "ax_sel": torch.zeros(b, k, h, dtype=net_dtype, device=dev),
            "gx_sel": torch.zeros(b, k, h, dtype=net_dtype, device=dev)}
        self.tensors = {**state, **inputs, **self.scratch}
        f32, long = torch.float32, torch.long
        self.expect = {  # slot: (dtype, shape) for every tensor the kernels take
            "running": (torch.bool, ()), "step": (long, ()), "scores": (f32, (b, k)),
            "t_idx": (long, (b, k)), "lens": (long, (b, k)), "align_lens": (long, (b, k)),
            "hashes": (long, (b, k)), "tokens": (long, (b, k, um)), "aligns": (long, (b, k, s)),
            "fin_scores": (f32, (b, n)), "fin_lens": (long, (b, n)),
            "fin_align_lens": (long, (b, n)), "fin_tokens": (long, (b, n, um)),
            "fin_aligns": (long, (b, n, s)), "enc_lens": (long, (b,)),
            "ax_all": (net_dtype, (b, t, h)), "gx_all": (net_dtype, (b, t, h)),
            "dec_ay": (net_dtype, (b, k, h)), "dec_gy": (net_dtype, (b, k, h)),
            "dec_h": (net_dtype, (layers, b, k, h)), "dec_c": (net_dtype, (layers, b, k, h)),
            "row_key": (long, (b, k, k)), "fin_cand": (f32, (b, k)),
            "prev_k": (torch.int32, (b, k)), "tok": (long, (b, k)),
            "pos": (torch.int32, (b, k)), "apos": (torch.int32, (b, k)),
            "fin_idx": (torch.int32, (b, n)), "ax_sel": (net_dtype, (b, k, h)),
            "gx_sel": (net_dtype, (b, k, h)), "logits": (net_dtype, (b * k, vocab)),
            "new_ay": (net_dtype, (b * k, h)), "new_gy": (net_dtype, (b * k, h)),
            "new_h": (net_dtype, (layers, b * k, h)), "new_c": (net_dtype, (layers, b * k, h))}
        for name, x in self.tensors.items():
            if name in self.expect:
                self._check(name, x)
        self.device = dev
        self.sm_scale = float(sm_scale)
        sizes = dict(B=b, K=k, N=n, V=vocab, Um=um, S=s, T=t, H=h, layers=layers, blank=blank,
                     prune=int(prune_dups), logits_bf16=int(net_dtype == torch.bfloat16),
                     elem_bytes=net_dtype.itemsize)
        self.dims = (ctypes.c_longlong * len(DIMS))(*(sizes[name] for name in DIMS))

    def _check(self, name: str, x: torch.Tensor) -> None:
        dtype, shape = self.expect[name]
        if x.device != self.tensors["scores"].device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"beam kernels: {name} must be {dtype} {shape} on "
                             f"{self.tensors['scores'].device}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"beam kernels: {name} must be contiguous")

    def reset(self) -> None:
        """The first joint's encoder factors: every beam at frame 0."""
        for sel, full in (("ax_sel", "ax_all"), ("gx_sel", "gx_all")):
            self.scratch[sel].copy_(self.tensors[full][:, :1].expand_as(self.scratch[sel]))

    def launch(self, what: str, entry, *extra, **step_tensors: Optional[torch.Tensor]) -> None:
        """Launch ``entry`` with the loop's tensors, this step's and the
        ``extra`` arguments after them."""
        for name, x in step_tensors.items():
            if x is not None:
                self._check(name, x)
        tensors = {**self.tensors, **step_tensors}
        ptrs = (ctypes.c_void_p * len(SLOTS))(
            *(tensors[name].data_ptr() if tensors.get(name) is not None else None
              for name in SLOTS))
        dev = self.device
        rc = entry(dev.index, torch.cuda.current_stream(dev).cuda_stream, ptrs, self.dims, *extra)
        sizes = ", ".join(f"{name}={value}" for name, value in zip(DIMS, self.dims))
        cuda_build.check(rc, f"beam {what} launch ({sizes})")


def select(step: BeamStep, logits: torch.Tensor) -> None:
    """The step's selection from the joint's logits (B*K, V) in the net's
    dtype: two launches."""
    if logits.device.type != "cuda":
        raise ValueError(f"beam select: unsupported device {logits.device}")
    step.launch("select", cuda_build.library().pika_beam_select, ctypes.c_float(step.sm_scale),
                logits=logits)
    select.launches += 2


def update(step: BeamStep) -> None:
    """The state's gathers by beam, the token and alignment step, the
    finished store and the next joint's encoder factors: one launch."""
    step.launch("update", cuda_build.library().pika_beam_update)
    update.launches += 1


def commit(step: BeamStep, new_ay: torch.Tensor, new_gy: torch.Tensor,
           new_state: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """The prediction net's outputs (B*K, H) and its new state by name
    (``Transducer.advance``'s, each (layers, B*K, H)) where the beam
    emitted: one launch."""
    slots = {}
    for name, x in (new_state or {}).items():
        if name not in NET_STATE:
            raise ValueError(f"beam commit: no slot for the net's state {name}")
        slots[NET_STATE[name]] = x
    if new_ay.device.type != "cuda":
        raise ValueError(f"beam commit: unsupported device {new_ay.device}")
    step.launch("commit", cuda_build.library().pika_beam_commit, new_ay=new_ay, new_gy=new_gy,
                **slots)
    commit.launches += 1


select.launches = 0
update.launches = 0
commit.launches = 0


def launches() -> Dict[str, int]:
    """The wrappers' launch counts."""
    return {"select": select.launches, "update": update.launches, "commit": commit.launches}
