"""Runs of each cell on the CPU at a test's size (``tiny.py``; the cells
read from ``BENCHMARK.json`` by the kind of their mix), the
harness's look for a card skipped, with the timed path broken underneath:
``correct`` has to come out false, once for each fault the cell can have.
And the controls: the lower precision, put in the program's place, reads
over the limits too."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import calibrate, harness, program
from benchmark.tests import tiny
from pika_tpu_torch.decode import beam
from pika_tpu_torch.train import lr

TRAINS = tiny.cells("train")
DECODES = tiny.cells("decode")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("bench"))


def run_cell(root, workload, seed=2 ** 31 + 17):
    ctx = harness.make_ctx(root, workload, seed, "cpu")
    return harness.run(ctx, 0.3, False, time.perf_counter())


def half_batch_step(make):
    """A step that leaves half of the batch out and takes the mean over the
    rest: the first half's rows twice."""
    def wrapped(*args, **kw):
        step = make(*args, **kw)

        def half(batch, gen):
            h = batch["wavs"].shape[0] // 2
            return step({k: torch.cat([v[:h], v[:h]]) for k, v in batch.items()}, gen)
        return half
    return wrapped


def half_batch_search(search):
    """A search that decodes the first half of the batch and serves its
    answers for every row."""
    def wrapped(model, feats, feat_lens, cfg):
        h = feats.shape[0] // 2
        out = search(model, torch.cat([feats[:h], feats[:h]]),
                     torch.cat([feat_lens[:h], feat_lens[:h]]), cfg)
        return out
    return wrapped


def altered_token(result):
    """The first hypothesis of a batch that holds a label has that label
    changed where the search produces it, in its tokens and its alignment
    alike."""
    def wrapped(self):
        out = result(self)
        vocab = self.net.config.vocab_size
        held = (out["lens"] > 0).nonzero()
        if len(held):
            b, n = (int(x) for x in held[0])
            a = out["aligns"][b, n]
            first = int((a > 0).nonzero()[0, 0])
            new = (int(a[first]) % (vocab - 1)) + 1
            out["aligns"][b, n, first] = new
            out["tokens"][b, n, 0] = new
        return out
    return wrapped


def stop_at_once(self):
    """A loop step that leaves the state as it was and ends the search."""
    self.state["running"].fill_(False)


@pytest.mark.parametrize("workload", TRAINS)
def test_train_sound_runs(root, workload):
    result = run_cell(root, workload)
    assert all(c["value"] < 1.0 for c in result["checks"].values())


@pytest.mark.parametrize("workload", TRAINS)
def test_train_state_unchanged(root, workload, monkeypatch):
    monkeypatch.setattr(lr.Optimizer, "step", lambda self: None)
    result = run_cell(root, workload)
    assert result["checks"]["delta_gap"]["value"] == pytest.approx(1.0)
    assert result["correct"] is False


@pytest.mark.parametrize("workload", TRAINS)
def test_train_half_batch(root, workload, monkeypatch):
    monkeypatch.setattr(program, "make_train_step", half_batch_step(program.make_train_step))
    assert run_cell(root, workload)["correct"] is False


@pytest.mark.parametrize("workload", DECODES)
def test_decode_sound_run(root, workload):
    assert run_cell(root, workload)["correct"] is True


@pytest.mark.parametrize("workload", DECODES)
@pytest.mark.parametrize("fault", ["token", "half_batch", "unchanged"])
def test_decode_faults(root, workload, fault, monkeypatch):
    if fault == "token":
        monkeypatch.setattr(beam.BeamLoop, "result", altered_token(beam.BeamLoop.result))
    elif fault == "half_batch":
        monkeypatch.setattr(program, "beam_search_features",
                            half_batch_search(program.beam_search_features))
    else:
        monkeypatch.setattr(beam.BeamLoop, "body", stop_at_once)
    assert run_cell(root, workload)["correct"] is False


@pytest.mark.parametrize("workload", TRAINS)
def test_train_control_fails(root, workload):
    """The program's bf16 path and the half-batch reference read above the
    cell's limits."""
    limits = harness.make_ctx(root, workload, 1, "cpu").limits
    ctx = harness.make_ctx(root, workload, 2 ** 31 + 3, "cpu")
    row = calibrate.train_seed(ctx, control=True, fault=True)
    for kind in ("control", "half_batch"):
        assert any(row[kind][k] > limits[k] for k in limits), (kind, row)


@pytest.mark.parametrize("workload", DECODES)
def test_decode_control_fails(root, workload):
    limits = harness.make_ctx(root, workload, 1, "cpu").limits
    ctx = harness.make_ctx(root, workload, 2 ** 31 + 3, "cpu")
    row = calibrate.decode_seed(ctx, control=True)
    assert row["control"]["score_gap"] > limits["score_gap"], row
