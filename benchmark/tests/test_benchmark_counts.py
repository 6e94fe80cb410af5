"""The yardstick's arithmetic, pinned: the flagship training step's
operations and the joint kernels' roofline bounds at 32 x 10 s, U = 40."""

import json

import pytest

from benchmark import counts
from benchmark.tests import tiny

T = counts.kaldi_frames(160000)
T_ENC = counts.encoder_frames(T)


def test_frames():
    assert (T, T_ENC) == (998, 239)


def test_flops_of_the_flagship_step():
    """``bench.py``'s terms, the joint's vocab projection over the encoder's
    239 output frames (``bench.py`` took 998 // 4 = 249: 23.455 TFLOP)."""
    model = json.loads((tiny.REPO / "benchmark/configs/pika_flagship.json").read_text())["model"]
    shapes = {"batch": 32, "frames": T, "t_enc": T_ENC, "u1": 41, "hid": 1024, "vocab": 6268,
              "nhid": 1024}
    assert counts.train_step_flops(shapes, model) / 1e12 == pytest.approx(22.950, abs=5e-4)


def test_k1_operations_and_bound():
    ops, nbytes = counts.k1_counts(32, T_ENC, 41, 1024, 6268)
    assert ops == pytest.approx(4.025e12, rel=1e-4)
    assert ops / counts.PEAK_BF16_FLOPS > nbytes / counts.PEAK_HBM_BYTES  # compute-bound
    assert counts.least_seconds(ops, nbytes) * 1e3 == pytest.approx(4.070, abs=5e-4)


def test_k23_bound():
    ops, nbytes = counts.k23_counts(32, T_ENC, 41, 1024, 6268)
    assert ops == pytest.approx(3 * 4.025e12, rel=1e-4)
    assert counts.least_seconds(ops, nbytes) * 1e3 == pytest.approx(12.210, abs=5e-4)
