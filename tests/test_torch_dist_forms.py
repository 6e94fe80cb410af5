"""The port's distributed training CLI on its own, on the ``--loader utt``
corpus of ``tests/test_torch_dist_cli.py`` with the rnn encoder and
``--dp_mode bmuf``:

* the two-process form (``--coordinator_address 127.0.0.1:<port>
  --num_processes 2 --process_id 0|1``, one rank each, two subprocesses
  with a timeout) gives the one-command form's (``--num_devices 2``, two
  spawned ranks) parameters and losses bit for bit;
* a ``--resume`` after epoch 0 (one rank, in process) equals 2 straight
  epochs bit for bit: losses, weights, ``delta_prev`` and the step count;
* a non-finite round (NaN features) exits 1 with the JAX CLI's line "NaN
  detected in BMUF sync — stopping" and writes no bundle;
* a launch that cannot be laid out raises before any work.
"""

import os
import re
import shutil
import socket
import subprocess
import sys

import pytest
import torch

from pika_tpu_torch.train.bundle import load_bundle
from pika_tpu_torch.train.checkpoint import restore_checkpoint
from pika_tpu_torch.train.train_transducer import main as train_main
from test_torch_dist_cli import BMUF, N_UTTS, RNN, _argv, _corpus, _losses, rnn_corpus  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(bundle) -> dict:
    model, _ = load_bundle(str(bundle), device="cpu")
    return model.state_dict()


def test_two_process_form_equals_one_command(rnn_corpus, tmp_path):
    d = rnn_corpus
    train_main(_argv(d, "one", *BMUF, "--device", "cpu"))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # the multi-host form names its TCP port, so the test probes one; a port
    # taken between the probe and rank 0's bind is probed again
    for _ in range(3):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "pika_tpu_torch.train.train_transducer",
             *_argv(d, "two", *BMUF, "--device", "cpu", "--coordinator_address",
                    f"127.0.0.1:{port}", "--num_processes", "2", "--process_id", str(i))],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for i in (0, 1)]
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
        if not any("EADDRINUSE" in out or "address already in use" in out for out in outs):
            break
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    one, two = _params(d / "one" / "model.epoch.0"), _params(d / "two" / "model.epoch.0")
    for k, x in one.items():
        assert torch.equal(x, two[k]), k
    assert _losses((d / "one.1.log").read_text()) == _losses((d / "two.1.log").read_text())
    assert _losses((d / "one.0.log").read_text()) == _losses((d / "two.0.log").read_text())


def test_bmuf_resume_equals_straight_epochs(rnn_corpus, tmp_path):
    """One rank in process: 2 epochs straight, then the run cut back to its
    epoch-0 checkpoint and resumed: the same losses, weights, block state
    and step count, bit for bit."""
    d = rnn_corpus
    flags = [*BMUF, "--device", "cpu", "--num_devices", "1", "--num_epochs", "2",
             "--block_momentum", "0.9"]
    argv = _argv(d, "x", *flags)
    train_main([argv[0], str(tmp_path / "full.log"), str(tmp_path / "full"), *argv[3:]])
    shutil.copytree(tmp_path / "full", tmp_path / "part")
    shutil.rmtree(tmp_path / "part" / "ckpt" / "1")
    shutil.rmtree(tmp_path / "part" / "model.epoch.1")
    train_main([argv[0], str(tmp_path / "resumed.log"), str(tmp_path / "part"), *argv[3:],
                "--resume"])
    full, resumed = ((tmp_path / f"{k}.log").read_text() for k in ("full", "resumed"))
    saved = restore_checkpoint(str(tmp_path / "full" / "ckpt"), 0)
    steps0 = saved["bmuf"]["steps"]
    assert steps0 == N_UTTS  # batch 1 on one rank: 8 rounds of 2 steps
    assert f"resumed BMUF state from epoch 0 (step {steps0})" in resumed
    overall = lambda text: re.findall(r"Overall Avg Loss: (\S+)", text)
    assert overall(resumed) == overall(full)[1:]
    a = restore_checkpoint(str(tmp_path / "full" / "ckpt"), 1)
    b = restore_checkpoint(str(tmp_path / "part" / "ckpt"), 1)
    assert a["bmuf"]["steps"] == b["bmuf"]["steps"] == 2 * steps0
    assert len(a["bmuf"]["delta_prev"]) > 0
    for x, y in zip(a["bmuf"]["delta_prev"], b["bmuf"]["delta_prev"]):
        assert torch.equal(x, y)
    for k, x in a["model"].items():
        assert torch.equal(x, b["model"][k]), k


def test_nan_round_exits_1(tmp_path):
    """One rank in process (the round's collective runs in a world of
    one)."""
    _corpus(tmp_path, "rnn", RNN, nan=True)
    with pytest.raises(SystemExit) as exc:
        train_main(_argv(tmp_path, "nan", *BMUF, "--device", "cpu", "--num_devices", "1"))
    assert exc.value.code == 1
    log = (tmp_path / "nan.0.log").read_text()
    assert log.rstrip().endswith("NaN detected in BMUF sync — stopping"), log[-500:]
    assert not (tmp_path / "nan" / "model.epoch.0").exists()


@pytest.mark.parametrize("flags,what", [
    (["--num_processes", "2"], "needs --coordinator_address"),
    (["--num_devices", "3", "--num_processes", "2", "--coordinator_address", "127.0.0.1:1"],
     "does not split"),
    (["--num_processes", "2", "--process_id", "2", "--coordinator_address", "127.0.0.1:1"],
     "outside")])
def test_invalid_launch_raises(flags, what, tmp_path):
    """A launch that cannot be laid out raises before any work."""
    with pytest.raises(ValueError, match=what):
        train_main(["data.lst", str(tmp_path / "log"), str(tmp_path / "out"), "--device", "cpu",
                    *flags])
