"""The port's scoring CLI (``python -m pika_tpu_torch.decode.score``)
against the JAX package's on the same reference and hypothesis files: the
same stdout, character for character, the same returned WER, and the same
warning on stderr for a hypothesis id without a reference."""

import subprocess
import sys

import pytest

from pika_tpu.decode.score import main as score_main_jax
from pika_tpu_torch.decode.score import main as score_main

REF = ["utt1 the cat sat", "utt2 a dog", "utt3 hello world again", "utt4 空気 読む"]
HYP = ["utt1 the cat sat", "utt2 a big dog", "utt3 hallo world", "utt4 空気 読"]


@pytest.fixture
def files(tmp_path):
    ref, hyp, extra = tmp_path / "ref.txt", tmp_path / "hyp.txt", tmp_path / "extra.txt"
    ref.write_text("\n".join(REF) + "\n\n", encoding="utf-8")
    hyp.write_text("\n".join(HYP) + "\n", encoding="utf-8")
    extra.write_text("\n".join(HYP[:2] + ["utt9 stray words"]) + "\n", encoding="utf-8")
    return ref, hyp, extra


@pytest.mark.parametrize("hyp_name,char", [("hyp", False), ("hyp", True), ("extra", False),
                                           ("extra", True)])
def test_score_matches_jax(files, capsys, hyp_name, char):
    ref, hyp, extra = files
    argv = [str(ref), str(hyp if hyp_name == "hyp" else extra)] + (["--char"] if char else [])
    wer_ref = score_main_jax(argv)
    out_ref = capsys.readouterr()
    wer = score_main(argv)
    out = capsys.readouterr()
    assert wer == wer_ref and 0 < wer < 1
    assert out.out == out_ref.out
    assert out.err == out_ref.err
    assert out.out.startswith("%WER ") and "\n%SER " in out.out
    assert ("WARNING: 1 hypothesis utterances have no reference" in out.err) == (
        hyp_name == "extra")


def test_score_module_runs(files):
    """``python -m pika_tpu_torch.decode.score``: exit 0, the WER line."""
    ref, hyp, _ = files
    run = subprocess.run([sys.executable, "-m", "pika_tpu_torch.decode.score", str(ref),
                          str(hyp), "--char"], capture_output=True, text=True, timeout=60)
    assert run.returncode == 0, run.stderr
    assert run.stdout.startswith("%WER ")
