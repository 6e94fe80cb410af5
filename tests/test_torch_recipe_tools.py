"""The port's copies of the quality recipes' tools against the JAX tools, on
the same arguments: ``pika_tpu_torch.recipes.hard_corpus`` writes the same
bytes as ``tools/make_hard_corpus.py`` (every wav, label archive, the noise
archive and list, the symbol table and the grammar text; the output
directory substituted in the lists that name it), and
``pika_tpu_torch.recipes.train_ngram`` the same ARPA as
``tools/train_ngram.py``."""

import os
import subprocess
import sys

import pytest
import torch

from pika_tpu_torch.recipes import hard_corpus, train_ngram

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {
    "uniform": ["--train", "4", "--test", "3"],
    "grammar": ["--train", "1", "--test", "3", "--seed", "4047", "--grammar_branching", "6",
                "--grammar_split", "test", "--grammar_text", "20", "--test_snr", "5,15"],
}
# the files that hold paths under the output directory
PATH_LISTS = ("noise.lst", "wav.scp")


def _jax_tool(script, *argv, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", script), *argv], env=env,
                       cwd=cwd, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Each case's corpus from the JAX tool (a subprocess) and from the port."""
    root = tmp_path_factory.mktemp("corpora")
    out = {}
    for case, argv in CASES.items():
        jax_dir, pt_dir = str(root / f"{case}_jax"), str(root / f"{case}_pt")
        _jax_tool("make_hard_corpus.py", jax_dir, *argv, cwd=str(root))
        hard_corpus.main([pt_dir, *argv])
        out[case] = (jax_dir, pt_dir)
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


@pytest.mark.parametrize("case", list(CASES))
def test_corpus_bytes_equal_the_jax_tool(corpora, case):
    jax_dir, pt_dir = corpora[case]
    files = _files(jax_dir)
    assert files == _files(pt_dir)
    assert sum(f.endswith(".wav") for f in files) >= 7  # train, test and its clean copy
    for rel in files:
        want = open(os.path.join(jax_dir, rel), "rb").read()
        got = open(os.path.join(pt_dir, rel), "rb").read()
        if os.path.basename(rel) in PATH_LISTS:
            want = want.replace(jax_dir.encode(), pt_dir.encode())
        assert got == want, rel
    assert ("grammar_text.txt" in files) == (case == "grammar")


def test_ngram_arpa_bytes_equal_the_jax_tool(corpora, tmp_path):
    _, pt_dir = corpora["grammar"]
    args = [f"ark:{pt_dir}/grammar_text.txt", f"{pt_dir}/char.txt"]
    _jax_tool("train_ngram.py", *args, str(tmp_path / "jax.arpa"), cwd=str(tmp_path))
    train_ngram.main([*args, str(tmp_path / "pt.arpa")])
    arpa = (tmp_path / "pt.arpa").read_bytes()
    assert arpa == (tmp_path / "jax.arpa").read_bytes()
    assert b"\\2-grams:" in arpa and arpa.count(b"\n") > 30
