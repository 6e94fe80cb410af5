"""What the quality recipes share (``egs/mini_synthetic.sh``,
``egs/mini_grammar.sh``): the recipe's fbank configuration, the prep stage,
a stage runner with the scripts' guards, ``wer_of`` with its per-decode time
limit, the dev sweeps and the ``RESULTS`` file.

Every CLI runs in this process through its own ``main(argv)``, with
``--device`` appended when the recipe names one (without it the CLIs take
the card).  A stage is skipped when its last artifact exists, so a recipe
killed part-way and run again redoes only what it never finished.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import signal
import sys
import time
import traceback
from typing import Callable, Optional

FBANK_CONF = """--window-type=hamming
--sample-frequency=16000
--dither=1.0
--low-freq=40
--high-freq=-200
--num-mel-bins=40
"""

WER_LINE = re.compile(r"%WER [0-9.]+.*")
WER_VALUE = re.compile(r"%WER ([0-9.]+)")


class DecodeTimeout(Exception):
    """A decode ran past its time limit."""


@contextlib.contextmanager
def time_limit(seconds: float):
    """Raise ``DecodeTimeout`` in this thread after ``seconds`` (the scripts'
    ``timeout 1500``).  Signals reach only the main thread: elsewhere the
    body runs without a limit."""
    try:
        previous = signal.signal(signal.SIGALRM, _raise_timeout)
    except ValueError:  # not the main thread
        yield
        return
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


def _raise_timeout(signum, frame):
    raise DecodeTimeout


def set_flags(argv: list, flags: dict) -> list:
    """``argv`` with the value after each flag named in ``flags`` (``{"--tdnn_nhid":
    "32"}``) replaced; flags that ``argv`` does not hold are left out."""
    out = list(argv)
    for i, arg in enumerate(out[:-1]):
        if arg in flags:
            out[i + 1] = str(flags[arg])
    return out


def parse_sets(items) -> dict:
    """``--set NAME=VALUE`` arguments as ``{"--NAME": "VALUE"}``."""
    out = {}
    for item in items or ():
        name, sep, value = item.partition("=")
        if not sep or not name:
            raise ValueError(f"--set takes NAME=VALUE, got {item!r}")
        out["--" + name.lstrip("-")] = value
    return out


class Recipe:
    """One run of a recipe in ``work``: its stages, decodes and results.

    ``device`` (``None``: the card) is passed to every CLI that takes one;
    ``flags`` replaces flag values in every CLI's argv (``set_flags``), the
    only way to shrink a recipe's widths or batches; ``results`` is the
    ``RESULTS`` file, emptied when the recipe starts, as the scripts do
    (kept, and appended to, with ``append``)."""

    def __init__(self, work: str, device: Optional[str] = None, flags: Optional[dict] = None,
                 results: Optional[str] = None, decode_timeout: float = 1500.0,
                 append: bool = False):
        self.work = work
        self.device = device
        self.flags = dict(flags or {})
        self.results = results
        self.decode_timeout = decode_timeout
        self.times = {}  # stage title -> seconds (the stages that ran)
        os.makedirs(work, exist_ok=True)
        if results and not append:
            open(results, "w").close()

    def say(self, msg: str) -> None:
        print(msg, flush=True)

    def result(self, line: str) -> None:
        """Append ``line`` to RESULTS and print it (the scripts' ``tee -a``)."""
        if self.results:
            with open(self.results, "a") as f:
                f.write(line + "\n")
        self.say(line)

    def argv(self, argv: list, device: bool = True) -> list:
        """A CLI's argv with the recipe's flag overrides and its ``--device``."""
        argv = set_flags([str(a) for a in argv], self.flags)
        if device and self.device is not None:
            argv += ["--device", self.device]
        return argv

    def stage(self, title: str, done: Optional[str], fn: Callable[[], object]) -> None:
        """Run ``fn`` unless ``done`` (the stage's last artifact) exists."""
        if done is not None and os.path.exists(done):
            self.say(f"=== {title}: done ({os.path.relpath(done, self.work)} exists) ===")
            return
        self.say(f"=== {title} ===")
        t0 = time.perf_counter()
        fn()
        self.times[title] = time.perf_counter() - t0
        self.say(f"=== {title}: {self.times[title]:.1f} s ===")

    def cli(self, main: Callable, argv: list, device: bool = True):
        """A CLI's ``main`` on the recipe's argv for it."""
        return main(self.argv(argv, device))

    def decode(self, argv: list, out: str) -> None:
        """The decode CLI on ``argv`` with its stdout and stderr in ``out``,
        within the recipe's time limit; a decode that fails or runs out of
        time leaves its traceback in ``out`` and no WER line."""
        from pika_tpu_torch.train.eval_transducer import main as eval_main

        argv = self.argv(argv)
        t0 = time.perf_counter()
        with open(out, "w") as f, contextlib.redirect_stdout(f), contextlib.redirect_stderr(f):
            try:
                with time_limit(self.decode_timeout):
                    eval_main(argv)
            except Exception:  # a failed decode is recorded and skipped, as the scripts do
                traceback.print_exc(file=f)
        self.times[f"decode {os.path.basename(out)}"] = time.perf_counter() - t0

    def wer_line(self, out: str) -> Optional[str]:
        """The last ``%WER`` line of a decode's output, if it has one."""
        if not os.path.exists(out):
            return None
        with open(out) as f:
            found = WER_LINE.findall(f.read())
        return found[-1] if found else None

    def decoded_wer(self, argv: list, out: str) -> Optional[str]:
        """A finished decode's WER text from ``out`` (reused), else the
        decode run now; None, and ``out`` removed so that the next
        invocation retries it, if it fails."""
        if self.wer_line(out) is None:
            self.decode(argv, out)
        line = self.wer_line(out)
        if line is None:
            if os.path.exists(out):
                os.replace(out, out + ".failed")
            return None
        return WER_VALUE.match(line).group(1)

    def wer_of(self, tag: str, argv: list, out: str,
               record_failure: bool = True) -> Optional[float]:
        """``wer_of TAG CMD``: decode (or reuse a finished decode's output)
        and append ``TAG %WER ...`` to RESULTS; a decode that fails is
        recorded as failed (or, without ``record_failure``, only printed, as
        the experiment scripts' ``wer_of`` adds no line), never as a WER."""
        if self.decoded_wer(argv, out) is None:
            if record_failure:
                self.result(f"{tag} decode failed; skipping")
            else:
                self.say(f"{tag} decode failed")
            return None
        line = self.wer_line(out)
        self.result(f"{tag} {line}")
        return float(WER_VALUE.match(line).group(1))

    def sweep(self, label: str, scales, decode_at: Callable[[str], Optional[str]]):
        """The dev sweep of the scripts: ``dev LABEL S -> WER W`` per scale
        (``decode failed; skipping`` where it fails); strictly lower wins,
        the first seen is kept.  Returns (best scale, its WER text) or
        (None, "1e9")."""
        best, best_wer = None, "1e9"
        for s in scales:
            w = decode_at(s)
            if w is None:
                self.result(f"dev {label} {s} -> decode failed; skipping")
                continue
            self.result(f"dev {label} {s} -> WER {w}")
            if float(w) < float(best_wer):
                best, best_wer = s, w
        return best, best_wer


def write_fbank_conf(path: str) -> None:
    with open(path, "w") as f:
        f.write(FBANK_CONF)


def prep_commands(split_dir: str, name: str, conf: str) -> tuple[list, list]:
    """The prep CLI's ``wav_to_seq`` and ``compute_global_cmvn`` argv of
    stages 1-2 for ``split_dir``."""
    return (["wav_to_seq", f"{split_dir}/wav.scp", f"{split_dir}/{name}.mrk",
             f"{split_dir}/{name}.seq"],
            ["compute_global_cmvn", f"{split_dir}/data.lst", f"{split_dir}/global_cmvn.stats",
             "--feat_config", conf])


def wav_to_seq(recipe: Recipe, split_dir: str, name: str, conf: str) -> None:
    """Stage 1 of the recipes: ``wav_to_seq`` of ``split_dir/wav.scp`` into
    ``NAME.mrk``/``NAME.seq`` shards, then ``data.lst`` from its shard lines
    (``mrk seq ark:label.txt``, the scripts' ``awk``)."""
    from pika_tpu_torch.data.prep import main as prep_main

    shards = os.path.join(split_dir, "shards.txt")
    with open(shards, "w") as f, contextlib.redirect_stdout(f):
        recipe.cli(prep_main, prep_commands(split_dir, name, conf)[0])
    label = f"ark:{split_dir}/label.txt"
    tmp = os.path.join(split_dir, "data.lst.tmp")
    with open(shards) as f, open(tmp, "w") as out:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out.write(f"{parts[0]} {parts[1]} {label}\n")
    os.replace(tmp, os.path.join(split_dir, "data.lst"))


def global_cmvn(recipe: Recipe, split_dir: str, name: str, conf: str) -> None:
    """Stage 2 of the recipes: the global CMVN statistics of ``data.lst``
    with the recipe's fbank configuration."""
    from pika_tpu_torch.data.prep import main as prep_main

    recipe.cli(prep_main, prep_commands(split_dir, name, conf)[1])


def epoch_losses(log: str) -> list:
    """The "Overall Avg Loss" of each epoch in a training CLI's log."""
    out = []
    if os.path.exists(log):
        for line in open(log):
            if "Overall Avg Loss:" in line:
                out.append(float(line.split("Overall Avg Loss:")[1].split()[0]))
    return out


def sweep_list(text: str) -> list:
    return [s for s in text.split(",") if s]


def summary(out: dict) -> str:
    """A recipe's result as one JSON line: its WERs, stage times, epoch
    losses and the K1-K3 launches of this process (counted on the card)."""
    from pika_tpu_torch.ops.rnnt_kernels import joint_launches

    return json.dumps({**out, "launches": joint_launches()})


def run_main(main: Callable[[Optional[list]], object]) -> None:
    """A recipe's ``python -m`` entry: exit 1 when ``main`` says it failed."""
    sys.exit(0 if main(None) is not False else 1)
