"""WER/CER scoring CLI, Kaldi's ``compute-wer`` (port of
``pika_tpu/decode/score.py``; ``egs/eval_transducer.sh:126-127``):

    python -m pika_tpu_torch.decode.score ref.txt hyp.txt [--char]

Each file holds ``uttid token token ...`` lines; ``--char`` splits every
token into its characters first (the recipe's CER).  Prints the ``%WER``
and ``%SER`` lines, and on stderr a warning when hypothesis ids have no
reference; ``main`` returns the WER.
"""

from __future__ import annotations

import argparse
import sys

from pika_tpu_torch.decode.wer import score_wer


def _read(path: str, char: bool) -> dict:
    out = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            toks = parts[1:]
            if char:
                toks = [c for t in toks for c in t]
            out[parts[0]] = toks
    return out


def main(argv=None) -> float:
    parser = argparse.ArgumentParser(description="WER/CER scoring")
    parser.add_argument("ref")
    parser.add_argument("hyp")
    parser.add_argument("--char", action="store_true", help="score characters")
    args = parser.parse_args(argv)
    wer, c = score_wer(_read(args.ref, args.char), _read(args.hyp, args.char))
    if c["unmatched_hyps"]:
        print(f"WARNING: {c['unmatched_hyps']} hypothesis utterances have "
              "no reference and were not scored — check id formats",
              file=sys.stderr)
    print(f"%WER {wer * 100:.2f} [ {c['errors']} / {c['words']}, "
          f"{c['ins']} ins, {c['del']} del, {c['sub']} sub ]")
    print(f"%SER {c['sent_err'] / max(1, c['sents']) * 100:.2f} [ {c['sent_err']} / {c['sents']} ]")
    return wer


if __name__ == "__main__":
    main()
