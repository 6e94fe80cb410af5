"""Standalone N-best rerank CLI (the port's own copy of
``pika_tpu/decode/rerank.py``, host code only; the reference's
``egs/local/nbest_rerank.py``).

Consumes the N-best text files written by the decode CLI (format: ``hyp
rnnt_score [fw_tok_scores...] [bw_tok_scores...]`` per line, N lines per
utterance) and writes the best hypothesis per utterance after
length-normalized score fusion.

    python -m pika_tpu_torch.decode.rerank in_nbest out_hyp --nbest 8 \
        [--las_rescore] [--las_dirs both|fw|bw] [--ids] \
        [--rnnt_score_scale 1.0] \
        [--las_fw_score_scale 0.3] [--las_bw_score_scale 0.7]

``--ids`` parses hypotheses written WITHOUT ``--symbols_map`` (token ids
space-separated); the default expects the reference's single-field text
hypotheses.  ``--las_dirs`` must say which rescorer directions the file
carries — a file produced with only a forward LAS model must not be
split in half between fw and bw weights.
"""

from __future__ import annotations

import argparse
import re
import sys

_INT = re.compile(r"^-?\d+$")


def _split_line(parts, ids: bool, empty_hyp_len: int, ndirs: int, where: str):
    """Return (hyp_tokens, score_fields).

    Token-id mode: the line is ``tok*ntok rnnt_score`` plus, per LAS
    direction, ``ntok+1`` per-token scores — so the field count alone
    determines ntok: ``F = ntok + 1 + ndirs*(ntok+1)``.  Deriving ntok
    from F (instead of greedily eating leading integer-looking fields) is
    robust to scores serialized as bare integers by other writers, and
    any inconsistency is raised, not silently mis-columned."""
    if ids:
        denom = 1 + ndirs
        rem = len(parts) - 1 - ndirs
        if rem < 0 or rem % denom:
            raise ValueError(
                f"{where}: {len(parts)} fields is not consistent with "
                f"'ntok ids + 1 rnnt score + {ndirs} x (ntok+1) LAS "
                f"scores' — wrong --las_dirs / --las_rescore for this file?")
        ntok = rem // denom
        bad = [p for p in parts[:ntok] if not _INT.match(p)]
        if bad:
            raise ValueError(
                f"{where}: expected {ntok} integer token ids by field "
                f"count but found non-integer field(s) {bad[:3]} — "
                f"wrong --las_dirs / --las_rescore for this file?")
        return parts[:ntok], parts[ntok:]
    if len(parts) <= empty_hyp_len:  # scores-only line: empty hypothesis
        return [], parts
    return list(parts[0].replace("<unk>", " ")), parts[1:]


def rerank_file(
    in_hyp: str,
    out_hyp: str,
    nbest: int,
    las_rescore: bool = False,
    rnnt_score_scale: float = 1.0,
    las_fw_score_scale: float = 0.3,
    las_bw_score_scale: float = 0.7,
    las_dirs: str = "both",
    ids: bool = False,
) -> None:
    if las_dirs not in ("both", "fw", "bw"):
        raise ValueError(f"las_dirs must be both/fw/bw, got {las_dirs!r}")
    # an empty hypothesis still carries one per-token score per direction
    # (the EOS/SOS position), so a scores-only line has 1 + #dirs fields
    ndirs = {"both": 2, "fw": 1, "bw": 1}[las_dirs] if las_rescore else 0
    empty_hyp_len = 1 + ndirs
    with open(in_hyp, "r", encoding="utf-8") as in_f, \
         open(out_hyp, "w", encoding="utf-8") as out_f:
        cur = 0
        lineno = 0
        hyp_score = []
        for line in in_f:
            lineno += 1
            parts = line.split()
            toks, rest = _split_line(parts, ids, empty_hyp_len, ndirs,
                                     f"{in_hyp}:{lineno}")
            if not rest:
                raise ValueError(f"{in_hyp}:{lineno}: no score fields")
            score = rnnt_score_scale * float(rest[0])
            if las_rescore:
                sc = [float(s) for s in rest[1:]]
                if las_dirs == "both":
                    if len(sc) % 2:
                        raise ValueError(
                            f"{in_hyp}:{lineno}: odd LAS score count "
                            f"{len(sc)} with --las_dirs both; if the file "
                            "was decoded with a single rescorer direction "
                            "pass --las_dirs fw (or bw)")
                    fw, bw = sum(sc[: len(sc) // 2]), sum(sc[len(sc) // 2:])
                elif las_dirs == "fw":
                    fw, bw = sum(sc), 0.0
                else:
                    fw, bw = 0.0, sum(sc)
                score += las_fw_score_scale * fw + las_bw_score_scale * bw
            norm = 0.001 if not toks else len(toks)
            hyp_score.append((-score / norm, toks))
            cur += 1
            if cur == nbest:
                hyp_score.sort(key=lambda x: x[0])
                out_f.write(" ".join(hyp_score[0][1]) + "\n")
                cur = 0
                hyp_score = []
        if cur:
            # a trailing short group (truncated file or wrong --nbest) must
            # not vanish silently: flush its best and say so
            print(f"rerank: WARNING: trailing group of {cur} lines "
                  f"(< nbest={nbest}) in {in_hyp} — flushed anyway; "
                  "check --nbest against the decode's --n_best",
                  file=sys.stderr)
            hyp_score.sort(key=lambda x: x[0])
            out_f.write(" ".join(hyp_score[0][1]) + "\n")


def main(argv=None):
    parser = argparse.ArgumentParser(description="rerank an N-best list")
    parser.add_argument("in_hyp")
    parser.add_argument("out_hyp")
    parser.add_argument("--nbest", type=int, required=True)
    parser.add_argument("--las_rescore", action="store_true")
    parser.add_argument("--las_dirs", choices=("both", "fw", "bw"),
                        default="both",
                        help="which LAS directions the per-token score "
                             "columns carry (decode with only "
                             "--las_rescorer_model writes fw only)")
    parser.add_argument("--ids", action="store_true",
                        help="hypotheses are space-separated token ids "
                             "(decode ran without --symbols_map)")
    parser.add_argument("--rnnt_score_scale", type=float, default=1.0)
    parser.add_argument("--las_fw_score_scale", type=float, default=0.3)
    parser.add_argument("--las_bw_score_scale", type=float, default=0.7)
    args = parser.parse_args(argv)
    rerank_file(args.in_hyp, args.out_hyp, args.nbest, args.las_rescore,
                args.rnnt_score_scale, args.las_fw_score_scale,
                args.las_bw_score_scale, args.las_dirs, args.ids)


if __name__ == "__main__":
    main()
