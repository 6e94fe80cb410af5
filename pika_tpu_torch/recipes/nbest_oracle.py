"""Oracle WER of an N-best file, the rescoring headroom bound (the port's
copy of ``tools/nbest_oracle.py``: the same arguments, the same line).

Any N-best rescorer (LAS fw/bw, an LM rerank) can at best pick the
hypothesis of fewest errors per utterance; this prints that bound beside
the 1-best WER:

    python -m pika_tpu_torch.recipes.nbest_oracle NBEST_FILE ark:labels.txt wav.scp N_BEST \\
        [symbols_map]

With a symbols_map (the ``--symbols_map`` file the decode ran with) the
N-best lines are concatenated symbol strings; they are re-tokenised by
longest match against the symbol inventory and mapped back to ids.
Without one, a line's tokens are its leading integers (the trailing
fields are ``--output_scores``' float scores).
"""

from __future__ import annotations

import re
import sys

from pika_tpu_torch.data.scp import read_int_vectors, read_wav_scp
from pika_tpu_torch.decode.wer import score_wer


def hypothesis_tokens(line: str, sym_inv=None, sym_re=None) -> list:
    """One N-best line's token ids, as strings."""
    parts = line.split()
    if sym_inv is not None:
        text = parts[0] if parts else ""
        return [sym_inv[w] for w in sym_re.findall(text)]
    toks = []
    for p in parts:
        if "." in p or not p.lstrip("-").isdigit():
            break
        toks.append(p)
    return toks


def oracle(nbest_path: str, labels_rspec: str, wav_scp: str, n_best: int,
           symbols_map=None) -> tuple:
    """((1-best WER, counts), (oracle WER, counts)) of an N-best file."""
    sym_inv = sym_re = None
    if symbols_map is not None:
        sym_inv = {}
        for line in open(symbols_map, encoding="utf-8"):
            w, i = line.split()
            sym_inv[w] = i
        sym_re = re.compile("|".join(
            re.escape(w) for w in sorted(sym_inv, key=len, reverse=True)))
    scp = read_wav_scp(wav_scp)
    refs = read_int_vectors(labels_rspec)
    lines = open(nbest_path).read().splitlines()
    if len(lines) != n_best * len(scp):
        raise SystemExit(
            f"{nbest_path}: {len(lines)} lines != {n_best} x {len(scp)} utts")
    o_refs, o_hyps, f_hyps = {}, {}, {}
    for i, utt in enumerate(scp):
        ref = [str(x) for x in refs[utt]]
        best = None
        for j in range(n_best):
            toks = hypothesis_tokens(lines[i * n_best + j], sym_inv, sym_re)
            _, c = score_wer({utt: ref}, {utt: toks})
            if j == 0:
                f_hyps[utt] = toks
            if best is None or c["errors"] < best[0]:
                best = (c["errors"], toks)
        o_refs[utt], o_hyps[utt] = ref, best[1]
    return score_wer(o_refs, f_hyps), score_wer(o_refs, o_hyps)


def oracle_line(n_best: int, first, best) -> str:
    (wer1, c1), (wero, co) = first, best
    return (f"1-best WER {wer1 * 100:.2f}% [{c1['errors']}/{c1['words']}]  "
            f"oracle-{n_best} WER {wero * 100:.2f}% [{co['errors']}/{co['words']}]")


def main(argv=None) -> str:
    argv = sys.argv[1:] if argv is None else argv
    nbest_path, labels_rspec, wav_scp, n_best = argv[0], argv[1], argv[2], int(argv[3])
    line = oracle_line(n_best, *oracle(nbest_path, labels_rspec, wav_scp, n_best,
                                       argv[4] if len(argv) > 4 else None))
    print(line)
    return line


if __name__ == "__main__":
    main()
