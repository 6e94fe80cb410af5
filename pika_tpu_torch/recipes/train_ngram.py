"""Estimate a bigram ARPA LM from integer transcripts (the port's copy of
``tools/train_ngram.py``; it writes the same bytes).

Witten-Bell interpolated bigrams over a label archive, written as standard
ARPA that ``pika_tpu_torch.decode.fst.compile_arpa`` (and any other ARPA
consumer) reads, for FST shallow fusion in the quality recipes.  Words are
the symbol-table names (char.txt: ``w<k> <k>``) plus ``<s>``/``</s>``;
probabilities are log10 per the ARPA convention.

Usage:
  python -m pika_tpu_torch.recipes.train_ngram ark:train/label.txt char.txt out.arpa
"""

from __future__ import annotations

import argparse
import math
from collections import Counter, defaultdict

from pika_tpu_torch.data.scp import read_int_vectors, read_symbol_table


def main(argv=None):
    ap = argparse.ArgumentParser(description="Witten-Bell bigram ARPA from integer transcripts")
    ap.add_argument("labels", help="label rspec, e.g. ark:train/label.txt")
    ap.add_argument("symbols", help="symbol table (char.txt: name id)")
    ap.add_argument("out", help="output ARPA path")
    args = ap.parse_args(argv)

    id_to_sym = read_symbol_table(args.symbols)
    labels = read_int_vectors(args.labels)

    BOS, EOS = "<s>", "</s>"

    def word(tok):
        return id_to_sym[int(tok)]

    uni = Counter()
    bi = Counter()
    following = defaultdict(set)  # distinct successor types per context
    for toks in labels.values():
        seq = [BOS] + [word(t) for t in toks] + [EOS]
        for w in seq[1:]:
            uni[w] += 1
        for a, b in zip(seq, seq[1:]):
            bi[(a, b)] += 1
            following[a].add(b)
    uni[BOS] = 0  # <s> has no unigram probability mass (context only)

    vocab = sorted(uni, key=lambda w: (w not in (BOS, EOS), w))
    vocab = [BOS, EOS] + [w for w in vocab if w not in (BOS, EOS)]
    total = sum(uni.values())
    n_types = sum(1 for w in vocab if w != BOS)

    # Witten-Bell interpolated: p(w|a) = lam*ML + (1-lam)*p(w), with
    # lam = c(a) / (c(a) + T(a)) and T(a) the distinct-successor count.
    # Unigrams get add-one so unseen words (none here, closed vocab) and
    # <s>-context backoff stay proper.
    def p_uni(w):
        if w == BOS:
            return 1e-99
        return (uni[w] + 1.0) / (total + n_types)

    ctx_count = Counter()
    for (a, _b), c in bi.items():
        ctx_count[a] += c

    lines_1, lines_2 = [], []
    for w in vocab:
        lp = math.log10(p_uni(w))
        # backoff weight: with interpolated WB bigrams the leftover mass is
        # (1-lam)(1-S) where S = sum of p_uni over seen successors, and the
        # backoff path distributes bow*p_uni over the unseen set (mass
        # bow*(1-S)) — so bow = 1-lam exactly and the model normalizes
        if w in ctx_count:
            lam = ctx_count[w] / (ctx_count[w] + len(following[w]))
            bow = math.log10(max(1.0 - lam, 1e-12))
        else:
            bow = 0.0
        lines_1.append(f"{lp:.6f}\t{w}\t{bow:.6f}")
    for (a, b), c in sorted(bi.items()):
        lam = ctx_count[a] / (ctx_count[a] + len(following[a]))
        p = lam * c / ctx_count[a] + (1.0 - lam) * p_uni(b)
        lines_2.append(f"{math.log10(p):.6f}\t{a} {b}")

    with open(args.out, "w") as f:
        f.write("\\data\\\n")
        f.write(f"ngram 1={len(lines_1)}\n")
        f.write(f"ngram 2={len(lines_2)}\n\n")
        f.write("\\1-grams:\n")
        f.write("\n".join(lines_1) + "\n\n")
        f.write("\\2-grams:\n")
        f.write("\n".join(lines_2) + "\n\n")
        f.write("\\end\\\n")
    print(f"wrote {args.out}: {len(lines_1)} unigrams, {len(lines_2)} bigrams "
          f"over {total} tokens")


if __name__ == "__main__":
    main()
