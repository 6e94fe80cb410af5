"""Batch decoding CLI (port of ``pika_tpu/train/eval_transducer.py``).

Reads a model bundle (``train/bundle.py``), decodes a wav.scp with features
computed on the device (or, with ``--loader utt``, a feats.scp/.ark of
precomputed features, spliced, strided and normalized on the host),
optionally with n-gram FST shallow fusion
(``--fst_lm``: an ARPA LM, a binary OpenFst or an AT&T text FST), rescores
the N-best with forward and backward LAS rescorers
(``--las_rescorer_model``, ``--las_rescorer_bw_model``: bundles of kind
``las``, ``decode/rescore.py``), writes the N-best hypotheses in the
reference's format (with ``--output_scores`` the RNN-T score and the LAS
per-token scores), then reranks and, given references, scores the WER
(also once per ``--las_scale_sweep`` pair of LAS weights):

    python -m pika_tpu_torch.train.eval_transducer BUNDLE wav.scp nbest.txt \\
        --ref_labels ark:label.txt --beam_size 8 --n_best 8 \\
        --fst_lm lm.arpa --symbols_map units.txt --fst_lm_scale 0.5 \\
        --las_rescorer_model LAS_FW --las_rescorer_bw_model LAS_BW --SOS 0 --EOS 6268

The decode runs on the card unless ``--device cpu``.  Waveform batches are
padded to ``--batch_size`` rows of ``--max_wav_seconds``, so one shape (one
CUDA graph of the search) serves the run; feature batches are padded to
the loader's frame buckets.  ``--attn_chunk`` overrides the bundle's
encoder attention chunking.
"""

from __future__ import annotations

import argparse
import queue
import sys
import threading
import time

import numpy as np
import torch

from pika_tpu_torch.data import segment as seg
from pika_tpu_torch.data.scp import read_int_vectors, read_symbol_table, read_wav_scp
from pika_tpu_torch.data.wavio import read_wav
from pika_tpu_torch.decode.beam import BeamConfig, beam_search_features, beam_search_waveforms
from pika_tpu_torch.decode.fst import compile_arpa, read_openfst_binary, read_text_fst
from pika_tpu_torch.decode.rescore import las_score_hyps, rerank_nbest
from pika_tpu_torch.decode.wer import score_wer
from pika_tpu_torch.device import resolve_device
from pika_tpu_torch.train import common
from pika_tpu_torch.train.bundle import load_bundle


def build_parser():
    parser = argparse.ArgumentParser(description="transducer batch decoding")
    parser.add_argument("model", type=str, help="model bundle directory")
    parser.add_argument("wav_scp", type=str, help="wav.scp")
    parser.add_argument("output_file", type=str)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of the decode (default: the CUDA card)")
    parser.add_argument("--loader", type=str, default="otf", choices=["otf", "utt"],
                        help="otf: decode raw audio with on-device features; utt: "
                             "decode precomputed feature archives (wav_scp is then a "
                             "feats.scp or .ark)")
    parser.add_argument("--symbols_map", type=str, default=None)
    parser.add_argument("--ref_labels", type=str, default=None,
                        help="label.txt for WER scoring")
    parser.add_argument("--attn_chunk", type=int, default=-1,
                        help="override the bundle's encoder attention chunking (-1 keeps "
                             "it, 0 forces full attention, > 0 query blocks of this size)")
    parser.add_argument("--beam_size", type=int, default=8)
    parser.add_argument("--n_best", type=int, default=8)
    parser.add_argument("--blk", type=int, default=0)
    parser.add_argument("--sm_scale", type=float, default=1.0)
    parser.add_argument("--max_symbols", type=int, default=220)
    parser.add_argument("--fst_lm", type=str, default="",
                        help="n-gram FST shallow fusion: a binary OpenFst, a text FST, or an "
                             ".arpa LM (with --symbols_map)")
    parser.add_argument("--backoff_id", type=int, default=0)
    parser.add_argument("--disambig_ids", type=str, default="",
                        help="comma separated disambig label ids")
    parser.add_argument("--fst_lm_scale", type=float, default=1.0)
    parser.add_argument("--nonblk_reward", type=float, default=0.0)
    parser.add_argument("--max_fst_states", type=int, default=4)
    parser.add_argument("--fst_fusion", type=str, default="per_token",
                        choices=["per_token", "per_beam"],
                        help="per_token (default) scores each candidate token with its "
                             "advanced LM score; per_beam is the reference's prefix-LM bias "
                             "with the winners' state sets advanced after selection")
    parser.add_argument("--fst_per_token", action="store_true",
                        help="alias for --fst_fusion per_token")
    parser.add_argument("--fst_topm", type=int, default=0,
                        help="non-blank candidates per beam scored with their advanced LM "
                             "score in per-token fusion; 0 (default) scores every token "
                             "through the dense advance cache, and falls back to 8 when no "
                             "cache fits (--fst_cache_mb 0 or an LM too big)")
    parser.add_argument("--fst_cache_mb", type=int, default=512,
                        help="budget (MB) of the host-built dense advance cache (n_states x "
                             "vocab x Lm) that turns the per-step backoff walks into one "
                             "gather; 0 disables it")
    parser.add_argument("--fst_cache_file", type=str, default="",
                        help="keep the advance cache on disk across runs ('auto' = "
                             "<fst_lm>.advcache.npz), keyed by a content fingerprint of the "
                             "compiled tables; the JAX CLI reads the same file")
    parser.add_argument("--las_rescorer_model", type=str, default=None,
                        help="forward LAS rescorer bundle")
    parser.add_argument("--las_rescorer_bw_model", type=str, default=None,
                        help="backward LAS rescorer bundle (trained with --reverse_labels)")
    parser.add_argument("--las_input", type=str, default="auto",
                        choices=["auto", "enc", "feats"],
                        help="what the LAS rescorer consumes: the transducer encoder output "
                             "(enc, the shared-encoder rescorer) or the decode features "
                             "(feats); auto reads the bundle's las_input metadata, then "
                             "matches input_dim, and raises on a tie")
    parser.add_argument("--rnnt_score_scale", type=float, default=1.0)
    parser.add_argument("--las_fw_score_scale", type=float, default=0.3)
    parser.add_argument("--las_bw_score_scale", type=float, default=0.7)
    parser.add_argument("--las_scale_sweep", type=str, default="",
                        help="comma-separated fw:bw pairs, e.g. '0.3:0.7,0.5:0.5': one "
                             "decode, a WER line per pair (needs --ref_labels)")
    parser.add_argument("--output_scores", action="store_true")
    parser.add_argument("--min_len", type=int, default=0,
                        help="minimum feature frames; short utterances are edge-padded")
    parser.add_argument("--cmvn_stats", type=str, default=None)
    parser.add_argument("--cmn", action="store_true")
    parser.add_argument("--decode_dtype", type=str, default="auto",
                        choices=["auto", "bfloat16", "float32"],
                        help="matmul dtype inside the decode loop: auto = bf16 on the "
                             "card, float32 on the CPU; scores and softmax stay float32")
    common.add_loader_args(parser)
    return parser


def select_las_input(flag: str, meta: dict, input_dim: int, enc_dim: int,
                     feat_dim: int) -> str:
    """Which tensor the LAS rescorer consumes: ``"enc"`` (the transducer
    encoder's output, the shared-encoder rescorer) or ``"feats"`` (a LAS with
    its own encoder).  The ``--las_input`` flag wins, then the bundle's
    ``las_input`` metadata, then ``input_dim`` matching; a tie with no
    recorded kind raises, and so does a kind whose width is not the
    rescorer's ``input_dim``."""
    kind = flag
    if kind == "auto":
        kind = meta.get("las_input", "auto")
    if kind == "auto":
        if input_dim == enc_dim and input_dim == feat_dim:
            raise ValueError(
                f"LAS rescorer input_dim {input_dim} matches BOTH the "
                "transducer encoder output and the decode features, and "
                "the bundle records no las_input kind; pass "
                "--las_input enc|feats")
        if input_dim == enc_dim:
            kind = "enc"
        elif input_dim == feat_dim:
            kind = "feats"
        else:
            raise ValueError(
                f"LAS rescorer input_dim {input_dim} matches neither the "
                f"transducer encoder output ({enc_dim}) nor the decode "
                f"features ({feat_dim}); decode feature flags must match "
                "the rescorer's training")
    want = enc_dim if kind == "enc" else feat_dim
    if input_dim != want:
        raise ValueError(
            f"LAS rescorer input_dim {input_dim} != the selected "
            f"las_input '{kind}' dim ({want})")
    return kind


def load_fst(args, vocab_size: int, device: torch.device):
    """``(fst_tables, fst_start)`` of ``--fst_lm`` on ``device``, or
    ``(None, 0)`` without one: an ``.arpa`` LM compiled over
    ``--symbols_map`` (token ids shifted by one), else a binary OpenFst,
    else an AT&T text FST; with the advance cache when it fits
    ``--fst_cache_mb`` (read from or written to ``--fst_cache_file``)."""
    if not args.fst_lm:
        return None, 0
    disambig = [int(x) for x in args.disambig_ids.split(",") if x]
    if args.fst_lm.endswith(".arpa"):
        if not args.symbols_map:
            sys.exit("--fst_lm with an ARPA file requires --symbols_map (token symbol table) "
                     "to map LM words to ids")
        sym = read_symbol_table(args.symbols_map)
        tables = compile_arpa(args.fst_lm, {s: i + 1 for i, s in sym.items()},
                              backoff_id=args.backoff_id)
    else:
        try:
            tables = read_openfst_binary(args.fst_lm, args.backoff_id, disambig)
        except ValueError:
            tables = read_text_fst(args.fst_lm, args.backoff_id, disambig)
    cache_file = args.fst_cache_file
    if cache_file == "auto":
        cache_file = args.fst_lm + ".advcache.npz"
    fst_tables = tables.device_arrays(device, n_ilabels=vocab_size + 1,
                                      cache_max_bytes=args.fst_cache_mb << 20,
                                      cache_file=cache_file or None)
    if "adv_cost" in fst_tables:
        adv = fst_tables["adv_cost"]
        print(f"FST advance cache: {tables.n_states} states x {adv.shape[1]} ilabels x "
              f"Lm={adv.shape[2]} ({adv.nbytes * 2 >> 20} MB)", file=sys.stderr)
    return fst_tables, tables.start


def _feats_chunk_stream(args, bsz):
    """Batches of precomputed features (``--loader utt``): spliced and
    strided by the loader, edge-padded to ``--min_len`` frames, CMN and
    CMVN applied on the host; a short last batch is filled with rows of
    zeros.  Yields (uttids, feats, lens, audio seconds)."""
    from pika_tpu_torch.data.cmvn import CmvnStats, offset_scale
    from pika_tpu_torch.data.feats_loader import FeatsLoaderConfig, feats_dataloader
    from pika_tpu_torch.data.loader import prefetch_iter

    fbc = common.fbank_from_args(args)
    offset = scale = None
    if args.cmvn_stats:
        stats = CmvnStats.read(args.cmvn_stats)
        offset, scale = offset_scale(stats.stats, splice_copies=args.lctx + 1 + args.rctx)
    fl_cfg = FeatsLoaderConfig(batch_size=bsz, lctx=args.lctx, rctx=args.rctx,
                               stride=args.stride, max_len=args.max_len)

    def gen():
        for b in feats_dataloader(args.wav_scp, None, fl_cfg):
            feats, lens = b["feats"], b["feat_lens"]
            if args.min_len > 0:
                # the bucket padding repeats the last frame, so raising the
                # length is the edge pad
                lens = np.minimum(np.maximum(lens, args.min_len),
                                  feats.shape[1]).astype(np.int32)
            if args.cmn:
                feats = feats - feats.mean(axis=1, keepdims=True)
            if offset is not None:
                feats = (feats + offset) * scale
            if feats.shape[0] < bsz:
                pad = bsz - feats.shape[0]
                feats = np.pad(feats, ((0, pad), (0, 0), (0, 0)))
                lens = np.pad(lens, (0, pad), constant_values=1)
            audio = (float(np.sum(lens[:len(b["uttids"])])) * args.stride * fbc.frame_shift
                     / fbc.sample_frequency)
            yield b["uttids"], feats.astype(np.float32), lens.astype(np.int32), audio

    yield from prefetch_iter(gen(), size=2)


def _chunk_stream(uttids, make_chunk, bsz):
    """Read the next batch's wavs on a thread while the device decodes.  A
    producer's exception is re-raised on the consumer (a bad wav aborts the
    run rather than truncating it)."""
    q: queue.Queue = queue.Queue(maxsize=2)

    def producer():
        try:
            for i0 in range(0, len(uttids), bsz):
                q.put(("ok", make_chunk(uttids[i0:i0 + bsz])))
            q.put(("done", None))
        except BaseException as exc:  # re-raised on the main thread
            q.put(("error", exc))

    threading.Thread(target=producer, daemon=True).start()
    while True:
        kind, item = q.get()
        if kind == "error":
            raise item
        if kind == "done":
            return
        yield item


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    model, _ = load_bundle(args.model, device,
                           **({"attn_chunk": args.attn_chunk} if args.attn_chunk >= 0 else {}))
    args.spec_augment = False
    args.max_freq_span = args.max_time_span = 0
    featurizer, _, max_samples = common.featurizer_from_args(args, spec_augment=False,
                                                             device=device)
    fst_tables, fst_start = load_fst(args, model.config.vocab_size, device)
    lm_topm = args.fst_topm
    if fst_tables is not None and lm_topm <= 0 and "adv_cost" not in fst_tables:
        print("per-token fusion: exact selection (--fst_topm 0) needs the dense advance "
              "cache, unavailable here (--fst_cache_mb 0 or LM too big) — falling back to "
              "the top-8 candidate walk", file=sys.stderr)
        lm_topm = 8
    cfg = BeamConfig(beam_size=args.beam_size, n_best=args.n_best, blank=args.blk,
                     sm_scale=args.sm_scale, max_symbols=args.max_symbols,
                     lm_scale=args.fst_lm_scale if fst_tables is not None else 0.0,
                     nonblk_reward=args.nonblk_reward, max_fst_states=args.max_fst_states,
                     lm_per_token=args.fst_per_token or args.fst_fusion == "per_token",
                     lm_topm=lm_topm, mm_dtype=args.decode_dtype)

    rescorers = {}  # direction -> (LAS, metadata, reverse)
    for name, path in (("fw", args.las_rescorer_model), ("bw", args.las_rescorer_bw_model)):
        if path:
            las, meta = load_bundle(path, device)
            rescorers[name] = (las, meta, name == "bw")
    sweep_pairs = [tuple(float(x) for x in p.split(":"))
                   for p in args.las_scale_sweep.split(",") if p]
    hyp_sweep = [dict() for _ in sweep_pairs]

    sym_map = read_symbol_table(args.symbols_map) if args.symbols_map else None
    bsz = args.batch_size
    scp = read_wav_scp(args.wav_scp) if args.loader == "otf" else None
    min_samples = 0
    if args.min_len > 0:
        # frames = 1 + (n - frame_len) // shift, inverted for min_len
        fbc = common.fbank_from_args(args)
        min_samples = (args.min_len - 1) * fbc.frame_shift + fbc.frame_length

    def make_chunk(chunk):
        # a short last batch is filled with rows of silence at full length
        wavs = np.zeros((bsz, max_samples), np.float32)
        lens = np.full(bsz, max_samples, np.int32)
        audio = 0.0
        for i, uttid in enumerate(chunk):
            pcm, rate = read_wav(scp[uttid])
            x = seg.from_float32(seg.to_float32(pcm), "int16").astype(np.float32)
            x = x[:max_samples]
            if len(x) < min_samples:
                mode = "edge" if len(x) else "constant"
                x = np.pad(x, (0, min(min_samples, max_samples) - len(x)), mode=mode)
            wavs[i, :len(x)] = x
            lens[i] = len(x)
            audio += len(x) / rate
        return chunk, wavs, lens, audio

    t_start = time.perf_counter()
    hyp_best = {}
    n_utts = 0
    total_audio = 0.0
    with open(args.output_file, "w", encoding="utf-8") as out_f:
        chunks = (_chunk_stream(list(scp), make_chunk, bsz) if scp is not None
                  else _feats_chunk_stream(args, bsz))
        for chunk, x, lens, audio in chunks:
            total_audio += audio
            n_utts += len(chunk)
            x, lens = torch.from_numpy(x).to(device), torch.from_numpy(lens).to(device)
            if scp is not None:
                out = beam_search_waveforms(model, featurizer, x, lens, cfg, fst_tables, fst_start)
            else:
                out = beam_search_features(model, x, lens, cfg, fst_tables, fst_start)
            las_scores, las_tok = {}, {}
            for name, (las, meta, reverse) in rescorers.items():
                try:
                    kind = select_las_input(args.las_input, meta, las.config.input_dim,
                                            out["enc_out"].shape[-1], out["feats"].shape[-1])
                except ValueError as exc:
                    sys.exit(str(exc))
                src, src_lens = ((out["enc_out"], out["enc_lens"]) if kind == "enc"
                                 else (out["feats"], out["feat_lens"]))
                total, per_token = las_score_hyps(
                    las, src, src_lens, out["tokens"], out["lens"],
                    sos=args.SOS if args.SOS >= 0 else 0,
                    eos=args.EOS if args.EOS >= 0 else las.config.output_dim - 1, reverse=reverse)
                las_scores[name], las_tok[name] = total.cpu().numpy(), per_token.cpu().numpy()
            host = {k: out[k].cpu().numpy() for k in ("tokens", "lens", "scores")}
            fw, bw = las_scores.get("fw"), las_scores.get("bw")
            best_idx, _ = rerank_nbest(host["scores"], host["lens"], fw, bw, args.rnnt_score_scale,
                                       args.las_fw_score_scale, args.las_bw_score_scale)
            # the scale sweep reranks the same N-best once per pair
            for (fs, bs), hyps in zip(sweep_pairs, hyp_sweep):
                bidx, _ = rerank_nbest(host["scores"], host["lens"], fw, bw,
                                       args.rnnt_score_scale, fs, bs)
                for i, uttid in enumerate(chunk):
                    hyps[uttid] = [str(int(t)) for t in
                                   host["tokens"][i, bidx[i], :int(host["lens"][i, bidx[i]])]]
            for i, uttid in enumerate(chunk):
                for j in range(args.n_best):
                    length = int(host["lens"][i, j])
                    toks = [int(t) for t in host["tokens"][i, j, :length]]
                    text = ("".join(sym_map.get(t, f"<{t}>") for t in toks) if sym_map
                            else " ".join(map(str, toks)))
                    out_f.write(text)
                    if args.output_scores:
                        out_f.write(f" {float(host['scores'][i, j])}")
                        for name in ("fw", "bw"):
                            if name in las_tok:
                                out_f.write(" " + " ".join(
                                    str(float(x)) for x in las_tok[name][i, j, :length + 1]))
                    out_f.write("\n")
                bj = int(best_idx[i])
                hyp_best[uttid] = [str(int(t)) for t in host["tokens"][i, bj, :int(host["lens"][i, bj])]]

    elapsed = time.perf_counter() - t_start
    rtf = elapsed / max(total_audio, 1e-9)
    print(f"decoded {n_utts} utts, {total_audio:.1f}s audio in {elapsed:.1f}s "
          f"(RTF {rtf:.4f}, {n_utts / elapsed:.2f} utt/s)", file=sys.stderr)

    if args.ref_labels:
        refs = {uttid: [str(int(x)) for x in vec]
                for uttid, vec in read_int_vectors(args.ref_labels).items() if uttid in hyp_best}
        n_unref = len(hyp_best) - len(refs)
        if n_unref or not refs:
            # unmatched hypotheses are left out of the score, and an empty
            # intersection would print a perfect 0% WER
            print(f"WARNING: {n_unref} decoded utterances have no reference "
                  f"({len(refs)} of {len(hyp_best)} scored) — check that "
                  "--ref_labels ids match wav.scp ids", file=sys.stderr)
        for (fs, bs), hyps in zip(sweep_pairs, hyp_sweep):
            w_s, c_s = score_wer(refs, {u: h for u, h in hyps.items() if u in refs})
            print(f"las_scales {fs}:{bs} %WER {w_s * 100:.2f} "
                  f"[ {c_s['errors']} / {c_s['words']} ]", file=sys.stderr)
        wer, counts = score_wer(refs, hyp_best)
        print(f"%WER {wer * 100:.2f} [ {counts['errors']} / {counts['words']}, "
              f"{counts['ins']} ins, {counts['del']} del, {counts['sub']} sub ]", file=sys.stderr)
        return wer
    return None


def cli():
    """Console-script entry: ``main`` returns the WER for programmatic use,
    which ``sys.exit`` would misread as an exit status."""
    main()
    return 0


if __name__ == "__main__":
    main()
