"""The port's throughput entry points (``pika_tpu_torch/tools/``) and
profiling hooks (``pika_tpu_torch/utils/profiling.py``) against their JAX
counterparts on the CPU: ``pika_tpu/utils/profiling.py``, the root
``bench.py``, ``tools/bench_decode.py`` and ``tools/bench_cli_train.py``.

Tolerances: the step summaries and ``flop_model`` are the same Python
arithmetic, held exactly; the training step and the searches run with
attention in float32 on both sides (the packages round q, k, v and the
probabilities to bf16 at other points), so they differ only by float32
sums in another order: the step's loss to 1e-5 relative and each
parameter's change to 2e-3 relative L2 (test_torch_train.py's bounds for
the same comparison), the searches' tokens, lengths and alignments
identical and their scores to 1e-4 relative (the encoder's float32 sums,
measured at 4.8e-5 absolute on log-probs in test_torch_beam.py)."""

import dataclasses
import glob
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pika_tpu.train.train_transducer as train_cli_jax
from pika_tpu.decode.beam import BeamConfig as BeamConfigJax
from pika_tpu.decode.beam import beam_search_waveforms as beam_search_waveforms_jax
from pika_tpu.decode.fst import FstTables as FstTablesJax
from pika_tpu.features.fbank import FbankConfig as FbankJax
from pika_tpu.models.transducer import (
    Transducer as TransducerJax,
    TransducerConfig as ConfigJax,
    init_transducer as init_jax,
)
from pika_tpu.train import lr as lr_jax
from pika_tpu.train.step import (
    FeaturizerConfig as FeatJax,
    TrainState,
    make_featurizer as featurizer_jax,
    make_train_step as train_step_jax,
)
from pika_tpu.utils.profiling import StepTimer as StepTimerJax
from pika_tpu_torch import convert
from pika_tpu_torch.features.fbank import FbankConfig
from pika_tpu_torch.models.transducer import TransducerConfig, init_transducer
from pika_tpu_torch.tools import bench_cli_train, bench_decode, bench_train
import pika_tpu_torch.train.train_transducer as train_cli
from pika_tpu_torch.train.step import FeaturizerConfig, make_featurizer
from pika_tpu_torch.utils.profiling import StepTimer, annotate, trace

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path: str, name: str):
    """A JAX-side script of the repo as a module (its ``__main__`` block
    does not run)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


@pytest.fixture
def f32_attention(monkeypatch):
    """Attention in float32 in both packages: the JAX layer's ``mm_dtype``
    default set to None for this test and the port's bf16 rounding made the
    identity."""
    import pika_tpu.models.transformer as transformer_jax
    import pika_tpu_torch.models.transformer as transformer_pt

    init = transformer_jax.MultiHeadedAttention.__init__.__wrapped__
    names = [n for n in inspect.signature(init).parameters if n != "self"]
    defaults = list(init.__defaults__)
    defaults[names.index("mm_dtype") - (len(names) - len(defaults))] = None
    monkeypatch.setattr(init, "__defaults__", tuple(defaults))
    monkeypatch.setattr(transformer_pt, "_bf16", lambda x: x)


# ---------------------------------------------------------------------------
# (a) profiling hooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 9, 10, 11, 23])
def test_step_timer_summary_matches_jax(n):
    """The same list of times gives JAX's summary key for key, exactly."""
    times = list(np.random.default_rng(n).uniform(0.01, 2.0, n))
    got, ref = StepTimer(), StepTimerJax()
    got.times, ref.times = list(times), list(times)
    assert got.summary() == ref.summary()
    if n:
        assert set(got.summary()) == {"steps", "mean_s", "p50_s", "p90_s", "max_s"}


def test_step_timer_stop_takes_a_nest_of_tensors():
    timer = StepTimer()
    for result in (None, torch.ones(3), {"loss": torch.zeros(()), "n": [torch.ones(2), 3]}):
        timer.start()
        timer.stop(result)
    assert timer.summary()["steps"] == 3 and all(t >= 0 for t in timer.times)


def test_trace_writes_annotations(tmp_path):
    """``trace`` on the CPU writes a Chrome trace that holds the
    ``annotate`` regions."""
    with trace(str(tmp_path)) as prof:
        with annotate("bench_tools_region"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "bench_tools_region" in names
    assert any(e.key == "bench_tools_region" for e in prof.key_averages())


# ---------------------------------------------------------------------------
# (b) flop_model
# ---------------------------------------------------------------------------

def test_importing_bench_runs_only_its_constants():
    """``import bench`` prints nothing and imports no JAX: its constants
    and functions only (``main`` runs under its ``__main__`` check)."""
    code = "import sys, bench; print(sorted(m for m in ('jax', 'pika_tpu') if m in sys.modules))"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout == "[]\n" and out.stderr == ""


@pytest.mark.parametrize("pruned", [0, 5, 16])
def test_flop_model_matches_bench(pruned):
    bench = _load("bench.py", "bench_root")
    for t_frames in (4, 97, 500, 998):
        for batch in (1, 8, 32):
            for u in (0, 7, 40):
                assert (bench_train.flop_model(t_frames, batch, u, pruned)
                        == bench.flop_model(t_frames, batch, u, pruned))


# ---------------------------------------------------------------------------
# (c) bench_train's step against the JAX step
# ---------------------------------------------------------------------------

MEL = 23
MODEL = dict(input_dim=3 * MEL, vocab_size=20, hid_dim=16, encoder_type="tdnn_transformer",
             decoder_type="rnn", dec_layers=2, embd_dim=8, tdnn_nhid=32, tdnn_layers=5,
             tdnn_transformer_dropout=0.0)
FBANK = dict(sample_frequency=16000, window_type="hamming", dither=0.0, low_freq=40.0,
             high_freq=-200.0, num_mel_bins=MEL)
MAX_SAMPLES = 16000


@pytest.fixture(scope="module")
def jax_model():
    """The tiny model and its JAX weights (``init_transducer`` under jit)."""
    cfg = ConfigJax(**MODEL)
    return TransducerJax(cfg), jax.tree.map(np.asarray, jax.jit(
        lambda k: init_jax(k, cfg, max_t=64)[1])(jax.random.PRNGKey(4)))


def test_bench_train_step_matches_jax(f32_attention, jax_model, monkeypatch):
    """One step of ``bench_train.make_step``'s step (dither 0, SpecAugment
    off, dropout 0) on ``bench_train.make_batch``'s batch against JAX
    ``make_train_step`` from the same weights: the loss to 1e-5 relative,
    each parameter's change and BatchNorm statistic to 2e-3 relative L2
    (quantities whose true value is 0 to 1e-6 absolute).

    The benchmark's features carry no CMVN (as ``bench.py``'s).  Of noise,
    each fbank bin then varies little around a large mean, and the first
    BatchNorm's variance (E[x^2] - E[x]^2 in both packages) cancels: one
    ulp of the waveforms moves the tiny encoder's update below its last
    layers by 4-10 % relative L2 in the port and 1-2 % in JAX (measured).
    So both featurizers here also normalize with CMVN from the batch's
    frames, as tests/test_torch_train.py's do; the rest of the step is the
    benchmark's."""
    model_jax, variables = jax_model
    batch = bench_train.make_batch(3, MAX_SAMPLES, MODEL["vocab_size"], "cpu")
    feat_cfg = FeaturizerConfig(fbank=FbankConfig(**FBANK), max_samples=MAX_SAMPLES, lctx=1,
                                rctx=1, stride=1)
    feats, _ = make_featurizer(feat_cfg, device="cpu")(batch["wavs"], batch["wav_lens"])
    frames = feats.reshape(-1, feats.shape[-1])
    offset, scale = -frames.mean(0), 1.0 / frames.std(0)
    monkeypatch.setattr(bench_train, "make_featurizer",
                        lambda cfg, device: make_featurizer(cfg, offset, scale, device=device))

    tx = lr_jax.make_optimizer("sgd", **bench_train.OPTIM)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       opt_state=tx.init(variables["params"]),
                       batch_stats=variables["batch_stats"])
    step_jax = train_step_jax(
        model_jax, tx,
        featurizer_jax(FeatJax(fbank=FbankJax(**FBANK), max_samples=MAX_SAMPLES, lctx=1, rctx=1,
                               stride=1), jnp.asarray(offset.numpy()), jnp.asarray(scale.numpy())),
        loss_chunk=bench_train.LOSS_CHUNK, loss_backend="xla", donate=False)
    state, metrics = step_jax(state, {k: jnp.asarray(x.numpy()) for k, x in batch.items()},
                              jax.random.PRNGKey(0))
    ref = convert.state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))

    model, step = bench_train.make_step(TransducerConfig(**MODEL), feat_cfg, "cpu")
    convert.load_flax_variables(model, variables)
    init = convert.state_dict_from_flax(variables)
    out = step(batch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(out["loss"].item(), float(metrics["loss"]), rtol=1e-5)
    checked = 0
    for name, x in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        got, want = x.numpy(), ref[name].numpy()
        if not name.endswith(("running_mean", "running_var")):
            got, want = got - init[name].numpy(), want - init[name].numpy()
        if np.abs(want).max() < 1e-6:
            assert np.abs(got - want).max() < 1e-6, name
            continue
        assert _rel_l2(got, want) < 2e-3, (name, _rel_l2(got, want))
        checked += 1
    assert checked > 50


# ---------------------------------------------------------------------------
# (d) bench_train's output contract
# ---------------------------------------------------------------------------

@pytest.fixture
def tiny_bench(monkeypatch):
    """bench_train at a tiny width on the CPU, its repetitions' seconds
    replaced by ``times`` (the steps themselves run)."""
    monkeypatch.setattr(bench_train, "MODEL", {k: v for k, v in MODEL.items()
                                               if k != "tdnn_transformer_dropout"})
    monkeypatch.setattr(bench_train, "FBANK", FbankConfig(**dict(FBANK, dither=1.0)))
    monkeypatch.setattr(bench_train, "SECONDS", 0.5)
    monkeypatch.setattr(bench_train, "N_STEPS", 2)
    monkeypatch.setenv("BENCH_BATCH", "2")
    times = []
    real = bench_train.repetition

    def timed(*args):
        _, loss = real(*args)
        return times.pop(0), loss

    monkeypatch.setattr(bench_train, "repetition", timed)
    return times


def test_bench_train_prints_one_json_line(tiny_bench, capsys):
    tiny_bench.extend([5.0, 1.0, 1.05])  # warm, then two timed within 10 %
    bench_train.main(["--device", "cpu"])
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert list(result) == ["metric", "value", "unit", "vs_baseline"]
    assert result["metric"] == "rnnt_train_utterances_per_sec_per_chip"
    assert result["value"] == pytest.approx(2 * 2 / 1.0)  # batch x steps / fastest
    assert result["vs_baseline"] is None and "batch 2" in result["unit"]
    assert "spread 5.0%" in err and "TFLOP/s" in err


def test_bench_train_spread_exits_1(tiny_bench, capsys):
    tiny_bench.extend([5.0, 1.0, 1.2])
    with pytest.raises(SystemExit) as exit_info:
        bench_train.main(["--device", "cpu"])
    assert exit_info.value.code == 1
    out, err = capsys.readouterr()
    assert out == "" and "FAILED" in err


# ---------------------------------------------------------------------------
# (e) bench_decode's synthetic LM and searches
# ---------------------------------------------------------------------------

DEC_VOCAB, DEC_STATES = 48, 30
DEC_MODEL = dict(input_dim=240, vocab_size=DEC_VOCAB, hid_dim=16,
                 encoder_type="tdnn_transformer", decoder_type="rnn", dec_layers=2, embd_dim=8,
                 tdnn_nhid=32, tdnn_layers=5)


def test_synthetic_lm_shape():
    """tools/bench_decode.py's shape: V + 40 x states arcs, the unigram
    state on every token, each context's ilabels sorted and distinct."""
    t = bench_decode.synthetic_lm(DEC_VOCAB, DEC_STATES)
    n_arcs = DEC_VOCAB + 40 * DEC_STATES
    assert t.arc_start[-1] == n_arcs and t.n_states == DEC_STATES + 1
    for a in (t.arc_ilabel, t.arc_weight, t.arc_next):
        assert a.shape == (n_arcs,)
    assert np.array_equal(t.arc_ilabel[:DEC_VOCAB], np.arange(1, DEC_VOCAB + 1))
    for s in range(1, t.n_states):
        ils = t.arc_ilabel[t.arc_start[s]:t.arc_start[s + 1]]
        assert len(ils) == 40 and (np.diff(ils) > 0).all() and ils.min() >= 1
    assert ((t.arc_next >= 1) & (t.arc_next <= DEC_STATES)).all()
    assert t.backoff_next[0] == -1 and (t.backoff_next[1:] == 0).all()
    assert [x.dtype for x in (t.arc_start, t.arc_ilabel, t.arc_weight, t.arc_next)] == [
        np.int32, np.int32, np.float32, np.int32]


@pytest.fixture(scope="module")
def decode_models():
    """The decode test's JAX model and weights, and the port's model on
    them."""
    cfg = ConfigJax(**DEC_MODEL)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k: init_jax(k, cfg, max_t=64)[1])(jax.random.PRNGKey(5)))
    model = init_transducer(TransducerConfig(**DEC_MODEL), torch.Generator().manual_seed(0),
                            device="cpu")
    return TransducerJax(cfg), variables, convert.load_flax_variables(model, variables)


@pytest.mark.parametrize("fst", ["per_beam", "per_token"])
def test_bench_decode_search_matches_jax(f32_attention, decode_models, fst):
    """``bench_decode``'s search (its flags' BeamConfig, the synthetic LM
    with its advance cache, ``make_wavs``' batch) against JAX
    ``beam_search_waveforms`` on the weights carried across and an
    ``FstTables`` of the same numpy arrays."""
    args = bench_decode.build_parser().parse_args(
        ["--fst", fst, "--beam", "4", "--n_best", "4", "--max_symbols", "6", "--batch", "2",
         "--seconds", "0.5", "--reps", "1", "--fst_states", str(DEC_STATES)])
    max_samples = int(bench_decode.SR * args.seconds)
    model_jax, variables, model = decode_models
    featurizer = make_featurizer(FeaturizerConfig(fbank=bench_decode.FBANK,
                                                  max_samples=max_samples, lctx=1, rctx=1,
                                                  stride=1), device="cpu")
    tables = bench_decode.synthetic_lm(DEC_VOCAB, DEC_STATES)
    dev = bench_decode.lm_tables(tables, DEC_VOCAB, args.fst_cache_mb, "cpu")
    assert "adv_cost" in dev  # per_token: exact selection through the cache
    bcfg = bench_decode.exact_fallback(bench_decode.beam_config(args), dev)
    wavs, lens = bench_decode.make_wavs(args.batch, max_samples, "cpu")
    _, got = bench_decode.time_searches(model, featurizer, wavs, lens, bcfg, dev, tables.start,
                                        args.reps)

    tables_jax = FstTablesJax(**{f.name: getattr(tables, f.name)
                                 for f in dataclasses.fields(FstTablesJax)})
    fb = {f.name: getattr(bench_decode.FBANK, f.name) for f in dataclasses.fields(FbankJax)}
    ref = beam_search_waveforms_jax(
        model_jax, variables,
        featurizer_jax(FeatJax(fbank=FbankJax(**fb), max_samples=max_samples, lctx=1, rctx=1,
                               stride=1)),
        jnp.asarray(wavs.numpy()), jnp.asarray(lens.numpy()),
        BeamConfigJax(**dataclasses.asdict(bcfg)),
        tables_jax.device_arrays(n_ilabels=DEC_VOCAB + 1,
                                 cache_max_bytes=args.fst_cache_mb << 20), tables_jax.start)
    for name in ("tokens", "lens", "aligns", "align_lens"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref[name]), err_msg=name)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(ref["scores"]), rtol=1e-4)
    assert got["lens"].max() > 0


# ---------------------------------------------------------------------------
# (f) bench_cli_train against tools/bench_cli_train.py
# ---------------------------------------------------------------------------

def test_bench_cli_train_matches_jax_tool(tmp_path, monkeypatch, capsys):
    """Both tools at ``--utts 2 --seconds 0.5`` with the training CLI's
    ``main`` replaced by a recorder: the corpora they wrote are the same
    bytes and the CLI command lines the same, their roots normalized."""
    roots, runs = [], []

    def mkdtemp(prefix=""):
        roots.append(str(tmp_path / f"{prefix}{len(roots)}"))
        os.makedirs(roots[-1])
        return roots[-1]

    def recorder(argv):
        root = roots[-1]
        files = {}
        for path in sorted(glob.glob(f"{root}/*")):
            with open(path, "rb") as f:
                files[os.path.basename(path)] = f.read().replace(root.encode(), b"ROOT")
        runs.append(([x.replace(root, "ROOT") for x in argv], files))
        open(argv[1], "w").close()  # the log both tools read back

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    monkeypatch.setattr(train_cli_jax, "main", recorder)
    monkeypatch.setattr(train_cli, "main", recorder)
    tool = _load("tools/bench_cli_train.py", "bench_cli_train_jax")
    flags = ["--utts", "2", "--seconds", "0.5"]
    monkeypatch.setattr(sys, "argv", ["bench_cli_train.py", *flags])
    tool.main()
    bench_cli_train.main(flags)
    (argv_jax, files_jax), (argv, files) = runs
    assert argv == argv_jax
    assert set(files) == {"bench.mrk.0", "bench.seq.0", "label.txt", "data.lst"}
    assert files == files_jax
    assert not os.path.exists(roots[1])  # the port removes its directory
    assert "total wall" in capsys.readouterr().out
