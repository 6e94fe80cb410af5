"""The port's MBR and LAS training CLIs across two ranks (``--num_devices 2
--device cpu``: gloo workers spawned by the CLI) against the JAX CLIs on a
2-device mesh, in-process, on the ``--loader utt`` corpus and flags of
``tests/test_multihost.py`` (batch 1 per rank, dropout 0, no
augmentation), one epoch, from one JAX bundle and its ``bundle_from_flax``
conversion each:

* MBR with ``--dp_mode bmuf`` (``reduce_extra``: the statistics averaged)
  on an rnn-encoder transducer, each rank decoding its own rows (beam 2, 4
  symbols, ``--rnnt_scale 0.1``);
* LAS with ``--dp_mode bmufadam`` and ``--optim adam`` (the reconciled
  moments; the local Adam restarting every round, as the JAX round does).

Each logged loss within 2e-3 of the JAX CLI's (3 decimals printed), the
log's first line alike, the parameters' update (final - initial, all
tensors) to 1e-3 relative L2 and each tensor to 1e-2 (zero-initialised
biases hold only their updates).
"""

import json
import re

import numpy as np
import pytest
import torch

from pika_tpu_torch.convert import state_dict_from_flax
from pika_tpu_torch.train.bundle import bundle_from_flax, load_bundle
from pika_tpu_torch.train.train_las import main as las_main
from pika_tpu_torch.train.train_mbr import main as mbr_main
from test_torch_dist_cli import BMUF, FLAGS, RNN, VOCAB, _corpus, _rel_l2

torch.set_num_threads(1)

MBR_FLAGS = ["--beam_size", "2", "--decode_max_symbols", "4", "--rnnt_scale", "0.1"]
LAS_FLAGS = ["--SOS", "0", "--EOS", str(VOCAB), "--padding_tgt", str(VOCAB + 1),
             "--padding_idx", str(VOCAB + 1), "--output_dim", str(VOCAB + 1),
             "--global_attention", "mlp", "--optim", "adam", "--initial_lr", "0.01",
             "--final_lr", "0.01"]
LAS_CFG = dict(input_dim=RNN["input_dim"], output_dim=VOCAB + 1, pad_idx=VOCAB + 1,
               rnn_size=16, enc_layers=1, dec_layers=1, embd_dim=8)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The rnn corpus and transducer bundles, and a LAS bundle of each
    package."""
    import jax
    from pika_tpu.models.las import LASConfig, init_las
    from pika_tpu.train.bundle import save_bundle

    d = tmp_path_factory.mktemp("dist_mbr_las")
    _corpus(d, "rnn", RNN)
    cfg = LASConfig(**LAS_CFG)
    variables = jax.tree.map(np.asarray, jax.jit(lambda k: init_las(k, cfg)[1])(
        jax.random.PRNGKey(8)))
    save_bundle(str(d / "jax_las"), "las", cfg, variables)
    bundle_from_flax(str(d / "pt_las"), json.loads((d / "jax_las" / "model.json").read_text()),
                     variables)
    return d


def _run(d, tag: str, main_pt, main_jax, flags: list, init: str, jax_init: str, pt_init: str):
    common = [str(d / "feats.ark"), "--ali_rspec", f"ark:{d}/label.txt", *FLAGS, *flags]
    main_jax([common[0], str(d / f"{tag}_jax.WORKER-ID.log"), str(d / f"{tag}_jax"), *common[1:],
              init, str(d / jax_init)])
    main_pt([common[0], str(d / f"{tag}_pt.WORKER-ID.log"), str(d / f"{tag}_pt"), *common[1:],
             init, str(d / pt_init), "--device", "cpu"])
    logs = [(d / f"{tag}_{k}.0.log").read_text() for k in ("jax", "pt")]
    assert logs[1].splitlines()[0] == logs[0].splitlines()[0]
    assert logs[1].endswith("Training Finished\n")
    got, ref = ([[float(x) for x in re.findall(r"Loss: (\S+)", line)]
                 for line in log.splitlines() if re.match(r"(MBR )?Loss: ", line)] for log in logs)
    assert len(got) == len(ref) > 0
    np.testing.assert_allclose(got, ref, atol=2e-3)

    import jax
    from pika_tpu.train.bundle import load_bundle as load_bundle_jax

    _, variables, _ = load_bundle_jax(str(d / f"{tag}_jax" / "model.epoch.0"))
    ref_sd = state_dict_from_flax(jax.tree.map(np.asarray, variables))
    model, _ = load_bundle(str(d / f"{tag}_pt" / "model.epoch.0"), device="cpu")
    start, _ = load_bundle(str(d / pt_init), device="cpu")
    got_d, ref_d = [], []
    for name, x in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        g, r, i = x.numpy(), ref_sd[name].numpy(), start.state_dict()[name].numpy()
        if np.abs(r).max() < 1e-6:
            assert np.abs(g - r).max() < 1e-6, name
        else:
            assert _rel_l2(g, r) < 1e-2, (name, _rel_l2(g, r))
        got_d.append((g - i).ravel())
        ref_d.append((r - i).ravel())
    update = np.concatenate(ref_d)
    assert np.linalg.norm(update) > 0
    assert _rel_l2(np.concatenate(got_d), update) < 1e-3
    return logs


def test_mbr_bmuf_matches_jax(corpus):
    from pika_tpu.train.train_mbr import main as mbr_main_jax

    logs = _run(corpus, "mbr", mbr_main, mbr_main_jax, [*MBR_FLAGS, *BMUF], "--init_model",
                "jax_init", "pt_init")
    assert logs[1].startswith("MBR fine-tuning: devices 2 (bmuf), processes 1, beam 2\n")


def test_las_bmufadam_matches_jax(corpus):
    from pika_tpu.train.train_las import main as las_main_jax

    flags = [*LAS_FLAGS, "--dp_mode", "bmufadam", "--sync_period", "2", "--block_momentum", "0.5"]
    logs = _run(corpus, "las", las_main, las_main_jax, flags, "--init_model", "jax_las", "pt_las")
    assert logs[1].startswith("LAS training: devices 2 (bmufadam), processes 1\n")
