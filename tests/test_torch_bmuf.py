"""The port's BMUF round (``pika_tpu_torch/parallel/bmuf.py``) at world size
2, two gloo workers spawned here, against the JAX package's
``make_bmuf_round`` on a 2-device mesh of the conftest's virtual CPU
devices.

Local steps: the quadratic of ``tests/test_parallel.py`` (loss = 0.5 *
sum((w - row)^2) over a device's rows) from one ``w0`` and batches made by
numpy from a seed; rank r takes JAX device r's rows.  Cases: ``bmuf`` over
two rounds (block momentum accumulates), ``blockadam`` (the summed delta),
``bmufadam`` (the moments, ``rho`` and the fractional count) over two
rounds, the NaN check (rank 1 non-finite: no update on either rank, ``ok``
false), a BatchNorm-like statistic averaged at the sync (``reduce_extra``),
and the local optimizer of a round at ``step_count = 7`` (the JAX
package's ``make_optimizer`` sgd and adam with ``grad_clip=3`` against the
port's: sgd's schedule continues from 7; the JAX round leaves Adam's two
counts at 0, so Adam restarts, and the port does the same).  Every state and the per-step mean metrics agree to rtol 1e-5;
the block state also within ``atol`` = 4 float32 ulps of max(|w0|, 1): the
delta is a difference of two such parameters, so that is its rounding
floor (optax's and torch's Adam round ``sqrt(v / bc2)`` differently).

The workers import this module but not JAX: JAX is imported inside the
tests only.
"""

import os

import numpy as np
import pytest
import torch

from pika_tpu_torch.parallel import BMUF, BMUFConfig, process_group
from pika_tpu_torch.parallel.mesh import local_rendezvous
from pika_tpu_torch.train.lr import make_optimizer

torch.set_num_threads(1)

WORLD = 2
RTOL = 1e-5
DIM, PER_DEV = 5, 3


def _cases():
    """Every case's inputs: config, optimizer, ``w0`` and the rounds'
    batches (rounds, sync_period, WORLD * PER_DEV, DIM)."""
    rng = np.random.default_rng(777)

    def batches(rounds, sync):
        return rng.standard_normal((rounds, sync, WORLD * PER_DEV, DIM)).astype(np.float32)

    def w0():
        return rng.standard_normal(DIM).astype(np.float32)

    sgd = dict(optim="sgd", initial_lr=0.05, final_lr=0.05, total=1, momentum=0.0, clip=-1.0)
    adam = dict(optim="adam", initial_lr=0.05, final_lr=0.05, total=1, momentum=0.0, clip=-1.0)
    cases = {
        "bmuf": dict(cfg=dict(variant="bmuf", block_momentum=0.9, block_lr=1.0, sync_period=4),
                     opt=sgd, w0=w0(), batches=batches(2, 4), step_count=0),
        "blockadam": dict(cfg=dict(variant="blockadam", block_lr=0.05, sync_period=2),
                          opt=sgd, w0=w0(), batches=batches(2, 2), step_count=0),
        "bmufadam": dict(cfg=dict(variant="bmufadam", block_momentum=0.5, block_lr=1.0,
                                  sync_period=2),
                         opt=adam, w0=w0(), batches=batches(2, 2), step_count=0),
        "extra": dict(cfg=dict(variant="bmuf", block_momentum=0.9, block_lr=1.0, sync_period=3),
                      opt=sgd, w0=w0(), batches=batches(2, 3), step_count=0, extra=True),
        "sgd_at_7": dict(cfg=dict(variant="bmuf", block_momentum=0.9, block_lr=1.0,
                                  sync_period=3),
                         opt=dict(optim="sgd", initial_lr=0.1, final_lr=0.01, total=20,
                                  momentum=0.9, clip=3.0),
                         w0=w0(), batches=batches(1, 3), step_count=7),
        "adam_at_7": dict(cfg=dict(variant="bmuf", block_momentum=0.9, block_lr=1.0,
                                   sync_period=3),
                          opt=dict(optim="adam", initial_lr=0.1, final_lr=0.01, total=20,
                                   momentum=0.9, clip=3.0),
                          w0=w0(), batches=batches(1, 3), step_count=7),
    }
    nan = batches(1, 1)
    nan[0, 0, PER_DEV:] = np.nan  # device / rank 1's rows
    cases["nan"] = dict(cfg=dict(variant="bmuf", block_momentum=0.9, block_lr=1.0,
                                 sync_period=1),
                        opt=sgd, w0=np.ones(DIM, np.float32), batches=nan, step_count=0)
    return cases


def _port_case(case: dict, r: int) -> list:
    """Rank ``r``'s rounds of one case; the state after each round."""
    w = torch.nn.Parameter(torch.from_numpy(case["w0"].copy()))
    extra = torch.zeros(DIM)
    o = case["opt"]
    opt = make_optimizer([w], o["optim"], o["initial_lr"], o["final_lr"], o["total"],
                         o["momentum"], o["clip"])
    bmuf = BMUF([w], BMUFConfig(**case["cfg"]), buffers=[extra] if case.get("extra") else [])

    def local_step(rows):
        rows = torch.from_numpy(rows)
        loss = 0.5 * ((w[None, :] - rows) ** 2).sum()
        opt.zero_grad()
        loss.backward()
        opt.step()
        with torch.no_grad():
            extra.mul_(0.9).add_(0.1 * rows.mean(0))
        return {"loss": loss.detach()}

    out, step_count = [], case["step_count"]
    for rnd in case["batches"]:
        rows = [b[r * PER_DEV:(r + 1) * PER_DEV] for b in rnd]
        ok, metrics = bmuf.round(opt, local_step, rows, step_count)
        step_count += len(rnd)
        st = bmuf.state
        out.append({"ok": ok, "w": w.detach().clone(), "params": st.params[0].clone(),
                    "loss": metrics["loss"].clone(), "extra": extra.clone(),
                    **{k: getattr(st, k)[0].clone() for k in ("delta_prev", "adam_mu", "adam_nu")
                       if getattr(st, k) is not None},
                    "adam_count": st.adam_count, "rho": st.rho})
    return out


def _worker(local_rank: int, init: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    with process_group(torch.device("cpu"), local_rank, WORLD, init):
        results = {name: _port_case(case, local_rank) for name, case in _cases().items()}
    torch.save(results, os.path.join(out_dir, f"rank{local_rank}.pt"))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Both ranks' results of every case from one spawn of two workers."""
    out = tmp_path_factory.mktemp("bmuf")
    with local_rendezvous() as init:
        torch.multiprocessing.start_processes(
            _worker, args=(init, str(out)), nprocs=WORLD, join=True, start_method="spawn")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _jax_case(case: dict) -> list:
    """The same rounds through the JAX package's ``make_bmuf_round``."""
    import jax
    import jax.numpy as jnp
    import optax

    from pika_tpu.parallel import BMUFConfig as ConfigJax, bmuf_init, make_bmuf_round, make_mesh
    from pika_tpu.train.lr import make_optimizer as make_optimizer_jax

    o = case["opt"]
    if o["optim"] == "sgd" and o["momentum"] == 0.0 and o["clip"] < 0:
        tx = optax.sgd(o["initial_lr"])
    else:
        tx = make_optimizer_jax(o["optim"], o["initial_lr"], o["final_lr"], o["total"],
                                o["momentum"], o["clip"])
    with_extra = bool(case.get("extra"))

    def local_step(params, opt_state, extra, batch, key):
        del key

        def loss_fn(p):
            return 0.5 * jnp.sum((p["w"][None, :] - batch) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if with_extra:
            extra = {"s": 0.9 * extra["s"] + 0.1 * batch.mean(0)}
        return params, opt_state, extra, {"loss": loss}

    cfg = ConfigJax(**case["cfg"])
    round_fn = make_bmuf_round(local_step, tx.init, cfg, make_mesh(WORLD),
                               reduce_extra=with_extra)
    state = bmuf_init({"w": jnp.asarray(case["w0"])}, cfg)
    extra = {"s": jnp.zeros(DIM, jnp.float32)} if with_extra else None
    out, step_count = [], case["step_count"]
    for i, rnd in enumerate(case["batches"]):
        state, extra, ok, metrics = round_fn(state, extra, jnp.asarray(rnd),
                                             jax.random.PRNGKey(i), step_count)
        step_count += len(rnd)
        out.append({"ok": bool(ok), "params": np.asarray(state.params["w"]),
                    "loss": np.asarray(metrics["loss"]),
                    "extra": np.asarray(extra["s"]) if with_extra else None,
                    **{k: np.asarray(getattr(state, k)["w"])
                       for k in ("delta_prev", "adam_mu", "adam_nu")
                       if getattr(state, k) is not None},
                    "adam_count": (float(state.adam_count) if state.adam_count is not None
                                   else None),
                    "rho": float(state.rho) if state.rho is not None else None})
    return out


def _compare(port, name: str) -> list:
    case = _cases()[name]
    ref = _jax_case(case)
    atol = 4 * np.finfo(np.float32).eps * max(np.abs(case["w0"]).max(), 1.0)
    for r in range(WORLD):
        got = port[r][name]
        assert len(got) == len(ref)
        for i, (g, j) in enumerate(zip(got, ref)):
            where = f"{name} rank {r} round {i}"
            assert g["ok"] == j["ok"], where
            np.testing.assert_allclose(g["params"].numpy(), j["params"], rtol=RTOL, err_msg=where)
            # the live parameters are the global ones after the sync
            np.testing.assert_array_equal(g["w"].numpy(), g["params"].numpy(), err_msg=where)
            np.testing.assert_allclose(g["loss"].numpy(), j["loss"], rtol=RTOL, err_msg=where)
            for k in ("delta_prev", "adam_mu", "adam_nu"):
                assert (k in g) == (k in j), (where, k)
                if k in g:
                    np.testing.assert_allclose(g[k].numpy(), j[k], rtol=RTOL, atol=atol,
                                               err_msg=f"{where} {k}")
            if j["extra"] is not None:
                np.testing.assert_allclose(g["extra"].numpy(), j["extra"], rtol=RTOL,
                                           err_msg=where)
            for k in ("adam_count", "rho"):
                if j[k] is not None:
                    assert g[k] == pytest.approx(j[k], rel=RTOL), (where, k)
    return ref


def test_bmuf_two_rounds_momentum_accumulates(port):
    ref = _compare(port, "bmuf")
    assert all(x["ok"] for x in ref)
    assert not np.allclose(ref[0]["delta_prev"], ref[1]["delta_prev"])


def test_blockadam_sums_the_delta(port):
    ref = _compare(port, "blockadam")
    assert ref[-1]["adam_count"] == 2.0


def test_bmufadam_moments_rho_and_fractional_count(port):
    ref = _compare(port, "bmufadam")
    assert ref[0]["rho"] == pytest.approx(2.0) and ref[1]["rho"] == pytest.approx(3.0)
    assert ref[1]["adam_count"] == pytest.approx(2 + 1.0 + 2 + 1.5)  # tau + rho * bm, twice


def test_nan_on_one_rank_skips_the_update_everywhere(port):
    ref = _compare(port, "nan")
    assert not ref[0]["ok"]
    for r in range(WORLD):
        np.testing.assert_array_equal(port[r]["nan"][0]["params"].numpy(), np.ones(DIM))


def test_statistics_averaged_at_the_sync(port):
    _compare(port, "extra")
    a, b = (port[r]["extra"][-1]["extra"] for r in range(WORLD))
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["sgd_at_7", "adam_at_7"])
def test_local_optimizer_fast_forwarded(port, name):
    _compare(port, name)
