"""The port's FST module (``pika_tpu_torch/decode/fst.py``) against the JAX
package's on the CPU: the host compilers, the OpenFst reader and writer and
the host-built caches give the same arrays and the same files; a cache file
written by either package is read by the other; every device query gives
the same bits on random automata (negative weights, disambig arcs, backoff
cycles), with and without the advance cache."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pika_tpu.decode.fst as fst_jax
import pika_tpu_torch.decode.fst as fst_pt

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(fst_pt.FstTables)]

ARPA = """\\data\\
ngram 1=6
ngram 2=5
ngram 3=2

\\1-grams:
-0.7 <s> -0.3
-0.9 a -0.2
-1.1 b -0.25
-1.3 c
-0.8 </s>
-2.0 zz -0.1

\\2-grams:
-0.30 <s> a -0.05
-0.45 a b -0.15
-0.5 b </s>
-0.6 b c
-0.4 zz a

\\3-grams:
-0.2 <s> a b
-0.25 a b c

\\end\\
"""


def _random_arcs(rng, n_states=24, n_labels=8, negative=False, disambig=False):
    """A random deterministic backoff automaton as (arcs, finals), with
    backoff cycles possible (every query bounds its walk)."""
    lo, hi = (-1.5, 2.5) if negative else (0.0, 3.0)
    arcs, finals = {}, {}
    for s in range(n_states):
        labels = rng.choice(np.arange(1, n_labels + 1), size=rng.integers(0, n_labels),
                            replace=False)
        lst = [(int(l), float(rng.uniform(lo, hi)), int(rng.integers(0, n_states)))
               for l in labels]
        if rng.random() < 0.8:
            lst.append((0, float(rng.uniform(lo, hi)), int(rng.integers(0, n_states))))
        if disambig and rng.random() < 0.4:
            lst.append((int(rng.choice([90, 91])), float(rng.uniform(lo, hi)),
                        int(rng.integers(0, n_states))))
        arcs[s] = lst
        if rng.random() < 0.3:
            finals[s] = float(rng.uniform(lo, hi))
    return arcs, finals


def _both(seed, negative=False, disambig=False, **kw):
    arcs, finals = _random_arcs(np.random.default_rng(seed), negative=negative,
                                disambig=disambig, **kw)
    dis = [90, 91] if disambig else None
    return tuple(m._build_tables(len(arcs), arcs, finals, start=0, backoff_id=0,
                                 disambig_ids=dis) for m in (fst_jax, fst_pt))


def _assert_same_tables(got, ref):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(ref, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name
        else:
            assert a == b, name


def _bits(x):
    """A float32 array's bit patterns (equal bits, not just equal values)."""
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


GRID = [(False, False), (True, False), (False, True), (True, True)]


def test_compile_arpa_matches_jax(tmp_path):
    """A trigram ARPA with <s>, </s>, a word outside the symbol table and a
    context without an explicit backoff: the same automaton."""
    path = tmp_path / "lm.arpa"
    path.write_text(ARPA)
    sym = {"a": 3, "b": 4, "c": 5}
    for backoff_id in (0, 1):
        _assert_same_tables(fst_pt.compile_arpa(str(path), sym, backoff_id),
                            fst_jax.compile_arpa(str(path), sym, backoff_id))


@pytest.mark.parametrize("acceptor", [False, True])
def test_read_text_fst_matches_jax(tmp_path, acceptor):
    """Both AT&T text formats, weighted and unweighted lines, a backoff and
    two disambig arcs."""
    lines = ["0 1 1 0.5", "0 2 2 1.2", "0 1 90 0.15", "1 2 2 0.3", "1 0 0 0.4", "1 2 91",
             "2 0 0 0.2", "2 1 1", "0 0.1", "2"]
    if not acceptor:  # transducer arcs carry an olabel
        lines = [" ".join(p[:3] + p[2:3] + p[3:]) if len(p) >= 3 else " ".join(p)
                 for p in (x.split() for x in lines)]
    path = tmp_path / "lm.fst.txt"
    path.write_text("\n".join(lines) + "\n")
    for kw in (dict(), dict(disambig_ids=[90, 91]), dict(backoff_id=2)):
        _assert_same_tables(fst_pt.read_text_fst(str(path), acceptor=acceptor, **kw),
                            fst_jax.read_text_fst(str(path), acceptor=acceptor, **kw))


@pytest.mark.parametrize("symbols", [False, True])
def test_openfst_binary_matches_jax(tmp_path, symbols):
    """The writers give the same bytes (with and without embedded symbol
    tables, with disambig arcs); each package reads the other's file into
    the same tables."""
    tj, tp = _both(1, disambig=True)
    syms = {"<eps>": 0, **{f"w{i}": i for i in range(1, 9)}, "#0": 90, "#1": 91}
    kw = dict(isymbols=syms, osymbols=syms) if symbols else {}
    fst_jax.write_openfst_binary(str(tmp_path / "jax.fst"), tj, **kw)
    fst_pt.write_openfst_binary(str(tmp_path / "pt.fst"), tp, **kw)
    assert (tmp_path / "jax.fst").read_bytes() == (tmp_path / "pt.fst").read_bytes()
    for path in ("jax.fst", "pt.fst"):
        for dis in (None, [90, 91]):
            _assert_same_tables(fst_pt.read_openfst_binary(str(tmp_path / path), 0, dis),
                                fst_jax.read_openfst_binary(str(tmp_path / path), 0, dis))
    back = fst_pt.read_openfst_binary(str(tmp_path / "pt.fst"), 0, [90, 91])
    _assert_same_tables(back, tp)


@pytest.mark.parametrize("negative,disambig", GRID)
def test_caches_match_jax(negative, disambig):
    """``build_final_cache`` and ``build_advance_cache`` (a chunk size that
    splits the states, levels 6 and 2), and the size gate."""
    tj, tp = _both(2, negative, disambig)
    np.testing.assert_array_equal(_bits(fst_pt.build_final_cache(tp)),
                                  _bits(fst_jax.build_final_cache(tj)))
    for levels in (None, 2):
        ref = fst_jax.build_advance_cache(tj, 16, levels=levels, chunk=7)
        got = fst_pt.build_advance_cache(tp, 16, levels=levels, chunk=7)
        for name in ("adv_cost", "adv_next"):
            assert got[name].dtype == ref[name].dtype and got[name].shape == ref[name].shape
            np.testing.assert_array_equal(_bits(got[name]), _bits(ref[name]))
    assert fst_pt.build_advance_cache(tp, 16, max_bytes=64) is None
    assert fst_jax.build_advance_cache(tj, 16, max_bytes=64) is None
    assert tp.fingerprint(16, None) == tj.fingerprint(16, None)


def test_advance_cache_file_interchange(tmp_path, monkeypatch):
    """A cache file written by either package is read by the other (its
    build is not called again), with the same keys and contents; a file of
    another automaton is rebuilt, never served."""
    tj, tp = _both(3, disambig=True)
    kw = dict(n_ilabels=12, cache_max_bytes=1 << 20)
    jax_file, pt_file = str(tmp_path / "jax.advcache.npz"), str(tmp_path / "pt.advcache.npz")
    ref = tj.device_arrays(cache_file=jax_file, **kw)
    got = tp.device_arrays("cpu", cache_file=pt_file, **kw)
    with np.load(jax_file) as a, np.load(pt_file) as b:
        assert sorted(a.files) == sorted(b.files) == ["adv_cost", "adv_next", "fingerprint"]
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])

    def no_build(*args, **kwargs):
        raise AssertionError("the cache file was not read")

    monkeypatch.setattr(fst_jax, "build_advance_cache", no_build)
    monkeypatch.setattr(fst_pt, "build_advance_cache", no_build)
    from_pt = tj.device_arrays(cache_file=pt_file, **kw)
    from_jax = tp.device_arrays("cpu", cache_file=jax_file, **kw)
    for name in ("adv_cost", "adv_next"):
        np.testing.assert_array_equal(np.asarray(from_pt[name]), np.asarray(ref[name]))
        np.testing.assert_array_equal(from_jax[name].numpy(), got[name].numpy())
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref[name]))
    monkeypatch.undo()
    other_j, other_p = _both(4)
    stale = other_p.device_arrays("cpu", cache_file=jax_file, **kw)
    fresh = other_j.device_arrays(**kw)
    np.testing.assert_array_equal(stale["adv_cost"].numpy(), np.asarray(fresh["adv_cost"]))


def test_device_arrays_match_jax():
    """The same keys, dtypes and contents; the advance cache stays 32-bit;
    the key follows the content, and the search's step count covers the
    longest arc slice."""
    tj, tp = _both(5)
    kw = dict(n_ilabels=12, cache_max_bytes=1 << 20)
    ref, got = tj.device_arrays(**kw), tp.device_arrays("cpu", **kw)
    assert sorted(got) == sorted(ref)
    for name, x in ref.items():
        x = np.asarray(x)
        assert got[name].numpy().dtype == x.dtype, name
        np.testing.assert_array_equal(_bits(got[name].numpy()), _bits(x), err_msg=name)
    assert got["adv_cost"].dtype == torch.float32 and got["adv_next"].dtype == torch.int32
    assert got.key == tp.device_arrays("cpu", **kw).key
    assert got.key != tp.device_arrays("cpu").key
    assert got.key != dataclasses.replace(tp, start=1).device_arrays("cpu", **kw).key
    longest = int(np.diff(tp.arc_start).max())
    assert 2 ** (got.search_iters - 1) <= longest < 2 ** got.search_iters


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("negative,disambig", GRID)
def test_device_queries_match_jax(negative, disambig, cached):
    """Six steps of state-set advances (labels on and off the arcs,
    nonblk_reward 0 and 0.3) through both packages: new states, costs and
    LM scores, final scores, and with the cache the selection scores of
    one label and of every label, all bit for bit; state sets of capacity
    4 and 1."""
    rng = np.random.default_rng(6)
    # the JAX queries under jit (eagerly, each vmap traces again every call)
    advance = jax.jit(fst_jax.fst_advance_sets, static_argnums=(4,))
    final = jax.jit(fst_jax.fst_final_scores)
    min_costs = jax.jit(fst_jax.fst_advance_min_costs)
    min_costs_all = jax.jit(fst_jax.fst_advance_min_costs_all)
    tj, tp = _both(7, negative, disambig)
    kw = dict(n_ilabels=16, cache_max_bytes=1 << 20) if cached else {}
    dj, dp = tj.device_arrays(**kw), tp.device_arrays("cpu", **kw)
    assert ("adv_cost" in dp) == cached
    for s_cap in (4, 1):
        sj, cj = fst_jax.init_state_sets(tj, (2, 3), s_cap)
        sp, cp = fst_pt.init_state_sets(tp, (2, 3), s_cap, device="cpu")
        np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(_bits(cp.numpy()), _bits(cj))
        live = 0
        for step in range(6):
            labels = rng.integers(1, 10, (2, 3)).astype(np.int32)
            reward = 0.3 if step % 2 else 0.0
            sj, cj, lj = advance(dj, sj, cj, jnp.asarray(labels), 6, reward)
            sp, cp, lp = fst_pt.fst_advance_sets(dp, sp, cp, torch.from_numpy(labels).long(), 6,
                                                 reward)
            np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
            live += int((sp >= 0).any(-1).sum())
            for got, ref in ((cp, cj), (lp, lj),
                             (fst_pt.fst_final_scores(dp, sp, cp),
                              final(dj, sj, cj))):
                np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
            if cached:
                lab = rng.integers(0, 20, (2, 3)).astype(np.int32)
                for got, ref in (
                        (fst_pt.fst_advance_min_costs(dp, sp, cp, torch.from_numpy(lab).long(),
                                                      0.2),
                         min_costs(dj, sj, cj, jnp.asarray(lab), 0.2)),
                        (fst_pt.fst_advance_min_costs_all(dp, sp, cp, 0.2),
                         min_costs_all(dj, sj, cj, 0.2))):
                    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
        assert live >= 6  # the comparison saw live sets


@pytest.mark.parametrize("negative,disambig", GRID)
def test_walk_primitives_match_jax(negative, disambig):
    """``_search_arc_fast``, ``expand_disambig`` and ``backoff_matches`` on
    every (state, label) pair (state -1 included) against the JAX
    functions under vmap, and ``_dedup_top_s`` on candidates with equal
    costs and repeated states; ``fst_final_scores`` uncached against
    cached."""
    import jax

    tj, tp = _both(8, negative, disambig, n_states=40, n_labels=14)
    dj, dp = tj.device_arrays(), tp.device_arrays("cpu")
    states = np.repeat(np.arange(-1, tp.n_states), 17).astype(np.int32)
    labels = np.tile(np.arange(17), tp.n_states + 1).astype(np.int32)
    s_t, l_t = torch.from_numpy(states).long(), torch.from_numpy(labels).long()
    ref = jax.vmap(lambda s, l: fst_jax._search_arc_fast(dj, s, l))(states, labels)
    got = fst_pt._search_arc_fast(dp, s_t, l_t)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(r))
    assert got[0].any() and not got[0].all()
    ref = jax.vmap(lambda s: fst_jax.expand_disambig(dj, s))(states)
    got = fst_pt.expand_disambig(dp, s_t)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(r))
    init = np.random.default_rng(9).uniform(0, 2, states.shape).astype(np.float32)
    ref = jax.vmap(lambda s, l, c: fst_jax.backoff_matches(dj, s, l, c, 6))(states, labels, init)
    got = fst_pt.backoff_matches(dp, s_t, l_t, torch.from_numpy(init), 6)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(r))

    rng = np.random.default_rng(10)
    cand_s = rng.integers(-1, 5, (30, 12)).astype(np.int32)
    cand_c = rng.integers(0, 4, (30, 12)).astype(np.float32) * 0.5  # many equal costs
    for s_cap in (1, 4):
        ref = fst_jax._dedup_top_s(jnp.asarray(cand_s), jnp.asarray(cand_c), s_cap, 0.25)
        got = fst_pt._dedup_top_s(torch.from_numpy(cand_s).long(), torch.from_numpy(cand_c),
                                  s_cap, 0.25)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(r))

    cached = tp.device_arrays("cpu", n_ilabels=16)
    sets = torch.from_numpy(rng.integers(-1, tp.n_states, (5, 3))).long()
    costs = torch.from_numpy(rng.uniform(0, 2, (5, 3)).astype(np.float32))
    walk = fst_pt.fst_final_scores(dp, sets, costs)
    np.testing.assert_array_equal(_bits(walk.numpy()), _bits(
        fst_jax.fst_final_scores(dj, jnp.asarray(sets.numpy(), jnp.int32),
                                 jnp.asarray(costs.numpy()))))
    np.testing.assert_allclose(fst_pt.fst_final_scores(cached, sets, costs).numpy(),
                               walk.numpy(), rtol=1e-5, atol=1e-5)


def test_arpa_scores_through_the_port(tmp_path):
    """The ARPA chain rule through the port's queries: "a b c" from <s>
    takes the trigram p(b | <s> a), backs off from (a b) for c and ends
    through the backoff of (b c)."""
    path = tmp_path / "lm.arpa"
    path.write_text(ARPA)
    tables = fst_pt.compile_arpa(str(path), {"a": 1, "b": 2, "c": 3})
    dev = tables.device_arrays("cpu")
    states, costs = fst_pt.init_state_sets(tables, (1,), 4, device="cpu")
    for ilabel in (1, 2, 3):
        states, costs, lm = fst_pt.fst_advance_sets(dev, states, costs, torch.tensor([ilabel]))
    final = float(fst_pt.fst_final_scores(dev, states, costs)[0])
    # -0.30 (<s> a) -0.2 (<s> a b) -0.25 (a b c); </s> | b c: bow(b c) = 0
    # (implicit), bow of c missing (0) -> unigram </s> -0.8
    expected = -(0.30 + 0.2 + 0.25 + 0.8) * math.log(10)
    np.testing.assert_allclose(final, expected, rtol=1e-5)


def test_errors_match_jax(tmp_path):
    """The nondeterminism check, the text-format errors, a file that is not
    OpenFst and a write that would drop disambig arcs raise in both."""
    cases = {"nd.txt": "0 1 3 3 0.5\n0 2 3 3 0.7\n1 0\n2 0\n",
             "three.txt": "0 1 3 7\n1 2 4\n",
             "six.txt": "0 1 3 3 0.5 9\n"}
    for name, text in cases.items():
        (tmp_path / name).write_text(text)
        for module in (fst_jax, fst_pt):
            with pytest.raises(ValueError, match="nondeterministic|acceptor|field"):
                module.read_text_fst(str(tmp_path / name))
    (tmp_path / "six_acc.txt").write_text("0 1 3 0.5 9\n")
    (tmp_path / "junk.fst").write_bytes(b"\x00" * 64)
    for module in (fst_jax, fst_pt):
        with pytest.raises(ValueError, match="acceptor"):
            module.read_text_fst(str(tmp_path / "six_acc.txt"), acceptor=True)
        with pytest.raises(ValueError, match="not an OpenFst"):
            module.read_openfst_binary(str(tmp_path / "junk.fst"))
    _, tp = _both(11, disambig=True)
    with pytest.raises(ValueError, match="beyond disambig_ids"):
        fst_pt.write_openfst_binary(str(tmp_path / "x.fst"),
                                    dataclasses.replace(tp, disambig_ids=(90,)))
