"""n-gram FST shallow fusion: dense arc tables and their device queries
(port of ``pika_tpu/decode/fst.py``; its own copy of the host half, which
the JAX package keeps in a module that imports JAX).

* **Host** (numpy): the LM automaton compiled into dense CSR-style arrays --
  per-state ilabel-sorted arc slices (ilabel / weight / nextstate), a
  per-state backoff arc, final weights and a per-state disambig expansion
  table -- from an ARPA n-gram LM, an AT&T text FST or a binary OpenFst
  ``VectorFst<StdArc>``; and the host-built query caches (``final_best`` and
  the dense advance cache).  The arrays and the ``.advcache.npz`` files are
  the JAX package's, byte for byte: a cache file written by either package
  is read by the other.

* **Device** (torch): ``fst_advance_sets`` / ``fst_final_scores`` and the
  selection-time scores run inside the beam search's loop body, so they
  take no host sync and make no new shape (the loop is one CUDA graph on
  the card).  The JAX ``while_loop`` binary search is a loop of a fixed
  number of masked steps (``DeviceTables.search_iters``, from the longest
  arc slice), the ``lax.scan`` over backoff levels a Python loop of
  ``levels`` steps, and the vmap-of-vmap walks broadcasts over
  (..., S, D+1, levels).  The float32 adds, mins and gathers run in the JAX
  order, so on the CPU every query equals the JAX one bit for bit.

State sets are fixed-capacity (``max_states``) with -1 / +INF padding.
States are int64 on the device (torch indexes with them); the tables keep
the JAX package's int32 and float32.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pika_tpu_torch.decode.topk import top_k
from pika_tpu_torch.device import resolve_device

INF = np.float32(1e30)
LOG10 = math.log(10.0)
_INF = float(INF)       # the float32 1e30 as a Python float: exact in every float32 op
_HALF_INF = _INF / 2    # float32 INF / 2, exact


@dataclasses.dataclass
class FstTables:
    """Dense LM automaton. Arc slices are ilabel-sorted per state."""

    arc_start: np.ndarray      # (n_states+1,) int32 CSR offsets
    arc_ilabel: np.ndarray     # (n_arcs,) int32
    arc_weight: np.ndarray     # (n_arcs,) float32 (tropical: -ln p)
    arc_next: np.ndarray       # (n_arcs,) int32
    backoff_next: np.ndarray   # (n_states,) int32, -1 if none
    backoff_weight: np.ndarray # (n_states,) float32
    final_weight: np.ndarray   # (n_states,) float32, +INF if not final
    start: int
    # disambig expansion: (n_states, D) extra init states/costs, -1 padded
    disambig_next: np.ndarray
    disambig_weight: np.ndarray
    max_backoff_levels: int = 6
    # the original disambig ilabels (column j of disambig_next/weight holds
    # arcs with ilabel disambig_ids[j]) and the backoff ilabel, kept so that
    # write_openfst_binary writes them back out unchanged
    disambig_ids: Tuple[int, ...] = ()
    backoff_id: int = 0

    @property
    def n_states(self) -> int:
        return len(self.backoff_next)

    def fingerprint(self, n_ilabels: int, levels: Optional[int]) -> str:
        """Content hash of everything ``build_advance_cache`` consumes: the
        key of an on-disk cache (``cache_file``), the JAX package's."""
        h = hashlib.sha1()
        for a in (self.arc_start, self.arc_ilabel, self.arc_weight,
                  self.arc_next, self.backoff_next, self.backoff_weight,
                  self.final_weight, self.disambig_next, self.disambig_weight):
            h.update(np.ascontiguousarray(a).tobytes())
        lv = levels if levels is not None else self.max_backoff_levels
        h.update(f"{n_ilabels}:{lv}:{self.start}".encode())
        return h.hexdigest()

    def device_arrays(
        self,
        device=None,
        n_ilabels: Optional[int] = None,
        cache_max_bytes: int = 0,
        levels: Optional[int] = None,
        cache_file: Optional[str] = None,
    ) -> "DeviceTables":
        """The CSR tables as tensors on ``device`` (the CUDA card unless
        another is named), under the JAX package's keys.  With ``n_ilabels``
        set, also the host-built query caches: ``final_best`` (N floats,
        always) and, when it fits ``cache_max_bytes``, the dense advance
        cache (``adv_cost`` float32, ``adv_next`` int32, (N, V, Lm)) that
        turns the per-token decode step's backoff walks into one gather.

        ``cache_file`` keeps the advance cache across runs: a file whose
        recorded fingerprint matches these tables is read instead of
        rebuilt; otherwise the built cache is written there (a temporary
        file, then ``os.replace``, so a killed run leaves no truncated
        cache).  The tensors are what a captured decode graph reads: a
        cached beam loop holds them for the model's life."""
        device = resolve_device(device)
        arrays = {
            "arc_start": self.arc_start,
            "arc_ilabel": self.arc_ilabel,
            "arc_weight": self.arc_weight,
            "arc_next": self.arc_next,
            "backoff_next": self.backoff_next,
            "backoff_weight": self.backoff_weight,
            "final_weight": self.final_weight,
            "disambig_next": self.disambig_next,
            "disambig_weight": self.disambig_weight,
        }
        if n_ilabels is not None:
            arrays["final_best"] = build_final_cache(self)
            if cache_max_bytes > 0:
                cache = None
                fp = None
                if cache_file:
                    fp = self.fingerprint(n_ilabels, levels)
                    if os.path.exists(cache_file):
                        with np.load(cache_file) as z:
                            if str(z["fingerprint"]) == fp:
                                cache = {"adv_cost": z["adv_cost"],
                                         "adv_next": z["adv_next"]}
                if cache is None:
                    cache = build_advance_cache(
                        self, n_ilabels, levels=levels,
                        max_bytes=cache_max_bytes)
                    if cache is not None and cache_file:
                        # the .npz suffix keeps np.savez from renaming
                        tmp = cache_file + ".tmp.npz"
                        np.savez(tmp, adv_cost=cache["adv_cost"],
                                 adv_next=cache["adv_next"], fingerprint=fp)
                        os.replace(tmp, cache_file)
                if cache is not None:
                    arrays["adv_cost"] = cache["adv_cost"]
                    arrays["adv_next"] = cache["adv_next"]
        out = DeviceTables({name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                            for name, a in arrays.items()})
        out.search_iters = _search_iters_of(self.arc_start)
        out.key = (self.fingerprint(-1 if n_ilabels is None else n_ilabels, levels),
                   tuple(sorted(out)), str(device))
        return out


class DeviceTables(dict):
    """``FstTables.device_arrays``' tensors by name, and two host facts
    made with them: ``search_iters``, the binary search's fixed step count,
    and ``key``, the content fingerprint that the decode loops' cache keys
    on (a graph captured against one LM's tensors never replays against
    another's)."""

    search_iters: int
    key: tuple


def _search_iters_of(arc_start: np.ndarray) -> int:
    """Steps of a binary search over the longest arc slice: a slice of n
    arcs halves to floor(n / 2) each step, so ceil(log2(n + 1)) steps end
    every search."""
    longest = int(np.diff(arc_start).max()) if len(arc_start) > 1 else 0
    return max(1, math.ceil(math.log2(longest + 1)))


def _build_tables(
    n_states: int,
    arcs: Dict[int, List[Tuple[int, float, int]]],
    finals: Dict[int, float],
    start: int,
    backoff_id: int,
    disambig_ids: Optional[List[int]] = None,
    max_backoff_levels: int = 6,
) -> FstTables:
    disambig_ids = disambig_ids or []
    arc_start = np.zeros(n_states + 1, np.int32)
    ilabels, weights, nexts = [], [], []
    backoff_next = np.full(n_states, -1, np.int32)
    backoff_weight = np.zeros(n_states, np.float32)
    d = max(1, len(disambig_ids))
    dis_next = np.full((n_states, d), -1, np.int32)
    dis_weight = np.full((n_states, d), INF, np.float32)
    for s in range(n_states):
        slist = sorted(arcs.get(s, []))
        # The searched tables hold ONE arc per (state, ilabel) and one
        # backoff arc per state (the reference's SortedMatcher makes the
        # same determinism assumption).  A nondeterministic input would be
        # silently mis-scored: refuse it.
        labels = [a[0] for a in slist]
        if len(labels) != len(set(labels)):
            dup = sorted({l for l in labels if labels.count(l) > 1})
            raise ValueError(
                f"FST is nondeterministic: state {s} has multiple arcs for "
                f"ilabel(s) {dup}; determinize it first")
        kept = []
        for ilabel, w, ns in slist:
            if ilabel == backoff_id:
                backoff_next[s] = ns
                backoff_weight[s] = w
            elif ilabel in disambig_ids:
                j = disambig_ids.index(ilabel)
                dis_next[s, j] = ns
                dis_weight[s, j] = w
            else:
                kept.append((ilabel, w, ns))
        arc_start[s + 1] = arc_start[s] + len(kept)
        for ilabel, w, ns in kept:
            ilabels.append(ilabel)
            weights.append(w)
            nexts.append(ns)
    final_weight = np.full(n_states, INF, np.float32)
    for s, w in finals.items():
        final_weight[s] = w
    return FstTables(
        arc_start=arc_start,
        arc_ilabel=np.asarray(ilabels, np.int32),
        arc_weight=np.asarray(weights, np.float32),
        arc_next=np.asarray(nexts, np.int32),
        backoff_next=backoff_next,
        backoff_weight=backoff_weight,
        final_weight=final_weight,
        start=start,
        disambig_next=dis_next,
        disambig_weight=dis_weight,
        max_backoff_levels=max_backoff_levels,
        disambig_ids=tuple(disambig_ids),
        backoff_id=backoff_id,
    )


def read_text_fst(
    path: str,
    backoff_id: int = 0,
    disambig_ids: Optional[List[int]] = None,
    acceptor: bool = False,
) -> FstTables:
    """Read an AT&T text-format FST into dense tables.

    Transducer format (default): arc ``src dst ilabel olabel [w]``, final
    ``state [w]``.  Acceptor format (``fstcompile --acceptor`` output): arc
    ``src dst ilabel [w]``; pass ``acceptor=True``, since the two formats'
    4-field arc lines are ambiguous (olabel or weight), which is why
    OpenFst needs the flag too.  The first line's source state is the
    start state (OpenFst's convention)."""
    arcs: Dict[int, List[Tuple[int, float, int]]] = {}
    finals: Dict[int, float] = {}
    start = None
    max_state = 0
    arc_fields = 3 if acceptor else 4
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            parts = line.split()
            if not parts:
                continue
            if len(parts) >= arc_fields:
                if len(parts) > arc_fields + 1:
                    raise ValueError(
                        f"{path}:{lineno}: {len(parts)}-field line in "
                        f"{'acceptor' if acceptor else 'transducer'} format "
                        f"(did you mean acceptor={not acceptor}?)")
                s, d_, il = int(parts[0]), int(parts[1]), int(parts[2])
                w = float(parts[arc_fields]) if len(parts) > arc_fields else 0.0
                arcs.setdefault(s, []).append((il, w, d_))
                max_state = max(max_state, s, d_)
                if start is None:
                    start = s
            else:
                if len(parts) > 2:
                    raise ValueError(
                        f"{path}:{lineno}: 3-field line is not a valid "
                        f"transducer arc or final state — unweighted "
                        f"acceptor input needs acceptor=True")
                s = int(parts[0])
                w = float(parts[1]) if len(parts) > 1 else 0.0
                finals[s] = w
                max_state = max(max_state, s)
                if start is None:
                    start = s
    return _build_tables(max_state + 1, arcs, finals, start or 0,
                         backoff_id, disambig_ids)


_OPENFST_MAGIC = 2125659606
_SYMBOL_TABLE_MAGIC = 2125658996


def read_openfst_binary(
    path: str,
    backoff_id: int = 0,
    disambig_ids: Optional[List[int]] = None,
) -> FstTables:
    """Read a binary OpenFst ``VectorFst<StdArc>`` (what the reference
    loads with ``fst.StdVectorFst.read``).  Layout: the FstHeader (magic,
    fst and arc type strings, version, flags, properties, start, numstates,
    numarcs), the embedded SymbolTables its flags announce (0x1 input, 0x2
    output; skipped), then per state the final weight (f32), the arc count
    (i64) and the arcs (ilabel i32, olabel i32, weight f32, nextstate
    i32)."""
    with open(path, "rb") as f:
        def read_i32():
            return struct.unpack("<i", f.read(4))[0]

        def read_i64():
            return struct.unpack("<q", f.read(8))[0]

        def read_string():
            n = read_i32()
            return f.read(n).decode()

        magic = read_i32()
        if magic != _OPENFST_MAGIC:
            raise ValueError(f"not an OpenFst binary file (magic {magic})")
        fsttype = read_string()
        arctype = read_string()
        if arctype != "standard":
            raise ValueError(f"unsupported arc type {arctype!r}")
        if fsttype not in ("vector",):
            raise ValueError(f"unsupported fst type {fsttype!r}")
        _version = read_i32()
        flags = read_i32()
        _properties = struct.unpack("<Q", f.read(8))[0]
        start = read_i64()
        numstates = read_i64()
        _numarcs = read_i64()

        def skip_symbol_table():
            # magic, name, available_key, size, then size x (symbol, i64 key)
            st_magic = read_i32()
            if st_magic != _SYMBOL_TABLE_MAGIC:
                raise ValueError(
                    f"embedded SymbolTable has unexpected magic {st_magic}; "
                    "re-write the FST without symbol tables "
                    "(fstcompile without --keep_isymbols/--keep_osymbols)")
            read_string()  # name
            read_i64()     # available_key
            size = read_i64()
            for _ in range(size):
                read_string()
                read_i64()

        if flags & 0x1:
            skip_symbol_table()
        if flags & 0x2:
            skip_symbol_table()

        arcs: Dict[int, List[Tuple[int, float, int]]] = {}
        finals: Dict[int, float] = {}
        for s_id in range(numstates):
            (final_w,) = struct.unpack("<f", f.read(4))
            narcs = read_i64()
            if final_w != float("inf"):
                finals[s_id] = final_w
            if narcs:
                raw = f.read(16 * narcs)
                lst = arcs.setdefault(s_id, [])
                for k in range(narcs):
                    il, _ol, w, ns = struct.unpack_from("<iifi", raw, 16 * k)
                    lst.append((il, w, ns))
    return _build_tables(numstates, arcs, finals, max(start, 0),
                         backoff_id, disambig_ids)


def write_openfst_binary(
    path: str,
    tables: FstTables,
    isymbols: Optional[Dict[str, int]] = None,
    osymbols: Optional[Dict[str, int]] = None,
    backoff_id: Optional[int] = None,
) -> None:
    """Write dense tables back out as a binary ``VectorFst<StdArc>``.
    Backoff arcs are written with ``backoff_id`` (by default the id the
    tables were read with, so a read-write round trip relabels nothing)
    and disambig arcs with their original ilabels
    (``tables.disambig_ids``).  ``isymbols`` / ``osymbols`` (symbol -> id)
    embed OpenFst SymbolTables after the header and set the header flags
    0x1 / 0x2, the layout ``fstcompile --keep_isymbols --keep_osymbols``
    writes."""
    if backoff_id is None:
        backoff_id = tables.backoff_id
    uncovered = np.asarray(tables.disambig_next[:, len(tables.disambig_ids):])
    if (uncovered >= 0).any():
        raise ValueError(
            "FstTables has disambig arcs in columns beyond disambig_ids "
            f"({len(tables.disambig_ids)} ids, "
            f"{tables.disambig_next.shape[1]} columns) — their original "
            "ilabels are unknown, so writing would silently drop them")
    n = tables.n_states
    with open(path, "wb") as f:
        def w_i32(v):
            f.write(struct.pack("<i", v))

        def w_i64(v):
            f.write(struct.pack("<q", v))

        def w_str(v):
            data = v.encode("utf-8")
            w_i32(len(data))  # the BYTE count: multi-byte symbols ("▁a")
            f.write(data)

        def w_symbol_table(name, mapping):
            w_i32(_SYMBOL_TABLE_MAGIC)
            w_str(name)
            items = sorted(mapping.items(), key=lambda kv: kv[1])
            w_i64((items[-1][1] + 1) if items else 1)  # available_key
            w_i64(len(items))
            for sym, key in items:
                w_str(sym)
                w_i64(key)

        w_i32(_OPENFST_MAGIC)
        w_str("vector")
        w_str("standard")
        w_i32(2)          # version
        flags = (0x1 if isymbols is not None else 0) | (
            0x2 if osymbols is not None else 0)
        w_i32(flags)
        f.write(struct.pack("<Q", 0))  # properties
        w_i64(tables.start)
        w_i64(n)
        total_arcs = 0
        state_arcs = []
        for s_id in range(n):
            lst = [
                (int(tables.arc_ilabel[i]), float(tables.arc_weight[i]), int(tables.arc_next[i]))
                for i in range(int(tables.arc_start[s_id]), int(tables.arc_start[s_id + 1]))
            ]
            if tables.backoff_next[s_id] >= 0:
                lst.append((backoff_id, float(tables.backoff_weight[s_id]),
                            int(tables.backoff_next[s_id])))
            for j, dis_id in enumerate(tables.disambig_ids):
                if tables.disambig_next[s_id, j] >= 0:
                    lst.append((int(dis_id),
                                float(tables.disambig_weight[s_id, j]),
                                int(tables.disambig_next[s_id, j])))
            lst.sort()
            state_arcs.append(lst)
            total_arcs += len(lst)
        w_i64(total_arcs)
        if isymbols is not None:
            w_symbol_table("isymbols", isymbols)
        if osymbols is not None:
            w_symbol_table("osymbols", osymbols)
        for s_id in range(n):
            fw = float(tables.final_weight[s_id])
            f.write(struct.pack("<f", fw if fw < INF else float("inf")))
            w_i64(len(state_arcs[s_id]))
            for il, w, ns in state_arcs[s_id]:
                f.write(struct.pack("<iifi", il, il, w, ns))


def compile_arpa(
    path: str,
    symbol_to_id: Dict[str, int],
    backoff_id: int = 0,
) -> FstTables:
    """Compile an ARPA n-gram LM into the standard backoff automaton.

    States are n-gram contexts; each n-gram ``w1..wk`` adds an arc from
    state(w1..wk-1) on symbol wk with weight ``-ln(10^log10p)``; backoff
    arcs connect each context to its suffix with the backoff weight;
    ``</s>`` probabilities become final weights.  Symbol ids follow the
    decode side's ``ilabel = token_id + 1``: ``symbol_to_id`` maps LM words
    to the shifted FST ilabels."""
    ngrams: Dict[int, List[Tuple[Tuple[str, ...], float, Optional[float]]]] = {}
    order = 0
    with open(path, "r", encoding="utf-8") as f:
        section = None
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("\\") and "-grams:" in line:
                section = int(line[1: line.index("-")])
                order = max(order, section)
                ngrams[section] = []
                continue
            if line.startswith("\\") or line.startswith("ngram") or line == "\\data\\":
                if line == "\\end\\":
                    break
                continue
            if section is None:
                continue
            parts = line.split()
            logp = float(parts[0])
            words = tuple(parts[1 : 1 + section])
            bow = float(parts[1 + section]) if len(parts) > 1 + section else None
            ngrams[section].append((words, logp, bow))

    state_of: Dict[Tuple[str, ...], int] = {(): 0}

    def get_state(ctx: Tuple[str, ...]) -> int:
        if ctx not in state_of:
            state_of[ctx] = len(state_of)
        return state_of[ctx]

    arcs: Dict[int, List[Tuple[int, float, int]]] = {}
    finals: Dict[int, float] = {}
    backoffs: Dict[int, Tuple[float, int]] = {}

    for n in sorted(ngrams):
        for words, logp, bow in ngrams[n]:
            ctx, w = words[:-1], words[-1]
            src = get_state(ctx)  # histories must exist as states
            weight = -logp * LOG10
            if w == "</s>":
                finals[src] = min(finals.get(src, float(INF)), weight)
                continue
            # lower orders land on the full-context state; the highest
            # order has no state of its own and drops the oldest word
            dst = get_state(words if n < order else words[1:])
            # the backoff is registered before the emittable-token check:
            # the context is reachable even when its word is not a token
            # (the <s> unigram's context is the start state; dropping its
            # bow would inflate utterance-initial LM scores)
            if bow is not None and n < order:
                backoffs[get_state(words)] = (-bow * LOG10, get_state(words[1:]))
            if w not in symbol_to_id:
                continue
            arcs.setdefault(src, []).append((symbol_to_id[w], weight, dst))

    n_states = len(state_of)
    for s, (w, dst) in backoffs.items():
        arcs.setdefault(s, []).append((backoff_id, w, dst))
    # every non-unigram context backs off somewhere; contexts made
    # implicitly (no explicit bow) back off with weight 0 to their suffix
    for ctx, s in state_of.items():
        if ctx and s not in backoffs:
            arcs.setdefault(s, []).append((backoff_id, 0.0, state_of.get(ctx[1:], 0)))

    start = state_of.get(("<s>",), 0)
    return _build_tables(n_states, arcs, finals, start, backoff_id)


# ---------------------------------------------------------------------------
# host-built query caches
# ---------------------------------------------------------------------------

def build_final_cache(tables: FstTables) -> np.ndarray:
    """Per-state best final cost: what ``fst_final_scores``'s walk computes
    for one state at cost 0, one scalar per state, so the finished-score
    query of a decode step is a gather and a min.  The walk stops at the
    FIRST state of the backoff chain with a finite final weight."""
    n = tables.n_states
    levels = tables.max_backoff_levels
    cur = np.arange(n, dtype=np.int64)
    acc = np.zeros(n, np.float32)
    best = np.full(n, INF, np.float32)
    done = np.zeros(n, bool)
    alive = np.ones(n, bool)
    for _ in range(levels):
        safe = np.maximum(cur, 0)
        fw = np.where(cur >= 0, tables.final_weight[safe], INF)
        hit = (fw < INF) & ~done & alive
        best = np.where(hit, acc + fw, best)
        done |= hit
        bo_next = np.where(cur >= 0, tables.backoff_next[safe], -1)
        bo_w = np.where(cur >= 0, tables.backoff_weight[safe], 0.0)
        acc = acc + np.where(alive & ~done, bo_w, 0.0)
        cur = np.where(alive & ~done, bo_next, -1)
        alive = alive & ~done & (cur >= 0)
    # fold the disambig expansion: min over {(0, s)} and the disambig arcs
    chain = best
    out = chain.copy()
    for j in range(tables.disambig_next.shape[1]):
        dn = tables.disambig_next[:, j]
        dw = tables.disambig_weight[:, j]
        valid = dn >= 0
        cand = np.where(valid, dw + chain[np.maximum(dn, 0)], INF)
        out = np.minimum(out, cand.astype(np.float32))
    return out.astype(np.float32)


def build_advance_cache(
    tables: FstTables,
    n_ilabels: int,
    levels: Optional[int] = None,
    max_bytes: int = 512 << 20,
    chunk: int = 512,
) -> Optional[dict]:
    """For every (state, ilabel), the advance-set result of the device walk
    (``expand_disambig`` + ``backoff_matches``): the unique (cost,
    nextstate) matches, min-cost deduplicated and cost-sorted, padded to
    the LM's largest match count ``Lm`` (1 for a bigram).  The per-token
    decode step then replaces its backoff walks with one gather.

    Returns {"adv_cost": (N, V, Lm) f32, "adv_next": (N, V, Lm) i32} as
    numpy, or None when the cache would exceed ``max_bytes`` (gated at
    Lm = 1 first, the exact size checked again after the build)."""
    n = tables.n_states
    v = n_ilabels
    if levels is None:
        levels = tables.max_backoff_levels
    # the dense per-level lookup alone is n*v*8 bytes
    if n * v * 8 > max_bytes:
        return None

    # dense one-step lookup: W[s, i] / Nn[s, i] for the state's own arcs
    W = np.full((n, v), INF, np.float32)
    Nn = np.full((n, v), -1, np.int32)
    src = np.repeat(np.arange(n, dtype=np.int64),
                    np.diff(tables.arc_start).astype(np.int64))
    il = tables.arc_ilabel.astype(np.int64)
    in_range = il < v
    W[src[in_range], il[in_range]] = tables.arc_weight[in_range]
    Nn[src[in_range], il[in_range]] = tables.arc_next[in_range]

    # per-state backoff chains (levels deep), shared by every ilabel
    d_cols = tables.disambig_next.shape[1]
    has_disambig = bool((tables.disambig_next >= 0).any())
    inits = [(np.zeros(n, np.float32), np.arange(n, dtype=np.int64))]
    if has_disambig:
        for j in range(d_cols):
            dn = tables.disambig_next[:, j].astype(np.int64)
            dw = np.where(dn >= 0, tables.disambig_weight[:, j], INF)
            inits.append((dw.astype(np.float32), dn))
    chains = []  # (acc (n,), state (n,)) per (init, level)
    for init_cost, init_state in inits:
        cur = init_state.copy()
        acc = init_cost.copy()
        for _ in range(levels):
            chains.append((acc.copy(), cur.copy()))
            safe = np.maximum(cur, 0)
            bo_next = np.where(cur >= 0, tables.backoff_next[safe], -1)
            bo_w = np.where(cur >= 0, tables.backoff_weight[safe], 0.0)
            acc = acc + bo_w.astype(np.float32)
            cur = bo_next.astype(np.int64)
    lp = len(chains)

    cost_parts: List[np.ndarray] = []
    next_parts: List[np.ndarray] = []
    lm_max = 1
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        cc = np.empty((lp, c1 - c0, v), np.float32)
        nn = np.empty((lp, c1 - c0, v), np.int32)
        for li, (acc, cur) in enumerate(chains):
            a = acc[c0:c1, None]
            s = cur[c0:c1]
            safe = np.maximum(s, 0)
            w = W[safe]
            nx = Nn[safe]
            dead = (s < 0)[:, None] | (nx < 0)
            cc[li] = np.where(dead, INF, a + w)
            nn[li] = np.where(dead, -1, nx)
        # sort by cost along the match axis, then min-cost dedup by next
        order = np.argsort(cc, axis=0, kind="stable")
        cc = np.take_along_axis(cc, order, axis=0)
        nn = np.take_along_axis(nn, order, axis=0)
        for j in range(1, lp):
            dup = np.zeros(cc.shape[1:], bool)
            for jj in range(j):
                dup |= (nn[j] == nn[jj]) & (nn[jj] >= 0)
            cc[j] = np.where(dup, INF, cc[j])
            nn[j] = np.where(dup, -1, nn[j])
        order = np.argsort(cc, axis=0, kind="stable")
        cc = np.take_along_axis(cc, order, axis=0)
        nn = np.take_along_axis(nn, order, axis=0)
        counts = (cc < INF).sum(axis=0)
        lm_chunk = max(1, int(counts.max()) if counts.size else 1)
        lm_max = max(lm_max, lm_chunk)
        cost_parts.append(np.swapaxes(cc[:lm_chunk], 0, 1))  # (C, lm, V)
        next_parts.append(np.swapaxes(nn[:lm_chunk], 0, 1))
    if n * v * lm_max * 8 > max_bytes:
        return None

    adv_cost = np.full((n, lm_max, v), INF, np.float32)
    adv_next = np.full((n, lm_max, v), -1, np.int32)
    at = 0
    for cp, npart in zip(cost_parts, next_parts):
        adv_cost[at : at + cp.shape[0], : cp.shape[1]] = cp
        adv_next[at : at + cp.shape[0], : cp.shape[1]] = npart
        at += cp.shape[0]
    # (N, V, Lm): the decode step's gather indexes [state, ilabel]
    return {
        "adv_cost": np.ascontiguousarray(np.swapaxes(adv_cost, 1, 2)),
        "adv_next": np.ascontiguousarray(np.swapaxes(adv_next, 1, 2)),
    }


# ---------------------------------------------------------------------------
# device queries
# ---------------------------------------------------------------------------

def _search_arc_fast(tables: "DeviceTables", state, ilabel):
    """Binary search of ``ilabel`` within each state's CSR slice, by global
    arc position: ``(found, weight or INF, nextstate or -1)``.  A fixed
    number of steps, each masked by ``lo < hi``, with every gather index
    clamped: the steps after a search has ended change nothing."""
    arc_ilabel = tables["arc_ilabel"]
    n_arcs = arc_ilabel.shape[0]
    safe_state = state.clamp(min=0)
    lo = tables["arc_start"][safe_state].long()
    end = tables["arc_start"][safe_state + 1].long()
    if n_arcs == 0:
        found = torch.zeros_like(state, dtype=torch.bool)
        return found, torch.full(state.shape, _INF, device=state.device), torch.full_like(state, -1)
    hi = end
    for _ in range(tables.search_iters):
        mid = (lo + hi) // 2
        go_right = arc_ilabel[mid.clamp(max=n_arcs - 1)] < ilabel
        active = lo < hi
        lo, hi = (torch.where(active & go_right, mid + 1, lo),
                  torch.where(active & ~go_right, mid, hi))
    pos = lo.clamp(max=n_arcs - 1)
    found = (lo < end) & (arc_ilabel[pos] == ilabel) & (state >= 0)
    return (found,
            torch.where(found, tables["arc_weight"][pos], _INF),
            torch.where(found, tables["arc_next"][pos].long(), -1))


def backoff_matches(tables: dict, state, ilabel, init_cost, levels: int):
    """The (cost, nextstate) match at every backoff level, the reference's
    get_scores_wodisambig walk: (costs (..., levels), states (..., levels))
    with +INF / -1 padding."""
    cur, acc = state, init_cost
    costs, states = [], []
    for _ in range(levels):
        found, w, ns = _search_arc_fast(tables, cur, ilabel)
        costs.append(torch.where(found, acc + w, _INF))
        states.append(torch.where(found, ns, -1))
        safe = cur.clamp(min=0)
        bo_next = torch.where(cur >= 0, tables["backoff_next"][safe].long(), -1)
        bo_w = torch.where(cur >= 0, tables["backoff_weight"][safe], 0.0)
        cur = torch.where(bo_next >= 0, bo_next, -1)
        acc = acc + torch.where(bo_next >= 0, bo_w, 0.0)
    return torch.stack(costs, -1), torch.stack(states, -1)


def expand_disambig(tables: dict, state):
    """The initial expansion, [(0, state)] and the state's disambig arcs:
    (costs (..., D+1), states (..., D+1))."""
    safe = state.clamp(min=0)
    dn = torch.where((state >= 0)[..., None], tables["disambig_next"][safe].long(), -1)
    dw = torch.where(dn >= 0, tables["disambig_weight"][safe], _INF)
    own = state >= 0
    costs = torch.cat([torch.where(own, 0.0, _INF)[..., None], dw], -1)
    states = torch.cat([torch.where(own, state, -1)[..., None], dn], -1)
    return costs, states


def _dedup_top_s(cand_states, cand_costs, s_cap: int, nonblk_reward):
    """Min-cost-per-unique-state dedup, then the ``s_cap`` cheapest,
    batched over leading dims; ``cand_*`` are (..., M).  Ties between equal
    costs break toward the lower candidate index (``top_k``'s stable sort,
    as ``jax.lax.top_k``).  Returns (new_states (..., s_cap), new_costs,
    lm_score (...,)): lm_score = -min(new_costs), or -INF for a dead set."""
    m = cand_states.shape[-1]
    valid = cand_states >= 0
    cc = torch.where(valid, cand_costs, _INF)
    # candidate j is a dup if some j' with the same state strictly beats it
    # (lower cost, or equal cost and lower index)
    ar = torch.arange(m, device=cand_states.device)
    same = cand_states[..., :, None] == cand_states[..., None, :]
    beats = (cc[..., None, :] < cc[..., :, None]) | (
        (cc[..., None, :] == cc[..., :, None]) & (ar[None, :] < ar[:, None]))
    is_dup = (same & beats & valid[..., None, :]).any(-1)
    cc = torch.where(is_dup, _INF, cc)
    kept_neg, idx = top_k(-cc, s_cap)
    kept_cost = -kept_neg
    kept_state = cand_states.gather(-1, idx)
    live = kept_cost < _INF
    new_states = torch.where(live, kept_state, -1)
    new_costs = torch.where(live, kept_cost - nonblk_reward, _INF)
    lm = torch.where((new_states >= 0).any(-1), -new_costs.amin(-1), -_INF)
    return new_states, new_costs, lm


def fst_advance_min_costs(tables: dict, states, costs, ilabel, nonblk_reward: float = 0.0):
    """The selection-time LM score from the dense advance cache, without
    the advanced set: ``nonblk_reward - min_{j,l}(costs_j + adv_cost[state_j,
    ilabel, l])``, -INF for a dead set; equal bit for bit to
    ``fst_advance_sets``' ``lm_score`` (the dedup and top-S keep the min).
    ``states``, ``costs`` (..., S); ``ilabel`` (...).  Needs ``adv_cost``."""
    lab = ilabel[..., None].clamp(0, tables["adv_cost"].shape[1] - 1)
    safe_s = states.clamp(min=0)
    ac = tables["adv_cost"][safe_s, lab]           # (..., S, Lm)
    entry_ok = ((states >= 0) & (costs < _INF))[..., None]
    total = torch.where(entry_ok, costs[..., None] + ac, _INF)
    minc = total.amin(dim=(-2, -1))
    return torch.where(minc < _HALF_INF, nonblk_reward - minc, -_INF)


def fst_advance_min_costs_all(tables: dict, states, costs, nonblk_reward: float = 0.0):
    """The exact per-token selection scores: the advance LM score of EVERY
    ilabel at once, one row gather ``adv_cost[states]`` (each row a
    contiguous (V, Lm) block) and a min over the state set.  Returns
    (..., V_ilabels)."""
    safe_s = states.clamp(min=0)
    ra = tables["adv_cost"][safe_s]                # (..., S, Vt, Lm)
    entry_ok = ((states >= 0) & (costs < _INF))[..., None, None]
    total = torch.where(entry_ok, costs[..., None, None] + ra, _INF)
    minc = total.amin(-1).amin(-2)                 # (..., Vt)
    return torch.where(minc < _HALF_INF, nonblk_reward - minc, -_INF)


def fst_advance_sets(tables: dict, states, costs, ilabel, levels: int = 6,
                     nonblk_reward: float = 0.0):
    """Advance every beam's FST state set on an emitted label: (new_states,
    new_costs, lm_score), lm_score = -min cost (-INF when the set dies).
    ``states`` (..., S) with -1 padding, ``costs`` (..., S) with INF
    padding, ``ilabel`` (...).

    With the advance cache in ``tables`` the disambig expansion and the
    backoff walks are one gather of the (state, ilabel) match list;
    without it they are walked: (..., S, D+1, levels) candidates, in the
    JAX vmap's order (state, disambig init, level)."""
    s_cap = states.shape[-1]
    if "adv_cost" in tables:
        lab = ilabel[..., None].clamp(0, tables["adv_cost"].shape[1] - 1)
        safe_s = states.clamp(min=0)
        ac = tables["adv_cost"][safe_s, lab]       # (..., S, Lm)
        an = tables["adv_next"][safe_s, lab].long()
        entry_ok = ((states >= 0) & (costs < _INF))[..., None]
        cand_states = torch.where(entry_ok, an, -1)
        cand_costs = torch.where(entry_ok & (an >= 0), costs[..., None] + ac, _INF)
        flat = states.shape[:-1] + (s_cap * ac.shape[-1],)
        return _dedup_top_s(cand_states.reshape(flat), cand_costs.reshape(flat), s_cap,
                            nonblk_reward)

    d_costs, d_states = expand_disambig(tables, states)          # (..., S, D+1)
    m_costs, m_states = backoff_matches(tables, d_states, ilabel[..., None, None], d_costs,
                                        levels)                  # (..., S, D+1, levels)
    cand_costs = costs[..., None, None] + m_costs
    flat = states.shape[:-1] + (-1,)
    return _dedup_top_s(m_states.reshape(flat), cand_costs.reshape(flat), s_cap, nonblk_reward)


def fst_final_scores(tables: dict, states, costs, levels: int = 6):
    """Each beam's final LM score: -min over its state set of (cost + the
    final weight reached through backoff), with the disambig expansion; the
    walk stops at the first final state of a chain.  With ``final_best``
    (``build_final_cache``) a gather and a min; without it the walk over
    (..., S, D+1) chains."""
    if "final_best" in tables:
        safe = states.clamp(min=0)
        fb = tables["final_best"][safe]
        ok = (states >= 0) & (costs < _INF) & (fb < _INF)
        best = torch.where(ok, costs + fb, _INF).amin(-1)
        return torch.where(best < _INF, -best, -_INF)

    d_costs, cur = expand_disambig(tables, states)
    acc = costs[..., None] + d_costs
    best = torch.full_like(acc, _INF)
    for _ in range(levels):
        safe = cur.clamp(min=0)
        fw = torch.where(cur >= 0, tables["final_weight"][safe], _INF)
        hit = fw < _INF
        best = torch.minimum(best, torch.where(hit, acc + fw, _INF))
        bo_next = torch.where(cur >= 0, tables["backoff_next"][safe].long(), -1)
        bo_w = torch.where(cur >= 0, tables["backoff_weight"][safe], 0.0)
        cur = torch.where(hit, -1, bo_next)  # stop after the first final hit
        acc = acc + bo_w
    best = best.amin(-1).amin(-1)
    return torch.where(best < _INF, -best, -_INF)


def init_state_sets(tables: FstTables, shape, max_states: int, device=None):
    """Fresh per-beam state sets {start: 0.0}: int64 states and float32
    costs of shape ``shape + (max_states,)`` on ``device`` (the CUDA card
    unless another is named)."""
    device = resolve_device(device)
    states = torch.full(tuple(shape) + (max_states,), -1, dtype=torch.long, device=device)
    costs = torch.full(tuple(shape) + (max_states,), _INF, device=device)
    states[..., 0] = tables.start
    costs[..., 0] = 0.0
    return states, costs
