"""Temporal knowledge graphs: quadruples, vocabularies, time indexing.

Port of ``redgnn_tpu/graph/temporal.py`` (`Vocab`, `TemporalKG`). The
host side is the same numpy code: name-based TSV dirs with `_PAD`/`_UNK`
vocabularies and the `idd` self-loop relation at a far-future dummy
timestamp (`Temporal/interpolation/{graph,util}.py`), and id-based dirs
(`entity2id.txt` / `relation2id.txt`, 4-or-5-column quadruples) with
inverse relations, time-sorted splits, the propagation graph over all
splits, the warm start and the seen/unseen eval splits
(`Temporal/extrapolation/utils.py:19-121`). The graph is re-indexed into
a CSR sorted by (head, time), so any per-query time window is a
contiguous slice of a row; the device side holds that CSR, the
per-slot times and composite keys, each entity's self-loop slot, the
(entity, time) -> first-slot table and the tail-sorted table of the
dense hops, as int32 tensors on an explicit device.
`negative_sampling_objects` and `neighbor_subgraph` are the host-side
numpy samplers of the xERTE tooling, driven by a `np.random.Generator`
(the same draws as the JAX package's for the same seed).
"""

from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from redgnn_tpu_torch.graph.kg import (
    DeviceGraph,
    build_src_order,
    build_time_order,
)
from redgnn_tpu_torch.ops.dense_hop import tail_items
from redgnn_tpu_torch.utils.device import resolve_device


class Vocab:
    """Token vocabulary with `_PAD`/`_UNK` specials (`util.py:54-93`)."""

    def __init__(self, specials=("_PAD", "_UNK")):
        self.itos: List[str] = list(specials)
        self.stoi: Dict[str, int] = {}
        self._freq: Counter = Counter()
        self._built = False

    def update(self, tokens):
        self._freq.update(tokens)

    def build(self, sort_key: str = "freq"):
        assert not self._built
        if sort_key == "freq":
            items = sorted(self._freq.items(), key=lambda kv: kv[1],
                           reverse=True)
        else:  # chronological / lexicographic by token
            items = sorted(self._freq.items(), key=lambda kv: kv[0])
        for tok, _ in items:
            if tok not in self.itos[:2]:
                self.itos.append(tok)
        self.stoi = {t: i for i, t in enumerate(self.itos)}
        self._built = True

    def __len__(self):
        return len(self.itos)

    def __call__(self, tok: str) -> int:
        return self.stoi.get(tok, self.stoi["_UNK"])


@dataclass
class TemporalKG:
    """Temporal KG with a device CSR over all (h, r, t, tau) quadruples."""

    n_ent: int
    n_rel: int          # relation vocab size (incl. specials/idd for vocab dirs)
    n_time: int
    idd_rel: int        # self-loop relation id
    graph_quads: np.ndarray      # (N, 4) incl. self-loop rows
    n_facts: int                 # rows before self-loops (= train quads)
    row_to_slot: np.ndarray      # original row -> CSR slot (for leave-one-out)
    device: torch.device = torch.device("cpu")
    graph: DeviceGraph = None    # CSR: rowptr/rel/tail
    etime: torch.Tensor = None   # (n_edges,) time id per CSR slot
    graph_np: tuple = None
    splits: Dict[str, np.ndarray] = field(default_factory=dict)
    entity_vocab: Optional[Vocab] = None
    relation_vocab: Optional[Vocab] = None
    time_vocab: Optional[Vocab] = None

    # ------------------------------------------------------------------
    @classmethod
    def load_vocab_dir(cls, data_dir: str, device="cuda") -> "TemporalKG":
        """Name-based TSV dirs (`icews14_aug` style): vocab from train.txt
        (`graph.py:14-32`), graph = train quads + idd self-loops."""

        def read_lines(fname):
            with open(os.path.join(data_dir, fname)) as f:
                return [ln.split("\t") for ln in f.read().lower().splitlines()
                        if ln.strip()]

        train_rows = read_lines("train.txt")
        heads = [r[0] for r in train_rows]
        rels = [r[1] for r in train_rows]
        tails = [r[2] for r in train_rows]
        times = [r[3] for r in train_rows]

        ent_v, rel_v, time_v = Vocab(), Vocab(), Vocab()
        ent_v.update(heads + tails)
        rel_v.update(rels + ["idd"])
        dummy_time = "2020-01-01" if "wiki" not in data_dir else "2050"
        time_v.update(times + [dummy_time])
        ent_v.build()
        rel_v.build()
        time_v.build(sort_key="time")

        def encode(rows):
            return np.array(
                [[ent_v(r[0]), rel_v(r[1]), ent_v(r[2]), time_v(r[3])]
                 for r in rows], dtype=np.int64).reshape(-1, 4)

        train = encode(train_rows)
        uniq_ents = sorted({ent_v(e) for e in heads + tails})
        idd_rel = rel_v("idd")
        loops = np.stack([
            np.array(uniq_ents),
            np.full(len(uniq_ents), idd_rel),
            np.array(uniq_ents),
            np.full(len(uniq_ents), time_v(dummy_time)),
        ], 1)
        graph_quads = np.concatenate([train, loops], 0)

        kg = cls(
            n_ent=len(ent_v), n_rel=len(rel_v), n_time=len(time_v),
            idd_rel=idd_rel, graph_quads=graph_quads, n_facts=len(train),
            row_to_slot=None, device=resolve_device(device),
            entity_vocab=ent_v, relation_vocab=rel_v, time_vocab=time_v,
        )
        kg.splits = {
            "train": train,
            "valid": encode(read_lines("valid.txt")),
            "test": encode(read_lines("test.txt")),
        }
        kg._build_csr()
        return kg

    # ------------------------------------------------------------------
    @classmethod
    def load_id_dir(cls, data_dir: str, add_inverse: bool = True,
                    self_loops: bool = True,
                    time_granularity: int = 1,
                    graph_from_all_splits: bool = False,
                    warm_start_time: int = 0,
                    device="cuda") -> "TemporalKG":
        """Id-based dirs (`ICEWS14_TeMP`, `*_forecasting`): quadruples with
        numeric ids, 4 or 5 columns (`extrapolation/utils.py:99-121`).

        ``add_inverse`` appends reversed quadruples (r + n_rel) to the
        graph and to every split (`utils.py:30-49,60-96`), each split then
        sorted by time (`:99-106`). ``graph_from_all_splits`` propagates
        over train+valid+test (`utils.py:108-109`); causality comes from
        the per-query window. ``warm_start_time`` (raw units) drops the
        earliest training queries (`extrapolation/main.py:134`)."""

        def read(fname):
            rows = []
            with open(os.path.join(data_dir, fname)) as f:
                for ln in f:
                    parts = ln.split()
                    if len(parts) >= 4:
                        rows.append([int(parts[0]), int(parts[1]),
                                     int(parts[2]),
                                     int(parts[3]) // time_granularity])
            return np.array(rows, dtype=np.int64).reshape(-1, 4)

        splits = {s: read(f"{s}.txt") for s in ("train", "valid", "test")}

        def count_file(fname):
            p = os.path.join(data_dir, fname)
            if os.path.exists(p):
                with open(p) as f:
                    return sum(1 for ln in f if ln.strip())
            return 0

        n_ent = count_file("entity2id.txt") or int(
            max(s[:, [0, 2]].max() for s in splits.values() if len(s)) + 1)
        n_raw_rel = count_file("relation2id.txt") or int(
            max(s[:, 1].max() for s in splits.values() if len(s)) + 1)

        if add_inverse:
            for name, arr in splits.items():
                inv = arr[:, [2, 1, 0, 3]].copy()
                inv[:, 1] += n_raw_rel
                both = np.concatenate([arr, inv], 0)
                splits[name] = both[np.argsort(both[:, 3], kind="stable")]
            n_rel_eff = 2 * n_raw_rel
        else:
            n_rel_eff = n_raw_rel

        if graph_from_all_splits:
            graph_base = np.concatenate(
                [splits["train"], splits["valid"], splits["test"]], 0)
        else:
            graph_base = splits["train"]

        idd_rel = n_rel_eff
        parts = [graph_base]
        if self_loops:
            ents = np.arange(n_ent)
            dummy_t = int(max(s[:, 3].max() for s in splits.values()
                              if len(s)) + 1)
            parts.append(np.stack([
                ents, np.full(n_ent, idd_rel), ents,
                np.full(n_ent, dummy_t)], 1))
        graph_quads = np.concatenate(parts, 0)

        if warm_start_time:
            ws = warm_start_time // time_granularity
            tr = splits["train"]
            splits["train"] = tr[tr[:, 3] >= ws]

        # seen/unseen-entity eval splits (`extrapolation/utils.py:52-96`):
        # a quadruple is "seen" iff head, tail and relation all occur in
        # the training data
        seen_e = set(splits["train"][:, 0]) | set(splits["train"][:, 2])
        seen_r = set(splits["train"][:, 1])
        for name in ("valid", "test"):
            arr = splits[name]
            if not len(arr):
                continue
            mask = np.array([
                (h in seen_e) and (t in seen_e) and (r in seen_r)
                for h, r, t, _ in arr])
            splits[f"{name}_seen"] = arr[mask]
            splits[f"{name}_unseen"] = arr[~mask]

        # n_time covers every split's timestamps, not just the graph rows
        # (eval query times past a train-only graph's horizon would
        # otherwise index past time-sized tables)
        max_t = max(int(s[:, 3].max()) for s in splits.values() if len(s))
        max_t = max(max_t, int(graph_quads[:, 3].max()))
        kg = cls(
            n_ent=n_ent, n_rel=idd_rel + 1,
            n_time=max_t + 1,
            idd_rel=idd_rel, graph_quads=graph_quads,
            n_facts=len(graph_base), row_to_slot=None,
            device=resolve_device(device),
        )
        kg.splits = splits
        kg._build_csr()
        return kg

    # ------------------------------------------------------------------
    def _build_csr(self):
        """CSR sorted by (head, time).

        Time-sorting each row makes any per-query time window a contiguous
        slice of the row, found with two binary searches on the composite
        key head*(n_time+2)+time, or with two reads of the (entity, time)
        offset table ``time_rowptr``. Self-loop rows sit past every real
        timestamp, so windows exclude them; the windowed expansion re-adds
        them as an extra slot. The tail-sorted table serves dense hops:
        per-tail aggregation ranges are static (``tail_rowptr``)."""
        q = self.graph_quads
        order = np.lexsort((q[:, 3], q[:, 0]))  # by head, then time
        self.row_to_slot = np.empty(len(q), dtype=np.int32)
        self.row_to_slot[order] = np.arange(len(q), dtype=np.int32)
        sorted_q = q[order]
        counts = np.bincount(q[:, 0], minlength=self.n_ent)
        rowptr = np.zeros(self.n_ent + 1, dtype=np.int32)
        np.cumsum(counts, out=rowptr[1:])
        rel = sorted_q[:, 1].astype(np.int32)
        tail = sorted_q[:, 2].astype(np.int32)
        time = sorted_q[:, 3].astype(np.int32)

        self.time_key_base = int(sorted_q[:, 3].max()) + 2
        assert self.n_ent * self.time_key_base < 2**31, (
            "composite (head, time) key overflows int32")
        ekey = (sorted_q[:, 0] * self.time_key_base + sorted_q[:, 3]).astype(
            np.int32)

        # CSR slot of each entity's self-loop row (idd relation)
        selfloop_slot = np.zeros(self.n_ent, dtype=np.int32)
        loop_rows = np.nonzero(rel == self.idd_rel)[0]
        selfloop_slot[tail[loop_rows]] = loop_rows

        self.graph_np = (rowptr, rel, tail)
        self.etime_np = time
        self.ekey_np = ekey
        self.selfloop_slot_np = selfloop_slot

        # (n_ent, key_base+1): time_rowptr[e, t] = first CSR slot of
        # entity e with edge time >= t
        t_grid = np.arange(self.time_key_base + 1, dtype=np.int64)
        queries = (np.arange(self.n_ent, dtype=np.int64)[:, None]
                   * self.time_key_base + t_grid[None, :])
        self.time_rowptr_np = np.searchsorted(
            ekey, queries.reshape(-1)).astype(np.int32).reshape(
                self.n_ent, self.time_key_base + 1)

        heads_csr = sorted_q[:, 0].astype(np.int32)
        t_order = np.argsort(tail, kind="stable").astype(np.int32)
        tail_counts = np.bincount(tail, minlength=self.n_ent)
        tail_rowptr = np.zeros(self.n_ent + 1, dtype=np.int32)
        np.cumsum(tail_counts, out=tail_rowptr[1:])
        # (src, rel, time, slot, tail, tail_rowptr), tail-sorted
        self.dense_np = (heads_csr[t_order], rel[t_order], time[t_order],
                         t_order, tail[t_order], tail_rowptr)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

        # the dense hop's backward sums the state's gradient by the
        # sources' order and the time term's by the time ids' order; its
        # kernels walk the tail ranges by tail_items and take the time
        # term once per time id (n_time covers every edge time)
        time_order, time_off = build_time_order(self.dense_np[2],
                                                self.n_time)
        self.graph = DeviceGraph(
            dev(rowptr), dev(rel), dev(tail),
            tsrc_order=dev(build_src_order(self.dense_np[0])),
            tail_items=tail_items(dev(tail_rowptr)), n_time=self.n_time,
            time_order=dev(time_order), time_off=dev(time_off))
        self.etime = dev(time)
        self.ekey = dev(ekey)
        self.selfloop_slot = dev(selfloop_slot)
        self.time_rowptr = dev(self.time_rowptr_np)
        self.dense = tuple(dev(a) for a in self.dense_np)

    def model_args(self) -> tuple:
        """(graph, etime, ekey, selfloop_slot, time_rowptr, dense): the
        device arrays `TRedGNN.forward` takes besides the batch."""
        return (self.graph, self.etime, self.ekey, self.selfloop_slot,
                self.time_rowptr, self.dense)

    def exclusion_slots(self, example_rows: np.ndarray) -> np.ndarray:
        """CSR slots of the given original graph rows (leave-one-out)."""
        return self.row_to_slot[example_rows]

    def negative_sampling_objects(self, q: int, split: str = "train",
                                  start_time: int = 0,
                                  rng: Optional[np.random.Generator] = None
                                  ) -> np.ndarray:
        """Q corrupted objects per quadruple with time >= start_time,
        rejecting true (s, p, t) answers (`extrapolation/utils.py:123-159`;
        vectorized rejection instead of the per-event while loop)."""
        rng = rng or np.random.default_rng(0)
        data = self.splits[split]
        data = data[data[:, 3] >= start_time]
        spt_o: Dict[tuple, set] = {}
        for s, p, o, t in data:
            spt_o.setdefault((s, p, t), set()).add(o)
        out = np.empty((len(data), q), dtype=np.int64)
        for i, (s, p, o, t) in enumerate(data):
            true = spt_o[(s, p, t)]
            # vectorized rejection: draw 2q+8, keep the first q survivors
            row = []
            while len(row) < q:
                cand = rng.integers(0, self.n_ent, 2 * q + 8)
                row.extend(int(c) for c in cand if c not in true)
            out[i] = row[:q]
        return out

    def neighbor_subgraph(self, src: int, cut_time: int, level: int = 2,
                          num_neighbors: int = 20,
                          rng: Optional[np.random.Generator] = None
                          ) -> Tuple[List[tuple], List[tuple]]:
        """Recursive temporal neighborhood around (src, cut_time)
        (`extrapolation/utils.py:501-531`, sans the networkx dependency):
        per level, up to ``num_neighbors`` uniformly sampled historical
        edges (t' < node cut time) per frontier node.

        Returns (nodes, edges): nodes are (entity, rel_in, time) keys,
        edges are (parent_key, child_key) pairs."""
        rng = rng or np.random.default_rng(0)
        rowptr, rel_a, tail_a = self.graph_np
        time_a = self.etime_np
        root = (int(src), None, int(cut_time))
        nodes, edges = {root: True}, []
        frontier = [root]
        for _ in range(level):
            nxt = []
            for key in frontier:
                ent, _, t = key
                sl = slice(rowptr[ent], rowptr[ent + 1])
                cand = np.nonzero(time_a[sl] < t)[0] + rowptr[ent]
                if len(cand) > num_neighbors:
                    cand = rng.choice(cand, num_neighbors, replace=False)
                for s in cand:
                    child = (int(tail_a[s]), int(rel_a[s]),
                             int(time_a[s]))
                    edges.append((key, child))
                    if child not in nodes:
                        nodes[child] = True
                        nxt.append(child)
            frontier = nxt
        return list(nodes), edges
