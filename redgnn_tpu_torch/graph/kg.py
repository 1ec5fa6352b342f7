"""Static knowledge graphs: vocab, splits, filters, device-resident CSR.

Port of ``redgnn_tpu/graph/kg.py`` (static transductive part). The host
side (vocab, inverse relations ``r + n_rel``, the self-loop relation
``2 * n_rel``, ``(h, r) -> {t}`` filters, grouped eval queries) is the
same numpy code; the device side is a head-sorted CSR of int32 torch
tensors on the chosen device.
"""

from __future__ import annotations

import os
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from redgnn_tpu_torch.ops.dense_hop import tail_items as tail_items_of
from redgnn_tpu_torch.utils.device import resolve_device


def build_csr(
    triples: np.ndarray, n_ent: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Head-sorted CSR from an (N, 3) int array of (head, rel, tail)."""
    heads = triples[:, 0]
    order = np.argsort(heads, kind="stable")
    sorted_t = triples[order]
    counts = np.bincount(heads, minlength=n_ent)
    rowptr = np.zeros(n_ent + 1, dtype=np.int32)
    np.cumsum(counts, out=rowptr[1:])
    return (
        rowptr,
        sorted_t[:, 1].astype(np.int32),
        sorted_t[:, 2].astype(np.int32),
    )


def build_tail_sorted(rowptr: np.ndarray, rel: np.ndarray,
                      tail: np.ndarray, n_ent: int):
    """Tail-sorted view of a CSR for dense-mode hops: (src, rel, tail,
    tail_rowptr) with static per-tail aggregation ranges."""
    heads = np.repeat(np.arange(n_ent, dtype=np.int32),
                      np.diff(rowptr))
    order = np.argsort(tail, kind="stable").astype(np.int32)
    counts = np.bincount(tail, minlength=n_ent)
    tail_rowptr = np.zeros(n_ent + 1, dtype=np.int32)
    np.cumsum(counts, out=tail_rowptr[1:])
    return heads[order], rel[order], tail[order], tail_rowptr


def build_src_order(tsrc: np.ndarray) -> np.ndarray:
    """The stable order of a tail-sorted table's sources, int32: the
    edges of source v, in table order, at ``rowptr[v]:rowptr[v + 1]`` of
    it (``tsrc`` is a permutation of the CSR's heads, so the CSR's own
    ``rowptr`` gives the rows). The list the dense hop's gather backward
    sums by (`ops.gather.gather_rows_listed`)."""
    return np.argsort(tsrc, kind="stable").astype(np.int32)


class DeviceGraph:
    """Device-resident CSR fact graph (+ self-loops), int32 tensors.

    ``tsrc/trel/ttail/tail_rowptr`` (optional) are the tail-sorted view
    of dense-mode hops; graphs built without them disable dense mode.
    ``tsrc_order`` (optional) is `build_src_order` of ``tsrc``: a dense
    hop's gather backward on a CUDA device needs it.

    ``tail_items`` is the dense hop kernels' (`ops.dense_hop`) work plan
    of the tail ranges (`ops.dense_hop.tail_items`), built here whenever
    ``tail_rowptr`` is given (a temporal graph, whose tail-sorted table
    lives beside it, passes its own). ``n_time`` (a temporal table's) is
    the count of time ids, past every edge time, whose time term a dense
    hop computes once each."""

    FIELDS = ("rowptr", "rel", "tail", "tsrc", "trel", "ttail",
              "tail_rowptr", "tsrc_order")

    def __init__(self, rowptr, rel, tail, tsrc=None, trel=None, ttail=None,
                 tail_rowptr=None, tsrc_order=None, tail_items=None,
                 n_time: int | None = None):
        self.rowptr = rowptr
        self.rel = rel
        self.tail = tail
        self.tsrc = tsrc
        self.trel = trel
        self.ttail = ttail
        self.tail_rowptr = tail_rowptr
        self.tsrc_order = tsrc_order
        if tail_items is None and tail_rowptr is not None:
            tail_items = tail_items_of(tail_rowptr)
        self.tail_items = tail_items
        self.n_time = n_time

    @property
    def n_edges(self) -> int:
        return self.rel.shape[0]

    @property
    def n_ent(self) -> int:
        return self.rowptr.shape[0] - 1

    @property
    def has_dense(self) -> bool:
        return self.tsrc is not None

    @property
    def device(self) -> torch.device:
        return self.rowptr.device

    def to(self, device) -> "DeviceGraph":
        return DeviceGraph(*(None if getattr(self, f) is None
                             else getattr(self, f).to(device)
                             for f in self.FIELDS + ("tail_items",)),
                           n_time=self.n_time)

    @classmethod
    def from_csr(cls, rowptr, rel, tail, n_ent: int,
                 device="cuda") -> "DeviceGraph":
        dev = resolve_device(device)
        dense = build_tail_sorted(rowptr, rel, tail, n_ent)
        return cls(*(torch.as_tensor(np.asarray(a, np.int32), device=dev)
                     for a in (rowptr, rel, tail, *dense,
                               build_src_order(dense[0]))))

    @classmethod
    def from_triples(cls, triples: np.ndarray, n_ent: int,
                     device="cuda") -> "DeviceGraph":
        return cls.from_csr(*build_csr(triples, n_ent), n_ent, device=device)


def _add_self_loops(triples: np.ndarray, n_ent: int, idd_rel: int) -> np.ndarray:
    ents = np.arange(n_ent, dtype=np.int64)
    idd = np.stack([ents, np.full(n_ent, idd_rel, dtype=np.int64), ents], 1)
    if len(triples) == 0:
        return idd
    return np.concatenate([triples, idd], 0)


def _double(triples: np.ndarray, n_rel: int) -> np.ndarray:
    """Append inverse edges (t, r + n_rel, h) — `load_data.py:69-74`."""
    if len(triples) == 0:
        return triples.reshape(0, 3)
    inv = np.stack(
        [triples[:, 2], triples[:, 1] + n_rel, triples[:, 0]], 1
    )
    return np.concatenate([triples, inv], 0)


def _read_vocab(path: str) -> Dict[str, int]:
    """Name->id map from either format the reference ships: bare names
    (id = position among non-blank lines) or explicit `name\\tid` pairs.
    Ids must come out dense in [0, len)."""
    vocab: Dict[str, int] = {}
    next_id = 0  # counts accepted entries, not raw lines (blank-safe)
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            parts = line.split("\t")
            if len(parts) == 2 and parts[1].strip().isdigit():
                name, idx = parts[0], int(parts[1])
            else:
                name, idx = line.strip(), next_id
            if name in vocab:
                raise ValueError(f"{path}: duplicate vocab entry {name!r}")
            vocab[name] = idx
            next_id += 1
    ids = sorted(vocab.values())
    if ids != list(range(len(vocab))):
        raise ValueError(
            f"{path}: vocab ids are not a dense [0, {len(vocab)}) range "
            "(duplicate or gapped ids would corrupt CSR/key arithmetic)")
    return vocab


def group_queries(
    doubled_triples: np.ndarray,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(h, r)-grouped eval queries with sorted-unique multi-answers —
    the reference's grouped evaluation protocol (`load_data.py:91-104`)."""
    groups: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for h, r, t in doubled_triples:
        groups[(int(h), int(r))].append(int(t))
    keys = sorted(groups.keys())
    queries = np.array(keys, dtype=np.int64).reshape(-1, 2)
    answers = [np.array(sorted(set(groups[k]))) for k in keys]
    return queries, answers


def filters_of(
    *triple_sets: np.ndarray,
) -> Dict[Tuple[int, int], np.ndarray]:
    """(h, r) -> sorted known-true tails over the given (already-doubled)
    triple sets, for filtered ranking (`load_data.py:170-192`)."""
    filt: Dict[Tuple[int, int], set] = defaultdict(set)
    for triples in triple_sets:
        for h, r, t in triples:
            filt[(int(h), int(r))].add(int(t))
    return {k: np.array(sorted(v)) for k, v in filt.items()}


@dataclass
class EvalSpec:
    """What evaluating or serving one split needs: the graph to propagate
    over, its entity count, grouped queries and filtered-ranking sets."""

    queries: np.ndarray            # (Q, 2) grouped (h, r)
    answers: List[np.ndarray]      # per-query answer entity ids
    graph: DeviceGraph
    graph_np: Tuple[np.ndarray, np.ndarray, np.ndarray]
    n_ent: int
    filters: Dict[Tuple[int, int], np.ndarray]

    def filter_row(self, h: int, r: int) -> np.ndarray:
        return self.filters.get((int(h), int(r)), np.empty(0, dtype=np.int64))


@dataclass
class StaticKG:
    """Host-side container for a static transductive KG with splits."""

    n_ent: int
    n_rel: int
    fact: np.ndarray   # (F, 3) original direction only
    train: np.ndarray  # (T, 3) original direction only
    valid: np.ndarray
    test: np.ndarray
    filters: Dict[Tuple[int, int], np.ndarray] = field(default_factory=dict)
    entity2id: Dict[str, int] = field(default_factory=dict)
    relation2id: Dict[str, int] = field(default_factory=dict)
    device: torch.device = torch.device("cpu")

    train_data: np.ndarray | None = None  # doubled training queries
    graph_np: Tuple[np.ndarray, np.ndarray, np.ndarray] | None = None
    graph: DeviceGraph | None = None
    eval_graph_np: Tuple[np.ndarray, np.ndarray, np.ndarray] | None = None
    eval_graph: DeviceGraph | None = None

    @property
    def idd_rel(self) -> int:
        return 2 * self.n_rel

    @classmethod
    def load(cls, data_dir: str, device="cuda") -> "StaticKG":
        """Read a KG in the reference's file format (`entities.txt`,
        `relations.txt`, `facts.txt`, `train.txt`, `valid.txt`,
        `test.txt`) and place its graphs on ``device``."""
        dev = resolve_device(device)
        entity2id = _read_vocab(os.path.join(data_dir, "entities.txt"))
        relation2id = _read_vocab(os.path.join(data_dir, "relations.txt"))
        n_ent, n_rel = len(entity2id), len(relation2id)

        filters: Dict[Tuple[int, int], set] = defaultdict(set)

        def read(fname: str) -> np.ndarray:
            out = []
            with open(os.path.join(data_dir, fname)) as f:
                for line in f:
                    if not line.strip():
                        continue
                    h, r, t = line.split()
                    h, r, t = entity2id[h], relation2id[r], entity2id[t]
                    out.append((h, r, t))
                    filters[(h, r)].add(t)
                    filters[(t, r + n_rel)].add(h)
            return np.array(out, dtype=np.int64).reshape(-1, 3)

        if os.path.exists(os.path.join(data_dir, "facts.txt")):
            fact, train = read("facts.txt"), read("train.txt")
        else:
            # train/valid/test only (YAGO, nell): draw the initial 3:1
            # fact/train split from train.txt, seeded, as the JAX package
            pool = read("train.txt")
            perm = np.random.default_rng(1234).permutation(len(pool))
            cut = len(pool) * 3 // 4
            fact, train = pool[perm[:cut]], pool[perm[cut:]]
        kg = cls(
            n_ent=n_ent,
            n_rel=n_rel,
            fact=fact,
            train=train,
            valid=read("valid.txt"),
            test=read("test.txt"),
            entity2id=entity2id,
            relation2id=relation2id,
            device=dev,
        )
        kg.filters = {k: np.array(sorted(v)) for k, v in filters.items()}

        # Evaluation graph = facts + train, doubled, + self-loops; built once
        # and never re-split (`load_data.py:84-89`).
        eval_triples = _add_self_loops(
            _double(np.concatenate([kg.fact, kg.train], 0), n_rel),
            n_ent,
            kg.idd_rel,
        )
        kg.eval_graph_np = build_csr(eval_triples, n_ent)
        kg.eval_graph = DeviceGraph.from_csr(*kg.eval_graph_np, n_ent,
                                             device=dev)

        # Initial split: facts as graph, train as queries (`load_data.py:37-43`).
        kg._set_graph(kg.fact, kg.train)
        return kg

    def _set_graph(self, graph_triples: np.ndarray, query_triples: np.ndarray):
        self.train_data = _double(query_triples, self.n_rel)
        g = _add_self_loops(
            _double(graph_triples, self.n_rel), self.n_ent, self.idd_rel
        )
        self.graph_np = build_csr(g, self.n_ent)
        self.graph = DeviceGraph.from_csr(*self.graph_np, self.n_ent,
                                          device=self.device)

    def resplit(self, rng: np.random.Generator) -> None:
        """Per-epoch random 3:1 facts/train re-split
        (`load_data.py:152-164`); the new graph goes to the KG's device.
        Shapes stay constant (the cut depends on the pool size only)."""
        pool = np.concatenate([self.fact, self.train], 0)
        perm = rng.permutation(len(pool))
        pool = pool[perm]
        cut = len(pool) * 3 // 4
        self._set_graph(pool[:cut], pool[cut:])

    def filter_row(self, h: int, r: int) -> np.ndarray:
        """Known-true tails for (h, r) across all splits (for filtered MRR)."""
        return self.filters.get((h, r), np.empty(0, dtype=np.int64))

    def eval_queries(
        self, split: str
    ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """Evaluation queries grouped by (h, r) — `load_data.py:91-104`."""
        triples = {"valid": self.valid, "test": self.test}[split]
        return group_queries(_double(triples, self.n_rel))

    def eval_spec(self, split: str) -> EvalSpec:
        """Evaluation happens on the facts+train graph (`load_data.py:110-112`)."""
        queries, answers = self.eval_queries(split)
        return EvalSpec(
            queries=queries, answers=answers, graph=self.eval_graph,
            graph_np=self.eval_graph_np, n_ent=self.n_ent,
            filters=self.filters,
        )
