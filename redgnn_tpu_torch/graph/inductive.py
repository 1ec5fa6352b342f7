"""Inductive KGC: disjoint train/test graphs with shared relations.

Port of ``redgnn_tpu/graph/inductive.py``; capability parity with
`Static/inductive/load_data.py`:
  * two entity vocabularies (`DIR/entities.txt` and
    `DIR_ind/entities.txt`), relations shared; vocab files are
    ``name\\tid`` pairs;
  * all split triple lists are doubled with inverses at read;
  * graphs: transductive graph from `DIR/train.txt`, inductive graph from
    `DIR_ind/train.txt`, both + self-loops;
  * the training-query quirk: training queries are the *transductive
    valid* set, validation queries the transductive test set, and test
    queries the inductive valid+test sets evaluated on the inductive
    graph with its own entity count;
  * per-epoch shuffling permutes query order only — the graph is fixed,
    unlike the transductive re-split;
  * filters are built separately per side.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from redgnn_tpu_torch.graph.kg import (
    DeviceGraph,
    EvalSpec,
    _add_self_loops,
    _read_vocab,
    build_csr,
    filters_of,
    group_queries,
)


def _read_doubled(path: str, e2id: Dict[str, int], r2id: Dict[str, int],
                  n_rel: int) -> np.ndarray:
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            h, r, t = line.split()
            h, r, t = e2id[h], r2id[r], e2id[t]
            out.append((h, r, t))
            out.append((t, r + n_rel, h))
    return np.array(out, dtype=np.int64).reshape(-1, 3)


@dataclass
class InductiveKG:
    n_ent: int        # transductive (train-side) entity count
    n_ent_ind: int
    n_rel: int
    train_data: np.ndarray  # training queries = doubled transductive valid
    graph: DeviceGraph      # transductive propagation graph — train.txt
                            # edges only (valid triples are the training
                            # QUERIES, not edges)
    graph_np: tuple
    ind_graph: DeviceGraph
    ind_graph_np: tuple
    valid_spec_data: tuple = field(repr=False, default=None)
    test_spec_data: tuple = field(repr=False, default=None)
    entity2id: Dict[str, int] = field(default_factory=dict)
    entity2id_ind: Dict[str, int] = field(default_factory=dict)
    relation2id: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def load(cls, data_dir: str, device="cuda") -> "InductiveKG":
        """Read ``data_dir`` and ``data_dir + "_ind"`` and place both
        graphs on ``device``."""
        ind_dir = data_dir.rstrip("/") + "_ind"
        e2id = _read_vocab(os.path.join(data_dir, "entities.txt"))
        r2id = _read_vocab(os.path.join(data_dir, "relations.txt"))
        e2id_ind = _read_vocab(os.path.join(ind_dir, "entities.txt"))
        n_rel = len(r2id)

        def rd(d, f, ind=False):
            return _read_doubled(os.path.join(d, f),
                                 e2id_ind if ind else e2id, r2id, n_rel)

        tra_train = rd(data_dir, "train.txt")
        tra_valid = rd(data_dir, "valid.txt")
        tra_test = rd(data_dir, "test.txt")
        ind_train = rd(ind_dir, "train.txt", ind=True)
        ind_valid = rd(ind_dir, "valid.txt", ind=True)
        ind_test = rd(ind_dir, "test.txt", ind=True)

        n_ent, n_ent_ind = len(e2id), len(e2id_ind)
        idd = 2 * n_rel

        tra_np = build_csr(_add_self_loops(tra_train, n_ent, idd), n_ent)
        ind_np = build_csr(_add_self_loops(ind_train, n_ent_ind, idd),
                           n_ent_ind)

        kg = cls(
            n_ent=n_ent, n_ent_ind=n_ent_ind, n_rel=n_rel,
            train_data=tra_valid.copy(),
            graph=DeviceGraph.from_csr(*tra_np, n_ent, device=device),
            graph_np=tra_np,
            ind_graph=DeviceGraph.from_csr(*ind_np, n_ent_ind,
                                           device=device),
            ind_graph_np=ind_np,
            entity2id=e2id, entity2id_ind=e2id_ind, relation2id=r2id,
        )
        # valid: transductive-test queries on the transductive graph
        vq, va = group_queries(tra_test)
        kg.valid_spec_data = (vq, va, filters_of(tra_train, tra_valid,
                                                  tra_test))
        # test: inductive valid+test queries on the inductive graph
        tq, ta = group_queries(np.concatenate([ind_valid, ind_test], 0))
        kg.test_spec_data = (tq, ta, filters_of(ind_train, ind_valid,
                                                 ind_test))
        return kg

    def eval_spec(self, split: str) -> EvalSpec:
        if split == "valid":
            q, a, filt = self.valid_spec_data
            return EvalSpec(q, a, self.graph, self.graph_np, self.n_ent, filt)
        q, a, filt = self.test_spec_data
        return EvalSpec(q, a, self.ind_graph, self.ind_graph_np,
                        self.n_ent_ind, filt)

    def resplit(self, rng: np.random.Generator) -> None:
        """Permute training-query order; the graph is fixed."""
        self.train_data = self.train_data[rng.permutation(len(self.train_data))]
