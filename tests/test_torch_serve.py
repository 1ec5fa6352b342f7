"""Port's Predictor vs the JAX Predictor on the same tiny KG, with the JAX
StaticTrainer's parameters carried over, under the slice's overrides
(segment_impl='pallas', dense_hops=False)."""

import numpy as np
import jax
import pytest

from redgnn_tpu.graph.kg import StaticKG as JKG
from redgnn_tpu.serve import Predictor as JPredictor
from redgnn_tpu.train.loop import StaticTrainer
from redgnn_tpu.utils.config import TrainConfig as JConfig
from redgnn_tpu_torch.graph.calibrate import FrontierCaps
from redgnn_tpu_torch.graph.kg import StaticKG
from redgnn_tpu_torch.models.redgnn import ModelConfig, RedGNN
from redgnn_tpu_torch.serve import Predictor
from redgnn_tpu_torch.utils.config import TrainConfig
from redgnn_tpu_torch.utils.port_params import params_from_flax

from test_train_loop import write_kg

SETTINGS = dict(hidden_dim=16, attn_dim=5, n_layer=3, dropout=0.0,
                n_batch=4, n_tbatch=4, segment_impl="pallas",
                dense_hops=False)


def assert_topk_agree(s_a, e_a, s_b, e_b, tol=1e-5):
    """Scores within ``tol``; entities equal at every rank whose score is
    not tied (within ``tol``) with a neighbouring rank."""
    np.testing.assert_allclose(s_a, s_b, atol=tol)
    gap = np.diff(s_b, axis=1) < -tol   # strict drop between ranks j, j+1
    untied = np.ones_like(s_b, dtype=bool)
    untied[:, 1:] &= gap
    untied[:, :-1] &= gap
    # the last rank may tie with the first rank past k; leave it out
    untied[:, -1] = False
    np.testing.assert_array_equal(e_a[untied], e_b[untied])
    return untied.sum()


@pytest.fixture
def served(tmp_path, rng):
    d = str(write_kg(tmp_path, rng))
    trainer = StaticTrainer(JKG.load(d), JConfig(**SETTINGS))
    kg = StaticKG.load(d, device="cpu")
    cfg = TrainConfig(**SETTINGS)
    model = RedGNN(ModelConfig(
        n_ent=kg.n_ent, n_rel=kg.n_rel, hidden_dim=cfg.hidden_dim,
        attn_dim=cfg.attn_dim, n_layer=cfg.n_layer,
        segment_impl=cfg.segment_impl, dedup_impl=cfg.dedup_impl,
        dense_hops=cfg.dense_hops), device="cpu")
    pred = Predictor(model, params_from_flax(jax.device_get(trainer.params)),
                     kg, cfg, split="test", top_k=5)
    return trainer, kg, pred


def test_predictor_matches_jax(served):
    trainer, kg, pred = served
    jpred = JPredictor(trainer, split="test", top_k=5)
    assert (pred.caps.node_caps, pred.caps.edge_caps) == \
        (jpred.caps.node_caps, jpred.caps.edge_caps)
    queries = kg.eval_spec("test").queries
    if len(queries) % pred.batch == 0:
        queries = queries[:-1]  # so that the last batch is padded
    heads, rels = queries[:, 0], queries[:, 1]
    s, e = pred.predict(heads, rels)
    js, je = jpred.predict(heads, rels)
    assert s.shape == e.shape == (len(heads), 5)
    assert np.all(np.diff(s, axis=1) <= 0)
    assert assert_topk_agree(s, e, np.asarray(js), np.asarray(je)) > 0


def test_predictor_overflow_raises(served):
    _, kg, pred = served
    pred.caps = FrontierCaps((pred.batch, 8, 8, 8), (8, 8, 8))
    q = kg.eval_spec("test").queries
    with pytest.raises(RuntimeError, match="capacity overflow"):
        pred.predict(q[:, 0], q[:, 1])
