"""The port's SimplE baseline and the temporal tooling vs the JAX package on
the CPU: SimplE scores, train steps, an epoch, evaluation, `.msgpack`
restores and `--model simple` through the CLI; `augment_with_inverses`
(byte-equal files) and the two host samplers of `TemporalKG`
(`negative_sampling_objects`, `neighbor_subgraph`: equal draws for the
same seed). Tiny graphs (30 entities, hidden 16)."""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from redgnn_tpu.graph.preprocess import augment_with_inverses as j_augment
from redgnn_tpu.graph.temporal import TemporalKG as JKG
from redgnn_tpu.models.baselines import SimplE as JSimplE
from redgnn_tpu.train.simple_loop import SimplETrainer as JTrainer
from redgnn_tpu.utils.checkpoint import save_checkpoint as jsave
from redgnn_tpu_torch.cli.train import main as cli_main
from redgnn_tpu_torch.graph.preprocess import augment_with_inverses
from redgnn_tpu_torch.graph.temporal import TemporalKG
from redgnn_tpu_torch.models.baselines import SimplE
from redgnn_tpu_torch.train.simple_loop import SimplETrainer
from redgnn_tpu_torch.utils.port_params import (
    params_from_flax,
    temporal_opt_state_from_optax,
)

from test_temporal import write_temporal_dir
from test_torch_temporal import write_id_dir


@pytest.fixture
def kgs(tmp_path, rng):
    path = str(write_temporal_dir(tmp_path, rng))
    return JKG.load_vocab_dir(path), TemporalKG.load_vocab_dir(path,
                                                               device="cpu")


def trainer_pair(jkg, kg, **kw):
    """(JAX trainer, port trainer carrying its parameters and Adam
    state)."""
    jt = JTrainer(jkg, **kw)
    pt = SimplETrainer(kg, device="cpu", **kw)
    pt.load_state({
        "params": params_from_flax(jax.device_get(jt.params)),
        "opt_state": temporal_opt_state_from_optax(
            serialization.to_state_dict(jax.device_get(jt.opt_state)),
            pt.lr)})
    return jt, pt


def assert_state_close(pt, jt, atol):
    got = pt.state()
    want = temporal_opt_state_from_optax(
        serialization.to_state_dict(jax.device_get(jt.opt_state)), pt.lr)
    for k, v in params_from_flax(jax.device_get(jt.params)).items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                   rtol=0, atol=atol, err_msg=k)
    for group in ("mu", "nu"):
        for k, v in want[group].items():
            np.testing.assert_allclose(got["opt_state"][group][k].numpy(),
                                       v.numpy(), rtol=0, atol=atol,
                                       err_msg=f"{group}/{k}")
    assert int(got["opt_state"]["count"]) == int(want["count"])


def test_simple_scores_match_jax(rng):
    """Scores against every tail within 1e-5 from the same parameters."""
    heads = rng.integers(0, 30, 12).astype(np.int32)
    rels = rng.integers(0, 7, 12).astype(np.int32)
    jm = JSimplE(n_ent=30, n_rel=7, hidden_dim=16)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(heads),
                     jnp.asarray(rels))["params"]
    want = jm.apply({"params": params}, jnp.asarray(heads),
                    jnp.asarray(rels))
    model = SimplE(30, 7, 16, device="cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params)),
                          strict=True)
    with torch.no_grad():
        got = model(torch.tensor(heads), torch.tensor(rels))
    assert got.shape == (12, 30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_simple_steps_epoch_and_evaluate_match_jax(kgs):
    """Two steps from the same state (the second batch padded), then a
    whole shuffled epoch: loss, parameters and Adam state within 2e-5;
    then raw MRR / Hits@k within rtol 1e-5."""
    jkg, kg = kgs
    jt, pt = trainer_pair(jkg, kg, hidden_dim=16, batch_size=32, seed=3)
    for lo, n in ((0, 32), (32, 20)):
        rows = kg.splits["train"][lo:lo + n]
        pad = 32 - n
        cols = [np.concatenate([rows[:, j], np.zeros(pad, np.int64)])
                .astype(np.int32) for j in range(3)]
        qm = np.arange(32) < n
        jt.params, jt.opt_state, jloss = jt._train_step(
            jt.params, jt.opt_state, *(jnp.asarray(c) for c in cols),
            jnp.asarray(qm))
        loss = pt._train_step(*(torch.tensor(c) for c in cols),
                              torch.tensor(qm))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)
    assert_state_close(pt, jt, atol=2e-5)
    np.testing.assert_allclose(pt.train_epoch(0), jt.train_epoch(0),
                               rtol=2e-5)
    assert_state_close(pt, jt, atol=2e-5)
    jm, m = jt.evaluate("valid"), pt.evaluate("valid")
    assert list(m) == list(jm) and m["n"] == len(kg.splits["valid"])
    for k in jm:
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, err_msg=k)


def test_simple_restore_jax_msgpack_checkpoint(kgs, tmp_path):
    """A JAX SimplETrainer checkpoint (plain Adam: no learning rate in
    the state) restores: parameters, moments, count and the numpy rng;
    the port's own .pt reads back."""
    jkg, kg = kgs
    jt = JTrainer(jkg, hidden_dim=16, batch_size=32)
    jt.train_epoch(0)
    path = jsave(str(tmp_path / "jck"), jt.state(), 2, 0.125,
                 host=jt.host_state())
    pt = SimplETrainer(kg, hidden_dim=16, batch_size=32, device="cpu")
    assert pt.restore(path) == 2
    assert_state_close(pt, jt, atol=0)
    assert pt._np_rng.bit_generator.state == jt._np_rng.bit_generator.state
    saved = pt.save(str(tmp_path / "pck"), 3, 0.5)
    again = SimplETrainer(kg, hidden_dim=16, device="cpu")
    assert again.restore(saved) == 3
    assert torch.equal(again._flat, pt._flat)
    with pytest.raises(RuntimeError, match="does not match"):
        SimplETrainer(kg, hidden_dim=8, device="cpu").restore(path)


def test_cli_simple_cpu(tmp_path, rng, capsys):
    """--model simple on an id dir runs to BEST; the checkpoint reads back
    with --eval_only."""
    data = write_id_dir(tmp_path / "toy_forecasting", rng)
    d = str(tmp_path / "ck")
    cli_main(["--task", "extrapolation", "--model", "simple", "--data_path",
              data, "--device", "cpu", "--epochs", "2", "--ckpt_dir", d])
    lines = capsys.readouterr().out.strip().splitlines()
    assert sum(ln.startswith("simple epoch") for ln in lines) == 2
    assert lines[-1].startswith("BEST ")
    best = json.loads(lines[-1][len("BEST "):])
    assert 0.0 <= best["valid_mrr"] <= 1.0 and "test_mrr" in best
    cli_main(["--task", "extrapolation", "--model", "simple", "--data_path",
              data, "--device", "cpu", "--eval_only", "--load_checkpoint",
              str(tmp_path / "ck" / "latest.pt")])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= metrics["test"]["mrr"] <= 1.0


# --------------------------------------------------- the temporal tooling

@pytest.mark.parametrize("wikidata", [False, True])
def test_augment_with_inverses_byte_equal(tmp_path, rng, wikidata):
    src = tmp_path / "src"
    src.mkdir()
    if wikidata:
        (src / "train.txt").write_text(
            "E1\tP26\tE2\toccursSince\t2001\n"
            "E3\tP39\tE4\toccursUntil\t1999\n\n")
        files = ("train.txt", "valid.txt")
    else:
        write_temporal_dir(src, rng)
        files = ("train.txt", "valid.txt", "test.txt")
    j_augment(str(src), str(tmp_path / "jax"), files=files,
              wikidata_format=wikidata)
    augment_with_inverses(str(src), str(tmp_path / "port"), files=files,
                          wikidata_format=wikidata)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == (["train.txt"] if wikidata else sorted(files))
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


def test_temporal_samplers_match_jax(kgs):
    """The same seed gives the same corrupted objects and the same
    neighborhood (nodes in order, edges in order)."""
    jkg, kg = kgs
    for start in (0, 5):
        want = jkg.negative_sampling_objects(
            4, "train", start_time=start, rng=np.random.default_rng(7))
        got = kg.negative_sampling_objects(
            4, "train", start_time=start, rng=np.random.default_rng(7))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(kg.negative_sampling_objects(3, "valid"),
                                  jkg.negative_sampling_objects(3, "valid"))
    for src, t, level, k in ((3, 15, 2, 3), (0, 19, 3, 20), (5, 1, 2, 5)):
        want = jkg.neighbor_subgraph(src, t, level=level, num_neighbors=k,
                                     rng=np.random.default_rng(2))
        got = kg.neighbor_subgraph(src, t, level=level, num_neighbors=k,
                                   rng=np.random.default_rng(2))
        assert got == want
    assert len(kg.neighbor_subgraph(3, 15)[1]) > 0
