"""The port's temporal trainer vs the JAX package on the CPU: loss, staged
filters, the optimizer chains (AdamW; coupled Adam with accumulation and
clipping; the live learning rate), train steps from carried-over
parameters and optimizer state, step rejection, exact caps and the chunk
replay, evaluation in both modes, host state and checkpoints (the port's
and the JAX package's msgpack), Predictor and the CLI. Tiny graphs (30
entities, hidden 8, 2-3 layers); dropout 0 wherever the packages are
compared (their RNG streams differ)."""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import serialization

from redgnn_tpu.graph.temporal import TemporalKG as JKG
from redgnn_tpu.serve import Predictor as JPredictor
from redgnn_tpu.train import temporal_loop as jloop
from redgnn_tpu.utils.checkpoint import save_checkpoint as jsave
from redgnn_tpu.utils.config import TemporalTrainConfig as JConfig
from redgnn_tpu_torch.cli.train import main as cli_main
from redgnn_tpu_torch.graph.calibrate import FrontierCaps
from redgnn_tpu_torch.graph.temporal import TemporalKG
from redgnn_tpu_torch.models.temporal import temporal_hop_plan
from redgnn_tpu_torch.serve import Predictor
from redgnn_tpu_torch.train import temporal_loop as tloop
from redgnn_tpu_torch.utils.config import TemporalTrainConfig
from redgnn_tpu_torch.utils.port_params import (
    params_from_flax,
    temporal_opt_state_from_optax,
)

from test_temporal import write_temporal_dir
from test_torch_temporal import write_id_dir

INTERP = dict(hidden_dim=8, attn_dim=6, n_layer=2, dropout=0.0, lr=5e-3,
              batch_size=8, eval_batch_size=8, dense_switch=0.4,
              scan_src_backward=False, scan_chunk=3)
EXTRAP = dict(hidden_dim=8, attn_dim=6, n_layer=2, dropout=0.0, lr=1e-3,
              batch_size=8, eval_batch_size=8, mode="extrapolation",
              window=6, optimizer="adam", weight_decay=1e-3,
              scan_src_backward=False, scan_chunk=3)


@pytest.fixture
def vocab_dir(tmp_path, rng):
    return str(write_temporal_dir(tmp_path, rng))


@pytest.fixture
def id_dir(tmp_path, rng):
    return write_id_dir(tmp_path / "toy_forecasting", rng)


def load_pair(path, settings):
    """(JAX KG, port KG) of the setting's loader: vocab dirs for
    interpolation, the forecasting protocol for extrapolation."""
    if settings.get("mode") == "extrapolation":
        kw = dict(time_granularity=24, graph_from_all_splits=True,
                  warm_start_time=48)
        return (JKG.load_id_dir(path, **kw),
                TemporalKG.load_id_dir(path, device="cpu", **kw))
    return JKG.load_vocab_dir(path), TemporalKG.load_vocab_dir(path,
                                                               device="cpu")


def make_pair(path, **settings):
    """(JAX trainer, port trainer) on the same files and settings, the
    port continuing from the JAX trainer's parameters and optimizer
    state."""
    jkg, kg = load_pair(path, settings)
    jt = jloop.TemporalTrainer(jkg, JConfig(**settings))
    pt = tloop.TemporalTrainer(kg, TemporalTrainConfig(**settings))
    carry(jt.params, jt.opt_state, pt)
    return jt, pt


def carry(params, opt_state, pt):
    pt.load_state({
        "params": params_from_flax(jax.device_get(params)),
        "opt_state": temporal_opt_state_from_optax(
            serialization.to_state_dict(jax.device_get(opt_state)))})


def assert_state_close(pt, params, opt_state, atol):
    want = temporal_opt_state_from_optax(
        serialization.to_state_dict(jax.device_get(opt_state)))
    got = pt.state()
    for k, v in params_from_flax(jax.device_get(params)).items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                   atol=atol, err_msg=k)
    for group in ("mu", "nu", "acc_grads"):
        if group not in want:
            continue
        for k, v in want[group].items():
            np.testing.assert_allclose(got["opt_state"][group][k].numpy(),
                                       v.numpy(), atol=atol,
                                       err_msg=f"{group}/{k}")
    for k in ("count", "mini_step", "gradient_step", "lr"):
        if k in want:
            assert float(got["opt_state"][k]) == float(want[k]), k


# --------------------------------------------------------- loss, filters

def test_nll_softmax_loss(rng):
    s = (rng.normal(size=(6, 30)) * 8).astype(np.float32)
    s[2, 5] = 80.0  # a target with p ~ 0 at row 2
    objs = rng.integers(0, 30, 6).astype(np.int32)
    for qmask in (np.array([1, 1, 1, 1, 0, 1], bool), np.zeros(6, bool)):
        want = jloop.nll_softmax_loss(jnp.asarray(s), jnp.asarray(objs),
                                      jnp.asarray(qmask))
        got = tloop.nll_softmax_loss(torch.from_numpy(s),
                                     torch.from_numpy(objs),
                                     torch.from_numpy(qmask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_stage_filter_indices_matches_jax(vocab_dir):
    kg = JKG.load_vocab_dir(vocab_dir)
    sp2o, spt2o = {}, {}
    for split in ("train", "valid", "test"):
        for s, p, o, t in kg.splits[split]:
            sp2o.setdefault((s, p), set()).add(o)
            spt2o.setdefault((s, p, t), set()).add(o)
    sp2o = {k: np.array(sorted(v)) for k, v in sp2o.items()}
    spt2o = {k: np.array(sorted(v)) for k, v in spt2o.items()}
    data = kg.splits["valid"][:21]
    for b in (8, 5):
        want = jloop.stage_filter_indices(sp2o, spt2o, data, b, kg.n_ent)
        got = tloop.stage_filter_indices(sp2o, spt2o, data, b, kg.n_ent)
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a, w)
    # the device keep-mask: False at the listed entities, pads dropped
    idx = torch.from_numpy(got[0][0].astype(np.int32))
    keep = tloop._keep_mask(idx, kg.n_ent)
    for row, m in zip(got[0][0], keep.numpy()):
        assert set(np.nonzero(~m)[0]) == set(row[row < kg.n_ent])


# -------------------------------------------------------------- optimizer

@pytest.mark.parametrize("over", [
    dict(optimizer="adamw", weight_decay=1e-2),
    dict(optimizer="adamw", weight_decay=1e-2, grad_clip=0.5),
    dict(optimizer="adam", weight_decay=1e-3, grad_clip=0.5,
         grad_accum_steps=2),
    dict(optimizer="adam", weight_decay=1e-3, grad_accum_steps=3),
], ids=["adamw", "adamw_clip", "adam_clip_accum2", "adam_accum3"])
def test_optimizer_matches_optax(vocab_dir, rng, over):
    """7 updates of the JAX trainer's optax chain and the port's flat
    update on the same gradients, with a live lr cut after the third
    (plateau_step's write), clipped and unclipped norms."""
    kg = JKG.load_vocab_dir(vocab_dir)
    jt = jloop.TemporalTrainer(kg, JConfig(**dict(INTERP, n_layer=1,
                                                  lr=1e-2, **over)))
    opt = tloop.TemporalOptimizer(jt.cfg.optimizer, jt.cfg.weight_decay,
                                  jt.cfg.grad_clip, jt.cfg.grad_accum_steps)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    # one leaf named as TRedGNN's, so params_from_flax reads the state
    jp = {"classifier_w": jnp.asarray(p0)}
    jstate = jt.tx.init(jp)
    tp = torch.from_numpy(p0.copy())
    tstate = opt.init(tp, 1e-2)
    for step in range(7):
        if step == 3:
            inner = jstate.inner_opt_state if hasattr(
                jstate, "inner_opt_state") else jstate
            inner.hyperparams["learning_rate"] = jnp.asarray(1e-3)
            tstate["lr"].fill_(1e-3)
        g = rng.normal(size=p0.shape).astype(np.float32) * 0.3 ** (step - 3)
        upd, jstate = jt.tx.update({"classifier_w": jnp.asarray(g)}, jstate,
                                   jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tstate = opt.update(torch.from_numpy(g), tstate, tp)
        tp = tp + tupd
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp["classifier_w"]),
                                   atol=1e-6, err_msg=str(step))
    want = temporal_opt_state_from_optax(serialization.to_state_dict(jstate))
    assert want.keys() == tstate.keys()
    for k in ("mu", "nu", "acc_grads"):
        if k in want:
            np.testing.assert_allclose(tstate[k].numpy(),
                                       want[k]["classifier_w"].numpy(),
                                       rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    for k in ("count", "mini_step", "gradient_step", "lr"):
        if k in want:
            assert float(tstate[k]) == float(want[k]), k


# ------------------------------------------------------------- train steps

def _batch(kg, lo, b, mode):
    d = kg.splits["train"][lo:lo + b]
    excl = (kg.exclusion_slots(np.arange(lo, lo + b))
            if mode == "interpolation" else None)
    return d, excl


@pytest.mark.parametrize("settings", [
    INTERP,
    dict(EXTRAP, grad_accum_steps=2, grad_clip=0.05),
], ids=["interp_adamw", "extrap_adam_accum2_clip"])
def test_train_steps_match_jax(vocab_dir, id_dir, settings):
    """4 steps from carried-over parameters and optimizer state (the
    moments made non-trivial by one JAX step first): loss, overflow and
    the update's rejection flag equal, parameters and state within 2e-5.
    Interpolation runs a sparse hop, then dense hops, with leave-one-out."""
    mode = settings.get("mode", "interpolation")
    jt, pt = make_pair(id_dir if mode == "extrapolation" else vocab_dir,
                       **settings)
    b = jt.cfg.batch_size
    data = jt.kg.splits["train"][:5 * b]
    caps = jt._get_caps("train", data, b)
    tcaps = pt._get_caps("train", data, b)
    assert (tcaps.node_caps, tcaps.edge_caps) == (caps.node_caps,
                                                  caps.edge_caps)
    kinds = temporal_hop_plan(pt.model_cfg, pt.kg.graph.n_edges, tcaps, b,
                              True)
    if mode == "interpolation":
        assert kinds[0] == "bitmap" and "dense" in kinds, kinds
    step = jax.jit(jt._train_step_impl, static_argnames=("caps",))

    def jstep(params, opt_state, k):
        d, excl = _batch(jt.kg, k * b, b, mode)
        return step(params, opt_state, jt._kgarrs,
                    *(jnp.asarray(d[:, j], jnp.int32) for j in range(4)),
                    jnp.ones(b, bool),
                    None if excl is None else jnp.asarray(excl, jnp.int32),
                    jax.random.PRNGKey(0), caps)

    params, opt_state, *_ = jstep(jt.params, jt.opt_state, 0)
    carry(params, opt_state, pt)
    for k in range(1, 5):
        params, opt_state, jl, jov, jbad = jstep(params, opt_state, k)
        d, excl = _batch(pt.kg, k * b, b, mode)
        t = [torch.from_numpy(d[:, j].astype(np.int32)) for j in range(4)]
        loss, overflow, bad = pt._train_step(
            t[0], t[1], t[2], t[3], torch.ones(b, dtype=torch.bool),
            None if excl is None else torch.from_numpy(excl.astype(np.int32)),
            tcaps)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        assert bool(overflow) == bool(jov) and bool(bad) == bool(jbad)
        assert_state_close(pt, params, opt_state, atol=2e-5)


def test_nonfinite_step_rejected(vocab_dir):
    """A non-finite step leaves parameters and the whole optimizer state
    (moments, counts, accumulator) bit-equal; its loss counts as 0."""
    kg = TemporalKG.load_vocab_dir(vocab_dir, device="cpu")
    pt = tloop.TemporalTrainer(kg, TemporalTrainConfig(
        **dict(INTERP, grad_accum_steps=2)))
    b = pt.cfg.batch_size
    d, excl = _batch(kg, 0, b, "interpolation")
    caps = pt._get_caps("train", d, b)
    args = [torch.from_numpy(d[:, j].astype(np.int32)) for j in range(4)] \
        + [torch.ones(b, dtype=torch.bool),
           torch.from_numpy(excl.astype(np.int32)), caps]
    before = pt._flat.clone()
    loss, _, bad = pt._train_step(*args)
    assert np.isfinite(float(loss)) and not bool(bad)
    assert torch.equal(pt._flat, before)         # accumulated, not applied
    assert int(pt.opt_state["mini_step"]) == 1
    loss, _, bad = pt._train_step(*args)
    assert not torch.equal(pt._flat, before) and not bool(bad)
    assert int(pt.opt_state["count"]) == 1

    pt._flat.fill_(1e38)                         # poisoned: non-finite
    snap_flat, snap_opt, _ = pt._snapshot()
    loss, _, bad = pt._train_step(*args)
    assert bool(bad) and float(loss) == 0.0
    assert torch.equal(pt._flat, snap_flat)
    for k, v in snap_opt.items():
        assert torch.equal(pt.opt_state[k], v), k


# ------------------------------------------------------- caps, epochs, eval

@pytest.mark.parametrize("settings", [INTERP, EXTRAP],
                         ids=["interpolation", "extrapolation"])
def test_epoch_and_evaluate_match_jax(vocab_dir, id_dir, settings):
    """An epoch (interpolation: 6 batches of 8 in chunks of 3 steps;
    extrapolation: the whole split in batches of 16, the last one padded,
    in one chunk) ends at the JAX trainer's parameters with one host read
    per chunk, under the same exact caps. Then from its state: interpolation raw metrics,
    extrapolation raw / fil / fil_t and the found rate, rtol 1e-5, with
    equal eval caps; too-small eval caps are detected and grown."""
    mode = settings.get("mode", "interpolation")
    over = (dict(batch_size=16, scan_chunk=64) if mode == "extrapolation"
            else dict(max_train_batches=6))
    jt, pt = make_pair(id_dir if mode == "extrapolation" else vocab_dir,
                       **dict(settings, **over))
    b = pt.cfg.batch_size
    n = (len(pt.kg.splits["train"]) if mode == "extrapolation"
         else 6 * b)
    assert mode == "interpolation" or n % b, n  # a padded last batch
    want = jt.train_epoch(0)
    got = pt.train_epoch(0)
    c, w = pt.caps["train"], jt.caps["train"]
    assert (c.node_caps, c.edge_caps) == (w.node_caps, w.edge_caps)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_state_close(pt, jt.params, jt.opt_state, atol=1e-4)
    assert pt.host_syncs == -(-(-(-n // b)) // pt.cfg.scan_chunk)
    train = pt.kg.splits["train"]
    order = np.random.default_rng(1).permutation(len(train))[:40]
    a = pt._get_caps("train", train[order], 5, order=order)
    w = jt._get_caps("train", train[order], 5, order=order)
    assert (a.node_caps, a.edge_caps) == (w.node_caps, w.edge_caps)

    carry(jt.params, jt.opt_state, pt)
    want, got = jt.evaluate("valid"), pt.evaluate("valid")
    assert got.keys() == want.keys() and got["n"] == want["n"] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    c, w = pt.caps["eval_valid"], jt.caps["eval_valid"]
    assert (c.node_caps, c.edge_caps) == (w.node_caps, w.edge_caps)
    if mode == "extrapolation":
        assert got["fil_mrr"] >= got["raw_mrr"] - 1e-9
    pt.caps["eval_valid"] = FrontierCaps((8,) + (8,) * pt.cfg.n_layer,
                                         (8,) * pt.cfg.n_layer)
    again = pt.evaluate("valid")
    np.testing.assert_allclose(again["mrr"], want["mrr"], rtol=1e-5)
    assert pt.caps["eval_valid"].edge_caps[0] > 8


def test_chunk_replay_after_overflow(vocab_dir):
    """Too-small caps once: the chunk is rolled back (parameters, optimizer
    state, generator) and replayed with caps grown to cover it, which for
    a one-chunk epoch are the exact caps of an undisturbed run; the epoch
    ends where that run does, bit for bit (dropout on). Bits are asked of
    torch's deterministic CPU kernels: the default index_put_ backward of
    the dense gather adds in another order from run to run."""
    torch.use_deterministic_algorithms(True)
    try:
        _chunk_replay(vocab_dir)
    finally:
        torch.use_deterministic_algorithms(False)


def _chunk_replay(vocab_dir):
    cfg = TemporalTrainConfig(**dict(INTERP, dropout=0.2,
                                     max_train_batches=3))
    clean = tloop.TemporalTrainer(
        TemporalKG.load_vocab_dir(vocab_dir, device="cpu"), cfg)
    clean_loss = clean.train_epoch(0)
    pt = tloop.TemporalTrainer(
        TemporalKG.load_vocab_dir(vocab_dir, device="cpu"), cfg)
    real = pt._get_caps

    def stingy(split, data, b, order=None):
        real(split, data, b, order)
        pt.caps[split] = FrontierCaps((b,) + (8,) * cfg.n_layer,
                                      (8,) * cfg.n_layer)
        return pt.caps[split]

    pt._get_caps = stingy
    loss = pt.train_epoch(0)
    assert loss == clean_loss
    assert torch.equal(pt._flat, clean._flat)
    for k in pt.opt_state:
        assert torch.equal(pt.opt_state[k], clean.opt_state[k]), k
    assert torch.equal(pt.rng.get_state(), clean.rng.get_state())
    assert pt.host_syncs == clean.host_syncs + 1
    assert pt.caps["train"] == clean.caps["train"]


# ---------------------------------------------- plateau, state, checkpoints

def test_plateau_and_host_state_round_trip(vocab_dir, tmp_path):
    kg = TemporalKG.load_vocab_dir(vocab_dir, device="cpu")
    cfg = TemporalTrainConfig(**dict(INTERP, lr=1e-2, patience=0,
                                     grad_accum_steps=2,
                                     max_train_batches=2))
    pt = tloop.TemporalTrainer(kg, cfg)
    jt = jloop.TemporalTrainer(JKG.load_vocab_dir(vocab_dir), JConfig(
        **dataclasses.asdict(cfg)))
    for loss in (1.0, 2.0, 0.5, 0.7, 0.9):
        pt.plateau_step(loss)
        jt.plateau_step(loss)
        assert pt._lr == pytest.approx(jt._lr)
        assert (pt._plateau_best, pt._plateau_bad) == \
            (jt._plateau_best, jt._plateau_bad)
    assert float(pt.opt_state["lr"]) == np.float32(1e-5)
    pt.train_epoch(0)
    mu = pt.opt_state["mu"].clone()
    pt.force_lr(3e-3)
    assert torch.equal(pt.opt_state["mu"], mu)
    assert float(pt.opt_state["lr"]) == np.float32(3e-3)

    path = pt.save(str(tmp_path / "ck"), 2, 0.25)
    host = json.load(open(path + ".host.json"))
    assert host["lr"] == 3e-3 and host["plateau_bad"] == pt._plateau_bad
    nxt = pt._np_rng.integers(0, 1 << 30)
    gen_next = torch.rand(3, generator=pt.rng)

    other = tloop.TemporalTrainer(kg, dataclasses.replace(cfg, seed=9))
    assert other.restore(path) == 2
    assert torch.equal(other._flat, pt._flat)
    for k in pt.opt_state:
        assert torch.equal(other.opt_state[k], pt.opt_state[k]), k
    assert other._lr == 3e-3 and other._plateau_best == pt._plateau_best
    assert other._np_rng.integers(0, 1 << 30) == nxt
    assert torch.equal(torch.rand(3, generator=other.rng), gen_next)
    # the sidecar's lr is authoritative; without one, the optimizer's
    h = json.load(open(path + ".host.json"))
    h["lr"] = 1e-5
    json.dump(h, open(path + ".host.json", "w"))
    other.restore_host(path)
    assert float(other.opt_state["lr"]) == np.float32(1e-5)
    os.remove(path + ".host.json")
    other.restore_host(path)
    assert other._lr == pytest.approx(1e-5)
    # another model shape is refused
    small = tloop.TemporalTrainer(kg, dataclasses.replace(cfg,
                                                          hidden_dim=4))
    with pytest.raises(RuntimeError, match="does not match"):
        small.restore(path)


@pytest.mark.parametrize("settings", [
    dict(INTERP, grad_accum_steps=2),
    dict(EXTRAP, grad_clip=1.0),
], ids=["interp_multisteps", "extrap_clip"])
def test_restore_jax_msgpack_checkpoint(vocab_dir, id_dir, tmp_path,
                                        settings):
    """A checkpoint the JAX TemporalTrainer wrote (flax msgpack + host
    sidecar) restores into the port: parameters, optimizer state, live lr
    and plateau counters."""
    mode = settings.get("mode", "interpolation")
    path_dir = id_dir if mode == "extrapolation" else vocab_dir
    jkg, kg = load_pair(path_dir, settings)
    jt = jloop.TemporalTrainer(jkg, JConfig(**settings))
    # every floating leaf of the optimizer state random, so that each one
    # is seen to land in its place
    key = iter(jax.random.split(jax.random.PRNGKey(5), 200))
    jt.opt_state = jax.tree_util.tree_map(
        lambda x: (jax.random.uniform(next(key), x.shape, x.dtype)
                   if jnp.issubdtype(x.dtype, jnp.floating) else x + 3),
        jt.opt_state)
    jt.plateau_step(1.0)
    jt.force_lr(2e-3)
    path = jsave(str(tmp_path / "jck"), jt.state(), 4, 0.5,
                 host=jt.host_state())
    pt = tloop.TemporalTrainer(kg, TemporalTrainConfig(**settings))
    assert pt.restore(path) == 4
    assert_state_close(pt, jt.params, jt.opt_state, atol=0)
    assert pt._lr == 2e-3 and pt._plateau_best == 1.0
    # with and without MultiSteps the optimizer states differ in structure
    accum = 1 if settings.get("grad_accum_steps", 1) > 1 else 2
    wrong = tloop.TemporalTrainer(kg, TemporalTrainConfig(**dict(
        settings, grad_accum_steps=accum)))
    with pytest.raises(RuntimeError, match="does not match"):
        wrong.restore(path)


# ------------------------------------------------------ serving, the CLI

@pytest.mark.parametrize("settings", [INTERP, EXTRAP],
                         ids=["interpolation", "extrapolation"])
def test_predictor_matches_jax(vocab_dir, id_dir, settings):
    from test_torch_serve import assert_topk_agree

    mode = settings.get("mode", "interpolation")
    jt, pt = make_pair(id_dir if mode == "extrapolation" else vocab_dir,
                       **settings)
    jpred = JPredictor(jt, split="test", top_k=5)
    pred = Predictor.from_trainer(pt, split="test", top_k=5)
    assert pred.caps is pt.caps["eval_test"]
    assert (pred.caps.node_caps, pred.caps.edge_caps) == \
        (jpred.caps.node_caps, jpred.caps.edge_caps)
    q = pt.kg.splits["test"][:11]
    want_s, want_e = jpred.predict(q[:, 0], q[:, 1], q[:, 3])
    got_s, got_e = pred.predict(q[:, 0], q[:, 1], q[:, 3])
    assert got_s.shape == (11, 5) and got_e.shape == (11, 5)
    assert assert_topk_agree(got_s, got_e, want_s, want_e) > 0
    # the constructor from a model and a state dict gives the same caps
    # and answers
    direct = Predictor(pt.model, pt.model.state_dict(), pt.kg, pt.cfg,
                       split="test", top_k=5)
    assert direct.caps == pred.caps
    s2, e2 = direct.predict(q[:, 0], q[:, 1], q[:, 3])
    np.testing.assert_array_equal(got_s, s2)
    np.testing.assert_array_equal(got_e, e2)
    with pytest.raises(RuntimeError, match="overflow"):
        Predictor(pt.model, None, pt.kg, pt.cfg, top_k=5, caps=FrontierCaps(
            (8,) + (8,) * pt.cfg.n_layer, (8,) * pt.cfg.n_layer)).predict(
            q[:, 0], q[:, 1], q[:, 3])


def test_trainer_refusals_match_jax(vocab_dir):
    jkg, kg = load_pair(vocab_dir, INTERP)
    over = dict(INTERP, segment_impl="pallas")
    with pytest.raises(ValueError) as want:
        jloop.TemporalTrainer(jkg, JConfig(**over))
    with pytest.raises(ValueError) as got:
        tloop.TemporalTrainer(kg, TemporalTrainConfig(**over))
    assert str(got.value) == str(want.value)
    # a mesh whose data axis does not divide the batch sizes
    from redgnn_tpu.parallel.mesh import make_mesh as jmake_mesh
    from redgnn_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError) as want:
        jloop.TemporalTrainer(jkg, JConfig(**INTERP), mesh=jmake_mesh(3, 1))
    with pytest.raises(ValueError) as got:
        tloop.TemporalTrainer(kg, TemporalTrainConfig(**INTERP), mesh=Mesh(
            3, 1, 0, torch.device("cpu"), "gloo",
            {"data": None, "edge": None}))
    assert str(got.value) == str(want.value)
    a = tloop.TemporalTrainer(kg, TemporalTrainConfig(**INTERP))
    b = tloop.TemporalTrainer(kg, TemporalTrainConfig(**INTERP))
    assert torch.equal(a._flat, b._flat)
    assert a.params.keys() == a.model.state_dict().keys()


@pytest.mark.parametrize("task", ["interpolation", "extrapolation"])
def test_cli_temporal_cpu(vocab_dir, tmp_path, rng, capsys, task):
    """One epoch through the CLI; an extrapolation dir named ICEWS14 finds
    the ICEWS14_forecasting entry; the best checkpoint reads back with
    --eval_only."""
    data = (write_id_dir(tmp_path / "ICEWS14", rng)
            if task == "extrapolation" else vocab_dir)
    d = str(tmp_path / "ck")
    sets = ["hidden_dim=8", "attn_dim=6", "n_layer=2", "batch_size=16",
            "eval_batch_size=16", "max_train_batches=4",
            "max_eval_batches=2", "lr=0.003"]
    if task == "extrapolation":
        sets.append("window=6")
    cli_main(["--task", task, "--data_path", data, "--device", "cpu",
              "--epochs", "1", "--ckpt_dir", d, "--timer", "--set", *sets])
    lines = capsys.readouterr().out.strip().splitlines()
    resolved = json.loads(lines[0])
    assert resolved["mode"] == task and resolved["hidden_dim"] == 8
    if task == "extrapolation":  # the ICEWS14_forecasting entry's values
        assert (resolved["optimizer"], resolved["time_granularity"]) == \
            ("adam", 24) and resolved["window"] == 6
    assert lines[-1].startswith("BEST ")
    best = json.loads(lines[-1][len("BEST "):])
    assert 0.0 <= best["valid_mrr"] <= 1.0
    assert any("timer:" in ln for ln in lines)
    names = sorted(n for n in os.listdir(d) if n.endswith(".pt"))
    assert "latest.pt" in names and len(names) == 2
    best_ck = [n for n in names if n != "latest.pt"][0]
    cli_main(["--task", task, "--data_path", data, "--device", "cpu",
              "--eval_only", "--load_checkpoint", os.path.join(d, best_ck),
              "--set", *sets])
    out = capsys.readouterr().out
    assert "restored checkpoint" in out and "lr override" in out
    metrics = json.loads(out.strip().splitlines()[-1])
    np.testing.assert_allclose(metrics["valid"]["mrr"], best["valid_mrr"],
                               rtol=1e-6)
