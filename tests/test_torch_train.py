"""The port's training slice vs the JAX package on the CPU: loss,
optimizer, train steps from carried-over parameters and Adam state, caps,
resplit, evaluation, the chunk replay, checkpoints, Predictor.from_trainer
and the CLI. Tiny sizes (hidden 16, 2 layers, 40 entities), dropout 0
wherever the two packages are compared (their RNG streams differ)."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import serialization

from redgnn_tpu.graph import calibrate as jcal
from redgnn_tpu.graph.inductive import InductiveKG as JInductiveKG
from redgnn_tpu.graph.kg import StaticKG as JKG
from redgnn_tpu.graph.kg import filters_of as jfilters_of
from redgnn_tpu.models import redgnn as jmodel
from redgnn_tpu.train import loop as jloop
from redgnn_tpu.utils.config import TrainConfig as JConfig
from redgnn_tpu_torch.cli.train import main as cli_main
from redgnn_tpu_torch.cli.train import parse_overrides
from redgnn_tpu_torch.graph import calibrate as tcal
from redgnn_tpu_torch.graph.inductive import InductiveKG
from redgnn_tpu_torch.graph.kg import StaticKG, build_src_order, filters_of
from redgnn_tpu_torch.models import redgnn as tmodel
from redgnn_tpu_torch.serve import Predictor
from redgnn_tpu_torch.train import loop as tloop
from redgnn_tpu_torch.utils import checkpoint as ckpt
from redgnn_tpu_torch.utils.config import TrainConfig
from redgnn_tpu_torch.utils.metrics import combine_metric_sums
from redgnn_tpu_torch.utils.port_params import (
    opt_state_from_optax,
    params_from_flax,
)
from redgnn_tpu_torch.utils.timers import PhaseTimer

from test_train_loop import write_kg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = dict(hidden_dim=16, attn_dim=5, n_layer=2, dropout=0.0, lr=0.01,
                lamb=1e-4, decay_rate=0.9, n_batch=8, n_tbatch=8,
                segment_impl="pallas", dense_hops=False, scan_chunk=4)


@pytest.fixture
def kg_dir(tmp_path, rng):
    d = tmp_path / "kg"
    d.mkdir()
    return str(write_kg(d, rng))


# The registry's implementation defaults (dedup 'auto', the plain segment
# sum, dense hops, the packed gather) on the toy KG: dense_switch and
# three layers make the hops bitmap, then dense.
DEFAULTS = dict(segment_impl="xla", dedup_impl="auto", dense_hops=True,
                scan_src_backward=True, dense_switch=0.4, n_layer=3)


def make_pair(kg_dir, inductive=False, **over):
    """(JAX trainer, port trainer) on the same files and settings, the
    port continuing from the JAX trainer's parameters and Adam state."""
    settings = dict(SETTINGS, **over)
    jkg = JInductiveKG.load(kg_dir) if inductive else JKG.load(kg_dir)
    kg = (InductiveKG if inductive else StaticKG).load(kg_dir, device="cpu")
    jt = jloop.StaticTrainer(jkg, JConfig(**settings))
    pt = tloop.StaticTrainer(kg, TrainConfig(**settings))
    carry(jt.params, jt.opt_state, pt)
    return jt, pt


def carry(params, opt_state, pt):
    adam = jax.device_get(opt_state[1])
    pt.load_state({"params": params_from_flax(jax.device_get(params)),
                   "opt_state": opt_state_from_optax(adam.mu, adam.nu,
                                                     adam.count)})


def assert_state_close(pt, params, opt_state, atol):
    adam = jax.device_get(opt_state[1])
    want = {"params": params_from_flax(jax.device_get(params)),
            "mu": params_from_flax(adam.mu), "nu": params_from_flax(adam.nu)}
    got = pt.state()
    got = {"params": got["params"], "mu": got["opt_state"]["mu"],
           "nu": got["opt_state"]["nu"]}
    for group in want:
        for k, v in want[group].items():
            np.testing.assert_allclose(got[group][k].numpy(), v.numpy(),
                                       atol=atol, err_msg=f"{group}/{k}")
    assert int(pt.opt_state["count"]) == int(adam.count)


# ------------------------------------------------------------ loss, optimizer

def test_softmax_ce_loss(rng):
    s = (rng.normal(size=(6, 30)) * 5).astype(np.float32)
    objs = rng.integers(0, 30, 6).astype(np.int32)
    qmask = np.array([1, 1, 1, 1, 0, 1], bool)
    want = jloop.softmax_ce_loss(jnp.asarray(s), jnp.asarray(objs),
                                 jnp.asarray(qmask))
    got = tloop.softmax_ce_loss(torch.from_numpy(s), torch.from_numpy(objs),
                                torch.from_numpy(qmask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_optimizer_matches_optax(rng):
    """6 updates with steps_per_epoch=2: the staircase decays twice."""
    cfg = dict(lr=0.01, decay_rate=0.5, lamb=0.01)
    tx = jloop.make_optimizer(JConfig(**cfg), 2)
    opt = tloop.make_optimizer(TrainConfig(**cfg), 2)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    jp = {"w": jnp.asarray(p0)}
    jstate = tx.init(jp)
    tp = torch.from_numpy(p0.copy())
    tstate = opt.init(tp)
    for step in range(6):
        g = rng.normal(size=p0.shape).astype(np.float32) * 10 ** (step - 3)
        upd, jstate = tx.update({"w": jnp.asarray(g)}, jstate, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, upd)
        lr = float(opt.learning_rate(tstate["count"]))
        assert lr == pytest.approx(0.01 * 0.5 ** (step // 2), rel=1e-6)
        tupd, tstate = opt.update(torch.from_numpy(g), tstate, tp)
        tp = tp + tupd
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp["w"]), atol=1e-6)
        np.testing.assert_allclose(tstate["mu"].numpy(),
                                   np.asarray(jstate[1].mu["w"]), atol=1e-6)
        np.testing.assert_allclose(tstate["nu"].numpy(),
                                   np.asarray(jstate[1].nu["w"]), rtol=1e-5)
    assert int(tstate["count"]) == int(jstate[1].count) == 6


def test_nan_scrub():
    gen = torch.Generator().manual_seed(3)
    flat = torch.tensor([1.0, float("nan"), float("nan"), 2.0, float("nan"),
                         float("inf")])
    owner = torch.tensor([0, 0, 0, 1, 2, 2])
    out = tloop.nan_scrub(flat, owner, 3, gen)
    assert out[0] == 1.0 and out[3] == 2.0 and torch.isinf(out[5])
    assert not torch.isnan(out).any()
    # one scalar per parameter tensor, broadcast; in [0, 1)
    assert out[1] == out[2] and out[1] != out[4]
    assert 0.0 <= float(out[1]) < 1.0 and 0.0 <= float(out[4]) < 1.0
    clean = torch.arange(6.0)
    assert torch.equal(tloop.nan_scrub(clean, owner, 3, gen), clean)


# ------------------------------------------------------------------- dropout

def test_dropout_mask():
    x = torch.ones(400, 50)
    out = tmodel._dropout(x, 0.29, torch.Generator().manual_seed(1))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.71) < 0.01
    torch.testing.assert_close(out[kept], torch.full_like(out[kept],
                                                          1 / 0.71))
    again = tmodel._dropout(x, 0.29, torch.Generator().manual_seed(1))
    assert torch.equal(out, again)
    other = tmodel._dropout(x, 0.29, torch.Generator().manual_seed(2))
    assert not torch.equal(out, other)


def test_dropout_in_model(kg_dir):
    kg = StaticKG.load(kg_dir, device="cpu")
    tr = tloop.StaticTrainer(kg, TrainConfig(**dict(SETTINGS, dropout=0.3)))
    b = tr.cfg.n_batch
    data = torch.from_numpy(kg.train_data[:b].astype(np.int32))
    args = (kg.graph, data[:, 0], data[:, 1], torch.ones(b, dtype=torch.bool),
            tr.train_caps)
    with torch.no_grad():
        plain, _ = tr.model(*args)
        also_plain, _ = tr.model(*args, train=False,
                                 generator=torch.Generator().manual_seed(5))
        a, _ = tr.model(*args, train=True,
                        generator=torch.Generator().manual_seed(5))
        a2, _ = tr.model(*args, train=True,
                         generator=torch.Generator().manual_seed(5))
        c, _ = tr.model(*args, train=True,
                        generator=torch.Generator().manual_seed(6))
    assert torch.equal(plain, also_plain)   # identity in eval
    assert torch.equal(a, a2)               # same seed -> same masks
    assert not torch.equal(a, plain) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        tr.model(*args, train=True)          # never the global RNG


# ------------------------------------------------------- caps, resplit, filters

def test_exact_caps_match_jax(kg_dir, rng, monkeypatch):
    monkeypatch.setattr(tcal, "_WALK_CHUNK", 7)  # several chunks of heads
    kg = JKG.load(kg_dir)
    rowptr, _, tail = kg.graph_np
    heads = kg.train_data[:, 0]
    jn, je = jcal.per_query_counts(rowptr, tail, kg.n_ent, heads, 3)
    tn, te = tcal.per_query_counts(rowptr, tail, kg.n_ent, heads, 3)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(te, je)
    # the native walker's plain reference, the chunked numpy edge walk
    for got, want in zip(tcal.per_query_counts_numpy(
            rowptr, tail, kg.n_ent, heads, 3), (jn, je)):
        np.testing.assert_array_equal(got, want)
    # a batch's counts are the sum of its queries' rows
    nc, ec = tcal.simulate_hops(rowptr, tail, kg.n_ent, heads[:8], 3)
    assert nc == list(tn[:8].sum(0)) and ec == list(te[:8].sum(0))
    assert (nc, ec) == jcal.simulate_hops(rowptr, tail, kg.n_ent,
                                          heads[:8], 3)
    for b in (8, 5):
        want = jcal.caps_for_batches(jn, je, b)
        got = tcal.caps_for_batches(tn, te, b)
        assert (got.node_caps, got.edge_caps) == (want.node_caps,
                                                  want.edge_caps)
        want = jcal.caps_upper_bound(jn, je, b)
        got = tcal.caps_upper_bound(tn, te, b)
        assert (got.node_caps, got.edge_caps) == (want.node_caps,
                                                  want.edge_caps)
        assert got.covers(tcal.caps_for_batches(tn, te, b))
    a = tcal.FrontierCaps((8, 256, 512), (256, 1024))
    c = tcal.FrontierCaps((8, 512, 256), (512, 256))
    u = a.union(c)
    assert (u.node_caps, u.edge_caps) == ((8, 512, 512), (512, 1024))
    ju = jcal.FrontierCaps(a.node_caps, a.edge_caps).union(
        jcal.FrontierCaps(c.node_caps, c.edge_caps))
    assert (u.node_caps, u.edge_caps) == (ju.node_caps, ju.edge_caps)
    assert u.covers(a) and u.covers(c) and not a.covers(c)


def test_resplit_and_filters_match_jax(kg_dir):
    jkg, kg = JKG.load(kg_dir), StaticKG.load(kg_dir, device="cpu")
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        jkg.resplit(jr)
        kg.resplit(tr)
        np.testing.assert_array_equal(kg.train_data, jkg.train_data)
        for a, b in zip(kg.graph_np, jkg.graph_np):
            np.testing.assert_array_equal(a, b)
        for name in ("rowptr", "rel", "tail", "tsrc", "trel", "ttail",
                     "tail_rowptr"):
            np.testing.assert_array_equal(
                getattr(kg.graph, name).numpy(),
                np.asarray(getattr(jkg.graph, name)), err_msg=name)
        assert kg.graph.device == kg.device
    h, r = (int(x) for x in kg.train_data[0, :2])
    np.testing.assert_array_equal(kg.filter_row(h, r), jkg.filter_row(h, r))
    assert kg.filter_row(10 ** 6, 0).shape == (0,)
    spec, jspec = kg.eval_spec("valid"), jkg.eval_spec("valid")
    for q in spec.queries[:5]:
        np.testing.assert_array_equal(spec.filter_row(*q),
                                      jspec.filter_row(*q))
    want, got = jfilters_of(jkg.train_data), filters_of(kg.train_data)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------------- train steps

def _step_args(kg, lo, b):
    d = kg.train_data[lo:lo + b]
    return d[:, 0], d[:, 1], d[:, 2], np.ones(b, bool)


def test_train_steps_match_jax(kg_dir):
    """3 steps from carried-over parameters and moments (the moments made
    non-trivial by one JAX step first)."""
    jt, pt = make_pair(kg_dir)
    assert (pt.train_caps.node_caps, pt.train_caps.edge_caps) == \
        (jt.train_caps.node_caps, jt.train_caps.edge_caps)
    assert pt.steps_per_epoch == jt.steps_per_epoch
    b = jt.cfg.n_batch
    step = jax.jit(jt._train_step_impl, static_argnames=("caps",))

    def jstep(params, opt_state, lo):
        s, r, o, q = _step_args(jt.kg, lo, b)
        return step(params, opt_state, jt.kg.graph, jnp.asarray(s, jnp.int32),
                    jnp.asarray(r, jnp.int32), jnp.asarray(o, jnp.int32),
                    jnp.asarray(q), jax.random.PRNGKey(0), jt.train_caps)

    params, opt_state, *_ = jstep(jt.params, jt.opt_state, 0)
    carry(params, opt_state, pt)
    for k in range(1, 4):
        params, opt_state, jl, jov, jne = jstep(params, opt_state, k * b)
        s, r, o, q = (torch.from_numpy(a) for a in
                      _step_args(pt.kg, k * b, b))
        loss, overflow, num_edges = pt._train_step(
            s.int(), r.int(), o.int(), q, pt.train_caps)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        assert bool(overflow) == bool(jov)
        np.testing.assert_array_equal(num_edges.numpy(), np.asarray(jne))
        assert_state_close(pt, params, opt_state, atol=2e-5)
    assert int(pt.opt_state["count"]) == 4


def test_nonfinite_step_rejected(kg_dir):
    """A non-finite step leaves parameters, moments and the update count
    bit-equal and its loss counts as 0 (tests/test_train_loop.py:110-152)."""
    kg = StaticKG.load(kg_dir, device="cpu")
    pt = tloop.StaticTrainer(kg, TrainConfig(**SETTINGS))
    b = pt.cfg.n_batch
    s, r, o, q = (torch.from_numpy(a) for a in _step_args(kg, 0, b))
    args = (s.int(), r.int(), o.int(), q, pt.train_caps)

    before = pt._flat.clone()
    loss, _, _ = pt._train_step(*args)   # healthy step: params move
    assert np.isfinite(float(loss)) and float(loss) > 0
    assert not torch.equal(pt._flat, before)
    assert int(pt.opt_state["count"]) == 1

    pt._flat.fill_(1e38)                 # poisoned -> non-finite forward
    snap_flat, snap_opt, _ = pt._snapshot()
    loss, _, _ = pt._train_step(*args)
    assert float(loss) == 0.0
    assert torch.equal(pt._flat, snap_flat)
    for k in ("mu", "nu", "count"):
        assert torch.equal(pt.opt_state[k], snap_opt[k]), k
    # the model's parameters are views of the flat vector
    assert all(torch.all(p == 1e38) for p in pt.model.parameters())


def test_eval_matches_jax(kg_dir):
    jt, pt = make_pair(kg_dir)
    jt.train_epoch(0)                    # move off the initial weights
    carry(jt.params, jt.opt_state, pt)
    for split in ("valid", "test"):
        want, got = jt.evaluate(split), pt.evaluate(split)
        assert got["n"] == want["n"] > 0
        for k in ("mrr", "h1", "h3", "h10"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        assert (pt.eval_caps[split].node_caps, pt.eval_caps[split].edge_caps) \
            == (jt.eval_caps[split].node_caps, jt.eval_caps[split].edge_caps)
    # too-small eval caps are detected and recalibrated exactly
    pt.eval_caps["valid"] = tcal.FrontierCaps((8, 8, 8), (8, 8))
    again = pt.evaluate("valid")
    np.testing.assert_allclose(again["mrr"], jt.evaluate("valid")["mrr"],
                               rtol=1e-5)
    assert pt.eval_caps["valid"].edge_caps[0] > 8


def test_train_epoch_matches_jax(kg_dir):
    """A whole epoch (chunks of 4 steps, a padded last batch) ends at the
    JAX trainer's parameters, with one host read per chunk."""
    jt, pt = make_pair(kg_dir)
    want = jt.train_epoch(0)
    got = pt.train_epoch(0)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_state_close(pt, jt.params, jt.opt_state, atol=1e-4)
    steps = pt.steps_per_epoch
    assert int(pt.opt_state["count"]) == steps
    assert pt.host_syncs == -(-steps // pt.cfg.scan_chunk)
    assert (pt.train_caps.node_caps, pt.train_caps.edge_caps) == \
        (jt.train_caps.node_caps, jt.train_caps.edge_caps)


def test_chunk_replay_after_overflow(kg_dir):
    """Too-small caps once: the chunk is rolled back (parameters, moments,
    count and the dropout generator) and replayed, and the epoch ends bit
    for bit where an undisturbed run does."""
    cfg = TrainConfig(**dict(SETTINGS, dropout=0.2))
    clean = tloop.StaticTrainer(StaticKG.load(kg_dir, device="cpu"), cfg)
    clean_loss = clean.train_epoch(0)

    pt = tloop.StaticTrainer(StaticKG.load(kg_dir, device="cpu"), cfg)
    sampled, real, calls = pt.train_caps, pt._recalibrate_exact, []

    def stingy(caps, *args, **kw):
        calls.append(caps)
        if len(calls) == 1:
            return tcal.FrontierCaps((cfg.n_batch, 8, 8), (8, 8))
        return real(sampled, *args, **kw)

    pt._recalibrate_exact = stingy
    loss = pt.train_epoch(0)
    assert len(calls) == 2               # upfront, then after the overflow
    assert loss == clean_loss
    assert torch.equal(pt._flat, clean._flat)
    for k in ("mu", "nu", "count"):
        assert torch.equal(pt.opt_state[k], clean.opt_state[k]), k
    assert torch.equal(pt.rng.get_state(), clean.rng.get_state())
    assert pt.host_syncs == clean.host_syncs + 1

    pt._recalibrate_exact = lambda caps, *a, **kw: tcal.FrontierCaps(
        (cfg.n_batch, 8, 8), (8, 8))
    with pytest.raises(RuntimeError, match="failed to stabilize"):
        pt.train_epoch(1)


def test_training_learns(kg_dir):
    """The bar of tests/test_train_loop.py:41-53."""
    kg = StaticKG.load(kg_dir, device="cpu")
    cfg = TrainConfig(hidden_dim=16, attn_dim=5, n_layer=2, dropout=0.05,
                      lr=0.01, lamb=1e-5, n_batch=16, n_tbatch=16, epochs=4,
                      segment_impl="pallas", dense_hops=False)
    trainer = tloop.StaticTrainer(kg, cfg)
    losses, mrrs = [], []
    for epoch in range(4):
        losses.append(trainer.train_epoch(epoch))
        mrrs.append(trainer.evaluate("valid")["mrr"])
        trainer.kg.resplit(trainer._np_rng)
    assert losses[-1] < losses[0] * 0.9, losses
    assert max(mrrs) > 0.2, mrrs


def test_trainer_refuses_mesh_and_seeds_init(kg_dir):
    """A mesh whose data axis does not divide n_batch is refused with the
    JAX package's message, a mesh rank on another device than the KG too;
    a bfloat16 trainer builds and its layers gather bf16 rows; the seed
    alone sets the initial weights."""
    from redgnn_tpu.parallel.mesh import make_mesh as jmake_mesh
    from redgnn_tpu_torch.parallel.mesh import Mesh

    kg = StaticKG.load(kg_dir, device="cpu")
    with pytest.raises(ValueError) as want:
        jloop.StaticTrainer(JKG.load(kg_dir), JConfig(**SETTINGS),
                            mesh=jmake_mesh(3, 1))
    no_groups = {"data": None, "edge": None}
    with pytest.raises(ValueError) as got:
        tloop.StaticTrainer(kg, TrainConfig(**SETTINGS), mesh=Mesh(
            3, 1, 0, torch.device("cpu"), "gloo", no_groups))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="the mesh rank on meta"):
        tloop.StaticTrainer(kg, TrainConfig(**SETTINGS), mesh=Mesh(
            2, 1, 0, torch.device("meta"), "gloo", no_groups))
    bf = tloop.StaticTrainer(kg, TrainConfig(**dict(
        SETTINGS, compute_dtype="bfloat16")))
    assert bf.model_cfg.compute_dtype == "bfloat16"
    seen = []
    bf.model.layer_1.Ws_attn.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].detach()))
    with torch.no_grad():
        s, r, _, q = (torch.from_numpy(a) for a in
                      _step_args(kg, 0, SETTINGS["n_batch"]))
        bf.model(kg.graph, s.int(), r.int(), q, bf.train_caps)
    hs = seen[0]  # the projection takes the bf16 rows promoted to float32
    assert hs.dtype == torch.float32 and bool((hs != 0).any())
    assert torch.equal(hs, hs.to(torch.bfloat16).float())
    a = tloop.StaticTrainer(kg, TrainConfig(**SETTINGS))
    b = tloop.StaticTrainer(kg, TrainConfig(**SETTINGS))
    c = tloop.StaticTrainer(kg, TrainConfig(**dict(SETTINGS, seed=7)))
    assert torch.equal(a._flat, b._flat) and not torch.equal(a._flat, c._flat)
    assert a.params.keys() == a.model.state_dict().keys()


# ------------------------------------------------- checkpoints, serving, CLI

def test_checkpoint_round_trip(kg_dir, tmp_path):
    kg = StaticKG.load(kg_dir, device="cpu")
    pt = tloop.StaticTrainer(kg, TrainConfig(**SETTINGS))
    pt.train_epoch(0)
    kg.resplit(pt._np_rng)               # advance the host rng
    d = str(tmp_path / "ckpt")
    path = pt.save(d, 3, 0.25)
    assert os.path.basename(path) == "0.25000.3.pt"
    assert ckpt.load_host(path)["np_rng"] == pt._np_rng.bit_generator.state
    want = {k: v.clone() for k, v in pt.params.items()}
    want_mu = pt.opt_state["mu"].clone()
    next_perm = np.random.default_rng()
    next_perm.bit_generator.state = pt._np_rng.bit_generator.state
    next_perm = next_perm.permutation(10)

    other = tloop.StaticTrainer(kg, TrainConfig(**dict(SETTINGS, seed=9)))
    assert other.restore(path) == 3
    for k, v in want.items():
        assert torch.equal(other.params[k], v), k
        assert torch.equal(other.model.state_dict()[k], v), k
    assert torch.equal(other.opt_state["mu"], want_mu)
    assert int(other.opt_state["count"]) == pt.steps_per_epoch
    np.testing.assert_array_equal(other._np_rng.permutation(10), next_perm)

    # best-of-keep pruning, latest, best_checkpoint
    for epoch, metric in ((4, 0.1), (5, 0.4), (6, 0.3)):
        ckpt.save_checkpoint(d, pt.state(), epoch, metric,
                             host=pt.host_state())
    names = sorted(n for n in os.listdir(d) if n.endswith(".pt"))
    assert names == ["0.25000.3.pt", "0.30000.6.pt", "0.40000.5.pt"]
    assert not os.path.exists(os.path.join(d, "0.10000.4.pt.host.json"))
    assert os.path.basename(ckpt.best_checkpoint(d)) == "0.40000.5.pt"
    assert ckpt.load_latest(d, pt.state()) is None
    ckpt.save_latest(d, pt.state(), 7, 0.3, host=pt.host_state())
    state, epoch, metric = ckpt.load_latest(d, pt.state())
    assert (epoch, metric) == (7, 0.3)
    assert torch.equal(state["opt_state"]["count"], pt.opt_state["count"].cpu())
    assert os.path.basename(ckpt.best_checkpoint(d)) == "0.40000.5.pt"
    # a checkpoint of another model shape is refused
    small = tloop.StaticTrainer(kg, TrainConfig(**dict(SETTINGS,
                                                       hidden_dim=8)))
    with pytest.raises(ValueError, match="checkpoint"):
        small.restore(path)


@pytest.mark.parametrize("sidecar", ["absent", "no_key", "bad_state",
                                     "not_json"])
def test_restore_host_sidecar(kg_dir, tmp_path, sidecar):
    """No sidecar: the rng stays as it is, silently. A sidecar that is
    there but cannot be applied raises: the resumed run would otherwise
    re-split the graph in another sequence without notice."""
    kg = StaticKG.load(kg_dir, device="cpu")
    pt = tloop.StaticTrainer(kg, TrainConfig(**SETTINGS))
    path = pt.save(str(tmp_path / "ckpt"), 1, 0.5)
    host = path + ".host.json"
    before = pt._np_rng.bit_generator.state
    if sidecar == "absent":
        os.remove(host)
        assert pt.restore(path) == 1
        assert pt._np_rng.bit_generator.state == before
        return
    with open(host, "w") as f:
        f.write({"no_key": "{}", "bad_state": '{"np_rng": {"x": 1}}',
                 "not_json": "{np_rng"}[sidecar])
    with pytest.raises(ValueError, match="host"):
        pt.restore_host(path)
    assert pt._np_rng.bit_generator.state == before


def test_predictor_from_trainer(kg_dir):
    kg = StaticKG.load(kg_dir, device="cpu")
    pt = tloop.StaticTrainer(kg, TrainConfig(**SETTINGS))
    pt.train_epoch(0)
    pred = Predictor.from_trainer(pt, split="test", top_k=5)
    assert pt.eval_caps["test"] is pred.caps and pred.caps is not None
    nq = min(10, len(kg.test))
    scores, ents = pred.predict(kg.test[:nq, 0], kg.test[:nq, 1])
    assert scores.shape == (nq, 5) and ents.shape == (nq, 5)
    assert np.all(np.diff(scores, axis=1) <= 1e-6)
    assert np.all((ents >= 0) & (ents < kg.n_ent))
    # the same model and caps as a Predictor built from the state dict
    direct = Predictor(pt.model, pt.model.state_dict(), kg, pt.cfg,
                       split="test", top_k=5)
    s2, e2 = direct.predict(kg.test[:nq, 0], kg.test[:nq, 1])
    np.testing.assert_array_equal(scores, s2)
    np.testing.assert_array_equal(ents, e2)
    assert Predictor.from_trainer(pt, "test", 5).caps is pred.caps


CLI_SET = ["hidden_dim=16", "n_layer=2", "n_batch=16", "n_tbatch=16",
           "dropout=0.1", "segment_impl=pallas", "dense_hops=false"]


def test_cli_transductive_cpu(kg_dir, tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    cli_main(["--task", "transductive", "--data_path", kg_dir, "--device",
              "cpu", "--epochs", "2", "--ckpt_dir", d, "--seed", "3",
              "--timer", "--set", *CLI_SET])
    lines = capsys.readouterr().out.strip().splitlines()
    resolved = json.loads(lines[0])
    assert resolved["hidden_dim"] == 16 and resolved["seed"] == 3
    assert resolved["dense_hops"] is False
    assert lines[-1].startswith("BEST ")
    best = json.loads(lines[-1][len("BEST "):])
    assert 0.0 <= best["valid_mrr"] <= 1.0
    assert any("timer:" in ln for ln in lines)
    names = {n for n in os.listdir(d) if n.endswith(".pt")}
    assert "latest.pt" in names and len(names) >= 2

    cli_main(["--task", "transductive", "--data_path", kg_dir, "--device",
              "cpu", "--eval_only", "--load_checkpoint",
              ckpt.best_checkpoint(d), "--set", *CLI_SET])
    out = capsys.readouterr().out
    assert "restored checkpoint" in out
    metrics = json.loads(out.strip().splitlines()[-1])
    np.testing.assert_allclose(metrics["valid"]["mrr"], best["valid_mrr"],
                               rtol=1e-6)

    cli_main(["--task", "transductive", "--data_path", kg_dir, "--device",
              "cpu", "--epochs", "3", "--ckpt_dir", d, "--resume_latest",
              "--seed", "3", "--set", *CLI_SET])
    out = capsys.readouterr().out
    assert "resuming from latest checkpoint at epoch 2" in out
    assert out.count("[VALID]") == 1     # only epoch 2 was left to run


@pytest.mark.parametrize("extra", [
    ["--eval_splits", "valid"], ["--task", "interpolation", "--distributed"],
    ["--task", "extrapolation", "--mesh", "2"],
    ["--task", "extrapolation", "--model", "xerte", "--mesh", "2"],
    ["--task", "extrapolation", "--model", "simple", "--hpo", "4"],
    ["--mesh", "2"], ["--hpo", "4"], ["--sqlite", "x.db"],
    ["--results_dir", "results"], ["--attention_stats", "a.npz"],
])
def test_cli_unported_options_exit(kg_dir, tmp_path, rng, capfd,
                                   monkeypatch, extra):
    """Each option that the port's CLI refused before it was ported (the
    test keeps its name) now runs on the CPU to its result, or exits with
    the JAX package's own refusal (--mesh and --hpo take the redgnn model
    only). Relative outputs land in the test's directory."""
    from test_temporal import write_temporal_dir
    from test_torch_temporal import write_id_dir

    monkeypatch.chdir(tmp_path)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    task = extra[1] if extra[0] == "--task" else "transductive"
    sets = ["hidden_dim=16", "n_layer=2", "n_batch=16", "n_tbatch=16"]
    if task == "transductive":
        data = kg_dir
    else:
        sets = ["hidden_dim=8", "attn_dim=6", "n_layer=2", "batch_size=16",
                "eval_batch_size=16", "max_train_batches=2",
                "max_eval_batches=2"]
        if task == "interpolation":
            (tmp_path / "tkg").mkdir()
            data = str(write_temporal_dir(tmp_path / "tkg", rng))
        else:
            data = write_id_dir(tmp_path / "toy_forecasting", rng)
            sets.append("window=6")
    argv = ["--data_path", data, "--device", "cpu", "--epochs", "1"]
    if extra[0] != "--task":
        argv += ["--task", "transductive"]
    argv += extra
    if "--model" in extra:
        with pytest.raises(SystemExit, match="redgnn model only"):
            cli_main(argv)
        return
    cli_main(argv + ["--set", *sets])
    out = capfd.readouterr().out
    last = out.strip().splitlines()[-1]
    name = os.path.basename(data)
    if "--hpo" in extra:
        assert last.startswith("HPO_BEST ")
        with open(os.path.join("results", f"{name}_hpo.jsonl")) as f:
            assert len(f.read().splitlines()) == 4  # 4 trials, 1 rung
        return
    assert any(ln.startswith("BEST ") for ln in out.splitlines())
    if "--eval_splits" in extra:
        assert last.startswith("EVAL_SPLITS ")
        assert 0.0 <= json.loads(last[12:])["valid"]["mrr"] <= 1.0
    elif "--distributed" in extra:
        assert "no coordinator environment found" in out
    elif "--mesh" in extra:
        assert "mesh: 2 data x 1 edge over 2 ranks (gloo" in out
    elif "--sqlite" in extra:
        import sqlite3

        db = sqlite3.connect("x.db")
        assert db.execute("SELECT COUNT(*) FROM runs").fetchone()[0] == 1
        db.close()
    elif "--attention_stats" in extra:
        assert "--attention_stats supports temporal redgnn only" in out
        assert not os.path.exists("a.npz")
    for kind in ("perf.txt", "metrics.jsonl", "mem.txt"):
        assert os.path.exists(os.path.join("results", f"{name}_{kind}"))


def test_cli_overrides_and_device(kg_dir):
    cfg = parse_overrides(["lr=0.5", "n_layer=4", "dense_hops=no",
                           "act=tanh"], TrainConfig())
    assert (cfg.lr, cfg.n_layer, cfg.dense_hops, cfg.act) == \
        (0.5, 4, False, "tanh")
    with pytest.raises(SystemExit, match="unknown config field"):
        parse_overrides(["nope=1"], TrainConfig())
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_main(["--task", "transductive", "--data_path", kg_dir])


# ------------------------------------------- registry defaults, inductive

def test_train_steps_at_registry_defaults_match_jax(kg_dir):
    """3 steps through bitmap hops (packed gather, prefix-sum backward)
    and dense hops, from carried-over parameters and moments."""
    jt, pt = make_pair(kg_dir, **DEFAULTS)
    b = jt.cfg.n_batch
    kinds = tmodel.hop_plan(pt.model_cfg, pt.kg.graph, pt.train_caps, b)
    assert "bitmap" in kinds and "dense" in kinds, kinds
    step = jax.jit(jt._train_step_impl, static_argnames=("caps",))

    def jstep(params, opt_state, lo):
        s, r, o, q = _step_args(jt.kg, lo, b)
        return step(params, opt_state, jt.kg.graph, jnp.asarray(s, jnp.int32),
                    jnp.asarray(r, jnp.int32), jnp.asarray(o, jnp.int32),
                    jnp.asarray(q), jax.random.PRNGKey(0), jt.train_caps)

    params, opt_state, *_ = jstep(jt.params, jt.opt_state, 0)
    carry(params, opt_state, pt)
    for k in range(1, 4):
        params, opt_state, jl, jov, jne = jstep(params, opt_state, k * b)
        s, r, o, q = (torch.from_numpy(a) for a in
                      _step_args(pt.kg, k * b, b))
        loss, overflow, num_edges = pt._train_step(
            s.int(), r.int(), o.int(), q, pt.train_caps)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        assert bool(overflow) == bool(jov)
        np.testing.assert_array_equal(num_edges.numpy(), np.asarray(jne))
        assert_state_close(pt, params, opt_state, atol=2e-5)


def test_eval_at_registry_defaults_matches_jax(kg_dir):
    jt, pt = make_pair(kg_dir, **DEFAULTS)
    jt.train_epoch(0)
    carry(jt.params, jt.opt_state, pt)
    for split in ("valid", "test"):
        want, got = jt.evaluate(split), pt.evaluate(split)
        assert got["n"] == want["n"] > 0
        for k in ("mrr", "h1", "h3", "h10"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        kinds = tmodel.hop_plan(pt.model_cfg, pt.kg.eval_graph,
                                pt.eval_caps[split], pt.n_tbatch)
        assert "bitmap" in kinds and "dense" in kinds, kinds


def write_inductive(tmp_path, rng, n_ent=40, n_ent_ind=30, n_rel=4):
    """A toy inductive dataset: ``DIR/`` and ``DIR_ind/`` with disjoint
    entity vocabularies (``name\\tid`` pairs, ids in shuffled file order)
    and shared relations; r2(x) = r0(r1(x)) on both sides."""
    root = tmp_path / "toy_v1"
    for d, n, prefix in ((root, n_ent, "e"),
                         (tmp_path / "toy_v1_ind", n_ent_ind, "u")):
        d.mkdir()
        order = rng.permutation(n)
        (d / "entities.txt").write_text(
            "".join(f"{prefix}{i}\t{i}\n" for i in order))
        (d / "relations.txt").write_text(
            "".join(f"r{i}\t{i}\n" for i in range(n_rel)))
        p1, p0 = rng.permutation(n), rng.permutation(n)
        triples = []
        for i in range(n):
            triples.append((f"{prefix}{i}", "r1", f"{prefix}{p1[i]}"))
            triples.append((f"{prefix}{p1[i]}", "r0",
                            f"{prefix}{p0[p1[i]]}"))
            triples.append((f"{prefix}{i}", "r2", f"{prefix}{p0[p1[i]]}"))
            triples.append((f"{prefix}{i}", "r3",
                            f"{prefix}{rng.integers(n)}"))
        rng.shuffle(triples)
        cut = (int(len(triples) * 0.7), int(len(triples) * 0.85))
        for fname, tri in (("train.txt", triples[:cut[0]]),
                           ("valid.txt", triples[cut[0]:cut[1]]),
                           ("test.txt", triples[cut[1]:])):
            (d / fname).write_text(
                "".join(f"{h}\t{r}\t{t}\n" for h, r, t in tri))
    return str(root)


@pytest.fixture
def ind_dir(tmp_path, rng):
    return write_inductive(tmp_path, rng)


def test_inductive_kg_matches_jax(ind_dir):
    want = JInductiveKG.load(ind_dir)
    got = InductiveKG.load(ind_dir, device="cpu")
    assert (got.n_ent, got.n_ent_ind, got.n_rel) == \
        (want.n_ent, want.n_ent_ind, want.n_rel) == (40, 30, 4)
    assert got.entity2id_ind == want.entity2id_ind
    np.testing.assert_array_equal(got.train_data, want.train_data)
    for name in ("graph_np", "ind_graph_np"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("graph", "ind_graph"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.device.type == "cpu"
        for f in g.FIELDS:
            # tsrc_order: the port's own list (the dense hop's gather
            # backward), the stable order of JAX's tsrc
            want_f = (build_src_order(np.asarray(w.tsrc))
                      if f == "tsrc_order" else np.asarray(getattr(w, f)))
            np.testing.assert_array_equal(getattr(g, f).numpy(), want_f,
                                          err_msg=f)
    assert got.ind_graph.n_ent == 30
    for split in ("valid", "test"):
        gs, ws = got.eval_spec(split), want.eval_spec(split)
        assert gs.n_ent == ws.n_ent == (40 if split == "valid" else 30)
        np.testing.assert_array_equal(gs.queries, ws.queries)
        assert len(gs.answers) == len(ws.answers) > 0
        for a, b in zip(gs.answers, ws.answers):
            np.testing.assert_array_equal(a, b)
        assert gs.filters.keys() == ws.filters.keys()
        for k in ws.filters:
            np.testing.assert_array_equal(gs.filters[k], ws.filters[k])
    # the training-query quirk: train queries are the doubled valid set
    assert len(got.train_data) == 2 * sum(
        1 for ln in open(os.path.join(ind_dir, "valid.txt")) if ln.strip())
    graph_before = [a.copy() for a in got.graph_np]
    got.resplit(np.random.default_rng(3))
    want.resplit(np.random.default_rng(3))
    np.testing.assert_array_equal(got.train_data, want.train_data)
    for a, b in zip(got.graph_np, graph_before):  # queries only
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("settings", [{}, DEFAULTS],
                         ids=["pallas_sparse", "registry_defaults"])
def test_inductive_eval_matches_jax(ind_dir, settings):
    """One epoch on the transductive side, then valid (transductive
    graph) and test (inductive graph, another entity count) metrics."""
    jt, pt = make_pair(ind_dir, inductive=True, **settings)
    want_loss = jt.train_epoch(0)
    got_loss = pt.train_epoch(0)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    carry(jt.params, jt.opt_state, pt)
    for split in ("valid", "test"):
        want, got = jt.evaluate(split), pt.evaluate(split)
        assert got["n"] == want["n"] > 0
        for k in ("mrr", "h1", "h3", "h10"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert pt.kg.eval_spec("test").n_ent != pt.model_cfg.n_ent
    # one set of parameters serves both graphs through the Predictor too
    pred = Predictor.from_trainer(pt, split="test", top_k=3)
    q = pt.kg.eval_spec("test").queries[:5]
    scores, ents = pred.predict(q[:, 0], q[:, 1])
    assert scores.shape == (5, 3) and ents.max() < 30


def test_cli_inductive_cpu(ind_dir, capsys):
    cli_main(["--task", "inductive", "--data_path", ind_dir, "--device",
              "cpu", "--epochs", "2", "--set", "hidden_dim=16", "n_layer=3",
              "n_batch=16", "n_tbatch=16", "dense_switch=0.4"])
    lines = capsys.readouterr().out.strip().splitlines()
    resolved = json.loads(lines[0])
    # the registry's implementation defaults, untouched
    assert (resolved["dedup_impl"], resolved["segment_impl"],
            resolved["dense_hops"], resolved["scan_src_backward"]) == \
        ("auto", "xla", True, True)
    assert sum("[TEST]" in ln for ln in lines) == 2
    best = json.loads(lines[-1][len("BEST "):])
    assert 0.0 <= best["valid_mrr"] <= 1.0 and 0.0 <= best["test_mrr"] <= 1.0


def test_cli_registry_defaults_cpu(kg_dir, capsys):
    """The transductive CLI with no implementation override at all."""
    cli_main(["--task", "transductive", "--data_path", kg_dir, "--device",
              "cpu", "--epochs", "1", "--set", "hidden_dim=16", "n_layer=3",
              "n_batch=16", "n_tbatch=16", "dense_switch=0.4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0])["dense_hops"] is True
    assert lines[-1].startswith("BEST ")


def test_metrics_and_timer():
    m = combine_metric_sums([
        {"rr_sum": 1.5, "h1_sum": 1, "h3_sum": 2, "h10_sum": 3, "count": 4},
        {"rr_sum": 0.5, "h1_sum": 0, "h3_sum": 1, "h10_sum": 1, "count": 1}])
    assert m == {"mrr": 0.4, "h1": 0.2, "h3": 0.6, "h10": 0.8, "n": 5.0}
    assert combine_metric_sums([])["mrr"] == 0.0
    t = PhaseTimer(enabled=True)
    with t.phase("train", "device"):
        pass
    assert "[train] device:" in str(t)
    t.reset()
    assert str(t) == "(no timings)"
    off = PhaseTimer(enabled=False)
    with off.phase("train", "device"):
        pass
    assert str(off) == "(no timings)"


# ------------------------------------------------ a banked checkpoint carried

def test_banked_wn18rr_checkpoint_carried_across(tmp_path, rng):
    """The WN18RR run's best checkpoint (5 layers, 11 relations, hidden 48,
    tanh), restored with flax here, goes through params_from_flax and
    opt_state_from_optax into the port; both models then score a small
    synthetic 11-relation KG alike."""
    path = os.path.join(ROOT, "artifacts", "r5_r5b_wn18rr", "best.msgpack")
    with open(path, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    adam = raw["opt_state"]["1"]
    d = tmp_path / "kg11"
    d.mkdir()
    write_kg(d, rng, n_ent=30, n_rel=11)
    settings = dict(hidden_dim=48, attn_dim=5, n_layer=5, act="tanh",
                    dropout=0.0, n_batch=6, n_tbatch=6, lr=0.0021,
                    decay_rate=0.9962, segment_impl="pallas",
                    dense_hops=False)
    kg = StaticKG.load(str(d), device="cpu")
    pt = tloop.StaticTrainer(kg, TrainConfig(**settings))
    pt.load_state({"params": params_from_flax(raw["params"]),
                   "opt_state": opt_state_from_optax(adam["mu"], adam["nu"],
                                                     adam["count"])})
    assert int(pt.opt_state["count"]) == 16095
    np.testing.assert_array_equal(
        pt.state()["opt_state"]["nu"]["layer_4.W_h.weight"].numpy(),
        adam["nu"]["layer_4"]["W_h"]["kernel"].T)
    # the run's own schedule: 16095 updates = 37 epochs of 435 steps
    want_lr = optax.exponential_decay(0.0021, 435, 0.9962, staircase=True)(
        adam["count"])
    got_lr = tloop.Adam(0.0021, 0.9962, 0.0, 435).learning_rate(
        pt.opt_state["count"])
    np.testing.assert_allclose(float(got_lr), float(want_lr), rtol=1e-6)
    np.testing.assert_allclose(float(got_lr), 0.0021 * 0.9962 ** 37,
                               rtol=1e-5)

    jkg = JKG.load(str(d))
    jcfg = jmodel.ModelConfig(n_ent=jkg.n_ent, n_rel=11, hidden_dim=48,
                              attn_dim=5, n_layer=5, dropout=0.0, act="tanh",
                              segment_impl="pallas", dense_hops=False)
    b = 6
    data = kg.train_data[:b]
    caps = pt.train_caps
    want, _ = jmodel.RedGNN(jcfg).apply(
        {"params": raw["params"]}, jkg.graph,
        jnp.asarray(data[:, 0], jnp.int32), jnp.asarray(data[:, 1], jnp.int32),
        jnp.ones(b, bool),
        jcal.FrontierCaps(caps.node_caps, caps.edge_caps), False)
    with torch.no_grad():
        got, _ = pt.model(kg.graph, torch.from_numpy(data[:, 0]).int(),
                          torch.from_numpy(data[:, 1]).int(),
                          torch.ones(b, dtype=torch.bool), caps)
    assert np.abs(np.asarray(want)).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
