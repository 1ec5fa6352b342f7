"""The port's xERTE vs the JAX package on the CPU: `_dedup_keys`, the
forward per sampling strategy, time bound and aggregation (entity mass,
`visited`, overflow flags, sampled edge ids, target keys and top-k masks),
a visited set filled exactly to its capacity, `bce_loss` and its
gradients, the segment softmax's derivative at tied maxima, the banked
round-5 weights at full width and the CLI (the trainer:
`test_torch_xerte_train.py`). Sizes follow `tests/test_xerte.py` (emb_dim
(32, 16, 8), 2 DP steps, K 4). The JAX model draws its uniforms from
`jax.random`, which torch cannot replay, so 'uniform' and 'weighted' get
the JAX draws through `forward(draws=...)`."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from redgnn_tpu.graph.temporal import TemporalKG as JKG
from redgnn_tpu.models import xerte as jx
from redgnn_tpu.ops import segment as jseg
from redgnn_tpu_torch.cli.train import main as cli_main
from redgnn_tpu_torch.graph.temporal import TemporalKG
from redgnn_tpu_torch.models import xerte as tx
from redgnn_tpu_torch.ops import segment as tseg
from redgnn_tpu_torch.train.xerte_loop import XErteTrainer
from redgnn_tpu_torch.utils.port_params import params_from_flax

from test_temporal import write_temporal_dir
from test_torch_temporal import write_id_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(emb_dim=(32, 16, 8), dp_steps=2, dp_num_edges=4,
             max_attended_edges=8)


@pytest.fixture(autouse=True)
def deterministic():
    # CPU bit-equality of the index_put_ accumulations (gather backward)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.fixture(scope="module")
def kgs(tmp_path_factory):
    path = str(write_temporal_dir(tmp_path_factory.mktemp("xerte"),
                                  np.random.default_rng(3)))
    return JKG.load_vocab_dir(path), TemporalKG.load_vocab_dir(path,
                                                               device="cpu")


def small_cfg(kg, module, **kw):
    return module.XErteConfig(n_ent=kg.n_ent, n_rel=kg.idd_rel,
                              n_time=kg.n_time + 2, **dict(SMALL, **kw))


def jax_draws(cfg, b: int, seed: int):
    """The uniforms the JAX model draws inside a forward with ``seed``."""
    out = []
    for step in range(cfg.dp_steps):
        n_att = b if step == 0 else b * cfg.max_attended_edges
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(17), step), jnp.int32(seed))
        out.append(torch.tensor(np.asarray(
            jax.random.uniform(key, (n_att, cfg.dp_num_edges)))))
    return out


class Recorder:
    """A graph table whose reads are recorded: the sampled edge ids."""

    def __init__(self, table):
        self.table, self.reads = table, []
        self.shape = table.shape

    def __getitem__(self, idx):
        self.reads.append(np.asarray(idx))
        return self.table[idx]


def batch_of(kg, b: int = 6):
    """``b`` valid quadruples, the last one masked out."""
    q = kg.splits["valid"][:b]
    qm = np.ones(b, bool)
    qm[-1] = False
    return q, qm


def jax_forward(jkg, cfg, params, q, qm, seed, monkeypatch):
    """(mass, aux, sampled edge ids per step, target keys per step, top-k
    masks per step) of the JAX model."""
    keys, keeps = [], []
    dedup, topk = jx._dedup_keys, jx.segment_topk_mask

    def rec_dedup(k, cap):
        keys.append(np.asarray(k))
        return dedup(k, cap)

    def rec_topk(*a, **kw):
        keeps.append(np.asarray(topk(*a, **kw)))
        return keeps[-1]

    monkeypatch.setattr(jx, "_dedup_keys", rec_dedup)
    monkeypatch.setattr(jx, "segment_topk_mask", rec_topk)
    rel = Recorder(jkg.graph.rel)
    mass, aux = jx.XErte(cfg).apply(
        {"params": params}, jkg.graph.rowptr, rel, jkg.graph.tail, jkg.ekey,
        jkg.time_key_base, jnp.asarray(q[:, 0], jnp.int32),
        jnp.asarray(q[:, 1], jnp.int32), jnp.asarray(q[:, 3], jnp.int32),
        jnp.asarray(qm), jnp.int32(seed))
    monkeypatch.undo()
    # per step: the visited-set dedup (old keys ++ target keys), then the
    # attended-set dedup
    k = cfg.dp_num_edges
    tgt = [keys[2 * s][-(len(ids) // k) * (k + 1):]
           for s, ids in enumerate(rel.reads)]
    return mass, aux, rel.reads, tgt, keeps


def port_forward(kg, model, q, qm, seed, draws):
    rel = Recorder(kg.graph.rel)
    mass, aux = model(kg.graph.rowptr, rel, kg.graph.tail, kg.ekey,
                      kg.time_key_base, torch.tensor(q[:, 0]),
                      torch.tensor(q[:, 1]), torch.tensor(q[:, 3]),
                      torch.tensor(qm), seed, draws=draws)
    return mass, aux, rel.reads


def init_pair(jkg, kg, jcfg, tcfg, q, qm, seed=0):
    """JAX parameters from flax init and the port model carrying them."""
    params = jx.XErte(jcfg).init(
        jax.random.PRNGKey(seed), jkg.graph.rowptr, jkg.graph.rel,
        jkg.graph.tail, jkg.ekey, jkg.time_key_base,
        jnp.asarray(q[:, 0], jnp.int32), jnp.asarray(q[:, 1], jnp.int32),
        jnp.asarray(q[:, 3], jnp.int32), jnp.asarray(qm),
        jnp.int32(0))["params"]
    model = tx.XErte(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params)),
                          strict=True)
    return params, model


# ---------------------------------------------------------------- dedup

@pytest.mark.parametrize("cap", [64, 12], ids=["fits", "overflows"])
def test_dedup_keys_matches_jax(cap):
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 20, 40).astype(np.int32)
    keys[rng.random(40) < 0.3] = tx.INVALID
    want = jx._dedup_keys(jnp.asarray(keys), cap)
    got = tx._dedup_keys(torch.tensor(keys, dtype=torch.int64), cap)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(got[3]) == (cap == 12)


# -------------------------------------------------------------- forward

FORWARD_CASES = (
    [dict(sampling=s, time_bound=tb) for s in tx.SAMPLINGS
     for tb in ("cut", "query")]
    + [dict(sampling="first", node_score_aggregation="mean",
            ent_score_aggregation="mean"),
       dict(sampling="weighted", node_score_aggregation="max"),
       dict(sampling="last", time_bound="query",
            node_score_aggregation="mean"),
       dict(sampling="uniform", ent_score_aggregation="mean",
            use_time_embedding=False),
       dict(sampling="first", ratio_update=0.3)])


@pytest.mark.parametrize(
    "case", FORWARD_CASES,
    ids=["-".join(str(v) for v in c.values()) for c in FORWARD_CASES])
def test_xerte_forward_matches_jax(kgs, case, monkeypatch):
    """Mass within 1e-5 absolute; `visited`, the overflow flags, the
    sampled edge ids, the target keys and the top-k masks equal."""
    jkg, kg = kgs
    jcfg, tcfg = small_cfg(jkg, jx, **case), small_cfg(kg, tx, **case)
    q, qm = batch_of(jkg)
    params, model = init_pair(jkg, kg, jcfg, tcfg, q, qm)
    seed = 5
    mass, aux, j_ids, j_keys, j_keep = jax_forward(jkg, jcfg, params, q, qm,
                                                   seed, monkeypatch)
    draws = (jax_draws(jcfg, len(q), seed)
             if case["sampling"] in ("uniform", "weighted") else None)
    with torch.no_grad():
        t_mass, t_aux, t_ids = port_forward(kg, model, q, qm, seed, draws)
    assert len(t_ids) == len(j_ids) == jcfg.dp_steps
    for s in range(jcfg.dp_steps):
        np.testing.assert_array_equal(t_ids[s], j_ids[s], err_msg=f"ids {s}")
        st = t_aux["steps"][s]
        np.testing.assert_array_equal(st["edge_keys"].numpy(), j_keys[s],
                                      err_msg=f"keys {s}")
        np.testing.assert_array_equal(st["keep"].numpy(), j_keep[s],
                                      err_msg=f"keep {s}")
    np.testing.assert_array_equal(t_aux["visited"].numpy(),
                                  np.asarray(aux["visited"]))
    np.testing.assert_array_equal(t_aux["node_overflow"].numpy(),
                                  np.asarray(aux["node_overflow"]))
    assert not t_aux["visited"][-1].any()  # the masked query
    np.testing.assert_allclose(t_mass.numpy(), np.asarray(mass), rtol=0,
                               atol=1e-5)
    assert float(t_mass.sum()) > 0


def test_visited_set_filled_exactly(kgs, monkeypatch):
    """A batch whose visited set fills its capacity exactly at the second
    DP step (44 keys in 44 slots, so no overflow flag) while INVALID keys
    (a masked query, unfilled slots) are relocated. JAX clamps their
    inverse onto the last slot, which then holds a valid key, and writes
    their state over it; the port drops them. Witness: the same weights
    at cap factor 8, where every key fits with room to spare, in both
    packages. The port at the exact fill equals its witness; JAX's equals
    the witness on every query but the owner of the last slot."""
    jkg, kg = kgs
    b, mae, per_step = 6, 8, 19
    q = kg.splits["valid"][6:6 + b]
    qm = np.ones(b, bool)
    qm[-1] = False
    out = {}
    for cap_factor in ((per_step + 0.5) / (b * mae), 8.0):
        case = dict(sampling="first", max_attended_edges=mae,
                    cap_factor=cap_factor)
        jcfg, tcfg = small_cfg(jkg, jx, **case), small_cfg(kg, tx, **case)
        params, model = init_pair(jkg, kg, jcfg, tcfg, q, qm)
        mass, aux, *_ = jax_forward(jkg, jcfg, params, q, qm, 0, monkeypatch)
        fills, dedup = [], tx._dedup_keys

        def rec_dedup(keys, cap):
            got = dedup(keys, cap)
            n = int(got[2])
            fills.append((n, cap, int((keys == tx.INVALID).sum()),
                          int(got[0][n - 1]) // tcfg.node_key_base))
            return got

        monkeypatch.setattr(tx, "_dedup_keys", rec_dedup)
        with torch.no_grad():
            t_mass, t_aux, _ = port_forward(kg, model, q, qm, 0, None)
        monkeypatch.undo()
        assert not np.asarray(aux["node_overflow"]).any()
        assert not t_aux["node_overflow"].any()
        out[cap_factor] = (np.asarray(mass), np.asarray(aux["visited"]),
                           t_mass.numpy(), t_aux["visited"].numpy(), fills)
    (j_mass, j_vis, t_mass, t_vis, fills), (w_jmass, w_jvis, w_mass,
                                             w_vis, _) = out.values()
    # the visited-set dedup of step 1 (calls: visited, attended per step)
    assert fills[2][0] == fills[2][1] == 44 and fills[2][2] > 0, fills
    np.testing.assert_allclose(w_jmass, w_mass, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(w_jvis, w_vis)
    np.testing.assert_allclose(t_mass, w_mass, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t_vis, w_vis)
    rest = np.arange(b) != fills[2][3]  # the owner of the last slot's key
    np.testing.assert_allclose(j_mass[rest], w_mass[rest], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(j_vis[rest], w_vis[rest])


def test_sampler_draws_and_refusal(kgs):
    """The port's own draws: a generator seeded from (step, rng_seed) on
    the model's device, the same per seed and different across seeds; an
    unknown strategy raises at construction."""
    jkg, kg = kgs
    cfg = small_cfg(kg, tx, sampling="uniform")
    a, b = tx.sample_draws(cfg, 4, 3, "cpu"), tx.sample_draws(cfg, 4, 3,
                                                             "cpu")
    c = tx.sample_draws(cfg, 4, 4, "cpu")
    assert [t.shape for t in a] == [(4, 4), (32, 4)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert tx.sample_draws(small_cfg(kg, tx), 4, 3, "cpu")[0] is not None
    assert tx.sample_draws(dataclasses.replace(cfg, sampling="last"), 4, 3,
                           "cpu") == [None, None]
    with pytest.raises(ValueError, match="sampling"):
        tx.XErte(dataclasses.replace(cfg, sampling="frist"), device="cpu")


@pytest.mark.parametrize("sampling", ["first", "weighted"])
def test_bce_loss_and_gradients_match_jax(kgs, sampling):
    """BCE and every parameter's gradient within rtol 1e-4 (+ 1e-5 of the
    parameter's largest gradient)."""
    jkg, kg = kgs
    jcfg = small_cfg(jkg, jx, sampling=sampling)
    tcfg = small_cfg(kg, tx, sampling=sampling)
    q, qm = batch_of(jkg)
    params, model = init_pair(jkg, kg, jcfg, tcfg, q, qm)
    objs = jnp.asarray(q[:, 2], jnp.int32)

    def jloss(p):
        mass, _ = jx.XErte(jcfg).apply(
            {"params": p}, jkg.graph.rowptr, jkg.graph.rel, jkg.graph.tail,
            jkg.ekey, jkg.time_key_base, jnp.asarray(q[:, 0], jnp.int32),
            jnp.asarray(q[:, 1], jnp.int32), jnp.asarray(q[:, 3], jnp.int32),
            jnp.asarray(qm), jnp.int32(2))
        return jx.bce_loss(mass, objs, jnp.asarray(qm))

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(params)
    draws = jax_draws(jcfg, len(q), 2) if sampling == "weighted" else None
    mass, _, _ = port_forward(kg, model, q, qm, 2, draws)
    loss = tx.bce_loss(mass, torch.tensor(q[:, 2]), torch.tensor(qm))
    names = [n for n, _ in model.named_parameters()]
    # the last bypass layer feeds nothing the mass reads: zero in JAX
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(
        torch.autograd.grad(loss, list(model.parameters()),
                            allow_unused=True), model.parameters())]
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-4)
    want = params_from_flax(jax.device_get(want))
    assert set(want) == set(names)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * scale + 1e-12, err_msg=name)
    assert float(want["transition_fn_1.query_proj.weight"].abs().max()) > 0


def test_segment_softmax_tied_max_gradient():
    """Where a segment's maximum is tied (xERTE: the same edge sampled
    twice), the JAX package's `segment_softmax` derivative is off: its
    ``jnp.minimum(z, 0)`` passes half the cotangent at z == 0 and the
    tied maxima share the max's. The port's is the exact one (float64
    numpy); the two agree wherever the maximum is not tied."""
    d = np.array([1.0, 1.0, 0.5, 2.0, -1.0, 2.0, 2.0, 0.25], np.float32)
    seg = np.array([0, 0, 0, 1, 1, 1, 1, 2], np.int32)
    w = np.array([0.3, -0.7, 1.1, 0.2, 0.9, -0.4, 0.6, 0.5], np.float32)
    valid = np.ones(8, bool)
    exact = np.zeros(8)
    for s in range(3):
        i = seg == s
        p = np.exp(d[i] - d[i].max()).astype(np.float64)
        p /= p.sum()
        exact[i] = p * (w[i] - (p * w[i]).sum())
    x = torch.tensor(d, requires_grad=True)
    out = tseg.segment_softmax(x, torch.tensor(seg), 3,
                               valid=torch.tensor(valid))
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), exact, atol=1e-7)
    args = (jnp.asarray(seg), 3, jnp.asarray(valid))
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jseg.segment_softmax(jnp.asarray(d), *args)), atol=1e-7)
    pkg = np.asarray(jax.grad(lambda v: jnp.sum(
        jseg.segment_softmax(v, *args) * w))(jnp.asarray(d)))
    tied = np.array([1, 1, 0, 1, 0, 1, 1, 0], bool)
    np.testing.assert_allclose(pkg[~tied], exact[~tied], atol=1e-7)
    assert np.abs(pkg[tied] - exact[tied]).max() > 0.05


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_banked_r5_checkpoint_scores_match_jax(tmp_path):
    """`artifacts/r5_xerte/best.msgpack` (trained on ICEWS14_forecasting:
    7,128 entities, 461 relation rows, emb 256-128-64-32) restores into
    the port's XErteTrainer with its sidecar (cap factor 4, step 3964);
    on the seeded ICEWS14_forecasting-sized dir of chip_smoke.py its
    scores for a batch of test quadruples at full width match the JAX
    package's: mass within 1e-5, `visited` and the overflow flags
    equal, each query's mass a distribution."""
    path = os.path.join(ROOT, "artifacts", "r5_xerte", "best.msgpack")
    _chip_smoke().write_icews14_sized(str(tmp_path), forecasting=True)
    kw = dict(add_inverse=True, time_granularity=24,
              graph_from_all_splits=True, warm_start_time=48)
    jkg = JKG.load_id_dir(str(tmp_path), **kw)
    kg = TemporalKG.load_id_dir(str(tmp_path), device="cpu", **kw)
    pt = XErteTrainer(kg, tx.XErteConfig(n_ent=kg.n_ent, n_rel=kg.idd_rel,
                                         n_time=kg.n_time + 2),
                      device="cpu")
    assert pt.restore(path) == 3
    assert pt.cfg.cap_factor == 4.0 and pt._step_counter == 3964
    with open(path, "rb") as f:
        params = serialization.msgpack_restore(f.read())["params"]
    jcfg = jx.XErteConfig(n_ent=jkg.n_ent, n_rel=jkg.idd_rel,
                          n_time=jkg.n_time + 2, cap_factor=4.0)
    q = jkg.splits["test"][:8]
    qm = np.ones(8, bool)
    mass, aux = jax.jit(jx.XErte(jcfg).apply, static_argnums=5)(
        {"params": params}, jkg.graph.rowptr, jkg.graph.rel, jkg.graph.tail,
        jkg.ekey, jkg.time_key_base, jnp.asarray(q[:, 0], jnp.int32),
        jnp.asarray(q[:, 1], jnp.int32), jnp.asarray(q[:, 3], jnp.int32),
        jnp.asarray(qm), jnp.int32(0))
    with torch.no_grad():
        t_mass, t_aux, _ = port_forward(kg, pt.model, q, qm, 0,
                                        jax_draws(jcfg, 8, 0))
    np.testing.assert_array_equal(t_aux["visited"].numpy(),
                                  np.asarray(aux["visited"]))
    np.testing.assert_array_equal(t_aux["node_overflow"].numpy(),
                                  np.asarray(aux["node_overflow"]))
    np.testing.assert_allclose(t_mass.numpy(), np.asarray(mass), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(t_mass.sum(1).numpy(), 1.0, atol=1e-4)


# ------------------------------------------------------------------- CLI

def test_cli_xerte_cpu(tmp_path, rng, capsys):
    """--model xerte on an id dir: the --set keys split between the
    temporal config and XErteConfig, an explicit batch_size reaches the
    trainer, the run ends in BEST, and the checkpoint reads back with
    --eval_only; with a static task --model xerte exits."""
    data = write_id_dir(tmp_path / "toy_forecasting", rng)
    d = str(tmp_path / "ck")
    sets = ["batch_size=16", "max_train_batches=3", "max_eval_batches=2",
            "dp_steps=2", "dp_num_edges=4", "max_attended_edges=6",
            "sampling=last"]
    cli_main(["--task", "extrapolation", "--model", "xerte", "--data_path",
              data, "--device", "cpu", "--epochs", "1", "--ckpt_dir", d,
              "--set", *sets])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0])["batch_size"] == 16
    assert any(ln.startswith("xerte epoch 0") for ln in lines)
    assert lines[-1].startswith("BEST ")
    best = json.loads(lines[-1][len("BEST "):])
    assert 0.0 <= best["valid_mrr"] <= 1.0 and "test_fil_mrr" in best
    ck = [n for n in os.listdir(d) if n.endswith(".pt") and n != "latest.pt"]
    cli_main(["--task", "extrapolation", "--model", "xerte", "--data_path",
              data, "--device", "cpu", "--eval_only", "--load_checkpoint",
              os.path.join(d, ck[0]), "--set", *sets])
    out = capsys.readouterr().out
    metrics = json.loads(out.strip().splitlines()[-1])
    np.testing.assert_allclose(metrics["valid"]["mrr"], best["valid_mrr"],
                               rtol=1e-6)
    with pytest.raises(SystemExit, match="temporal task"):
        cli_main(["--task", "transductive", "--model", "xerte",
                  "--data_path", data, "--device", "cpu"])
    with pytest.raises(SystemExit, match="redgnn trainers"):
        cli_main(["--task", "extrapolation", "--model", "xerte",
                  "--data_path", data, "--device", "cpu", "--timer",
                  "--set", *sets])
