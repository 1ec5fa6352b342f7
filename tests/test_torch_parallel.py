"""The port's multi-process path on the CPU (gloo) against the JAX
package's shard_map path on the conftest's virtual CPU mesh: the sharded
train step at meshes (2, 1), (1, 2) and (2, 2), the sharded static
evaluation and its n_tbatch rounding, a StaticTrainer epoch, the temporal
data-parallel step and evaluation, the mesh itself, the differentiable
all-reduce, torchrun's runtime and the CLI's --mesh / --distributed.

Each port run starts its ranks as fresh processes
(`redgnn_tpu_torch.parallel.launch.run_mesh`) whose bodies live in
`torch_mesh_workers.py`, which imports no JAX. Tiny sizes (30-40
entities, D=16, L=2), dropout 0."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from redgnn_tpu.graph.kg import DeviceGraph as JDeviceGraph
from redgnn_tpu.graph.kg import StaticKG as JKG
from redgnn_tpu.graph.temporal import TemporalKG as JTKG
from redgnn_tpu.models.redgnn import ModelConfig as JModelConfig
from redgnn_tpu.models.redgnn import RedGNN as JRedGNN
from redgnn_tpu.parallel import runtime as jruntime
from redgnn_tpu.parallel.mesh import make_mesh as jmake_mesh
from redgnn_tpu.parallel.shard import make_dp_train_step as jmake_step
from redgnn_tpu.train import loop as jloop
from redgnn_tpu.train import temporal_loop as jtloop
from redgnn_tpu.utils.config import TemporalTrainConfig as JTConfig
from redgnn_tpu.utils.config import TrainConfig as JConfig
from redgnn_tpu_torch.cli.train import main as cli_main
from redgnn_tpu_torch.graph import calibrate as tcal
from redgnn_tpu_torch.graph.kg import build_csr
from redgnn_tpu_torch.parallel import runtime
from redgnn_tpu_torch.parallel.launch import run_mesh
from redgnn_tpu_torch.parallel.mesh import make_mesh
from redgnn_tpu_torch.utils.port_params import (
    opt_state_from_optax,
    params_from_flax,
    temporal_opt_state_from_optax,
)

import torch_mesh_workers as W
from test_temporal import write_temporal_dir
from test_train_loop import write_kg

N_ENT, N_REL, D, L = 30, 4, 16, 2
CPUS = ["cpu"] * 4
MESHES = [(2, 1), (1, 2), (2, 2)]
STATIC = dict(hidden_dim=16, attn_dim=5, n_layer=2, dropout=0.0, lr=0.01,
              lamb=1e-5, n_batch=16, n_tbatch=16, epochs=1)
TEMPORAL = dict(hidden_dim=12, attn_dim=8, n_layer=2, dropout=0.0,
                lr=5e-3, batch_size=16, eval_batch_size=16, epochs=1,
                scan_src_backward=False)


def toy_graph(rng):
    """tests/test_parallel.py's graph: 150 random triples + self-loops."""
    h = rng.integers(0, N_ENT, 150)
    r = rng.integers(0, 2 * N_REL, 150)
    t = rng.integers(0, N_ENT, 150)
    ents = np.arange(N_ENT)
    triples = np.concatenate([np.stack([h, r, t], 1), np.stack(
        [ents, np.full(N_ENT, 2 * N_REL), ents], 1)])
    return [a.astype(np.int32) for a in build_csr(triples, N_ENT)]


def shard_caps(arrays, subs, b_local):
    """Exact caps of every contiguous shard of ``b_local`` queries (the
    same for both packages)."""
    nc, ec = tcal.per_query_counts(arrays[0], arrays[2], N_ENT,
                                   subs.astype(np.int64), L)
    return tcal.caps_for_batches(nc, ec, b_local)


@pytest.mark.parametrize("n_data,n_edge", MESHES)
def test_dp_train_step_matches_jax(rng, n_data, n_edge):
    """One sharded step (loss, updated parameters) equals JAX's
    make_dp_train_step on a mesh of the same shape within 2e-5, and the
    step's summed gradient its single-process gradient."""
    arrays = toy_graph(rng)
    b = 8
    batch = [rng.integers(0, N_ENT, b).astype(np.int32),
             rng.integers(0, 2 * N_REL, b).astype(np.int32),
             rng.integers(0, N_ENT, b).astype(np.int32), np.ones(b, bool)]
    caps = shard_caps(arrays, batch[0], b // n_data)
    assert all(e % n_edge == 0 for e in caps.edge_caps)
    jcfg = JModelConfig(n_ent=N_ENT, n_rel=N_REL, hidden_dim=D, attn_dim=5,
                        n_layer=L, dropout=0.0, act="relu")
    jgraph = JDeviceGraph(*(jnp.asarray(a) for a in arrays))
    jb = [jnp.asarray(x) for x in batch]
    key = jax.random.PRNGKey(7)
    params = JRedGNN(jcfg).init(
        {"params": key, "dropout": key}, jgraph, jb[0], jb[1], jb[3],
        tcal.FrontierCaps((b, 256, 256), (1024, 1024)), False)["params"]
    tx = jloop.make_optimizer(JConfig(lr=0.01, lamb=0.0), 10)
    mesh = jmake_mesh(n_data, n_edge)
    step = jmake_step(jcfg, tx, mesh, caps)
    new, _, jloss, jov = step(params, tx.init(params), jgraph, *jb,
                              jax.random.PRNGKey(0))
    assert int(jov) == 0

    cfg_kw = dict(n_ent=N_ENT, n_rel=N_REL, hidden_dim=D, attn_dim=5,
                  n_layer=L, dropout=0.0, act="relu")
    tparams = params_from_flax(jax.device_get(params))
    outs = run_mesh(W.static_step, n_data, n_edge, CPUS,
                    args=(arrays, cfg_kw, tparams, batch, caps, 0.01))
    grads = run_mesh(W.grad_probe, n_data, n_edge, CPUS,
                     args=(arrays, cfg_kw, tparams, batch, caps))
    want_p = params_from_flax(jax.device_get(new))
    for out in outs:
        assert not out["overflow"]
        assert abs(out["loss"] - float(jloss)) <= 2e-5 * abs(float(jloss))
        for k, v in want_p.items():
            np.testing.assert_allclose(out["params"][k].numpy(), v.numpy(),
                                       atol=2e-5, err_msg=k)
        # the replicated parameters stay bit-equal on every rank
        for k in want_p:
            assert torch.equal(out["params"][k], outs[0]["params"][k]), k
    # the gradient of the port's own single-process loss (eager JAX on the
    # whole batch, global caps)
    gcaps = shard_caps(arrays, batch[0], b)

    def loss_fn(p):
        scores, _ = JRedGNN(jcfg).apply({"params": p}, jgraph, jb[0], jb[1],
                                        jb[3], gcaps, False)
        return jloop.softmax_ce_loss(scores, jb[2], jb[3])

    want_g = params_from_flax(jax.device_get(jax.grad(loss_fn)(params)))
    for k, v in want_g.items():
        for g in grads:
            np.testing.assert_allclose(
                g["grads"][k].numpy(), v.numpy(), rtol=1e-4,
                atol=2e-5 * max(1.0, float(v.abs().max())), err_msg=k)


@pytest.fixture
def kg_dir(tmp_path, rng):
    d = tmp_path / "kg"
    d.mkdir()
    return str(write_kg(d, rng))


def _static_state(jt):
    adam = jax.device_get(jt.opt_state[1])
    return {"params": params_from_flax(jax.device_get(jt.params)),
            "opt_state": opt_state_from_optax(adam.mu, adam.nu, adam.count)}


@pytest.mark.parametrize("n_data,n_edge,n_tbatch", [(2, 2, 16), (2, 1, 13)])
def test_static_eval_sharded_matches_jax(kg_dir, n_data, n_edge, n_tbatch):
    """The sharded static evaluation (metric sums summed over the mesh)
    equals JAX's shard_map evaluation on a mesh of the same shape; an
    n_tbatch that the data axis does not divide is rounded up alike."""
    cfg = dict(STATIC, n_tbatch=n_tbatch)
    jt = jloop.StaticTrainer(JKG.load(kg_dir), JConfig(**cfg),
                             mesh=jmake_mesh(n_data, n_edge))
    want = {s: jt.evaluate(s) for s in ("valid", "test")}
    out = run_mesh(W.static_trainer, n_data, n_edge, CPUS,
                   args=(kg_dir, cfg, _static_state(jt), ("valid", "test")))
    for o in out:
        assert o["n_tbatch"] == jt.n_tbatch == -(-n_tbatch // n_data) * n_data
        for s in want:
            for k in ("mrr", "h1", "h3", "h10", "n"):
                np.testing.assert_allclose(o["metrics"][s][k], want[s][k],
                                           rtol=1e-5, err_msg=f"{s}:{k}")


def test_static_trainer_epoch_matches_jax(kg_dir):
    """StaticTrainer(mesh=(2, 2)) — the CLI's path — trains an epoch to
    the JAX trainer's loss and parameters on the same mesh shape, with
    per-shard caps."""
    jt = jloop.StaticTrainer(JKG.load(kg_dir), JConfig(**STATIC),
                             mesh=jmake_mesh(2, 2))
    state = _static_state(jt)
    want = jt.train_epoch(0)
    out = run_mesh(W.static_trainer, 2, 2, CPUS,
                   args=(kg_dir, STATIC, state, (), 1))
    assert out[0]["caps"].node_caps[0] == STATIC["n_batch"] // 2
    np.testing.assert_allclose(out[0]["losses"][0], want, rtol=1e-5)
    for k, v in params_from_flax(jax.device_get(jt.params)).items():
        np.testing.assert_allclose(out[0]["params"][k].numpy(), v.numpy(),
                                   atol=1e-4, err_msg=k)
        for o in out[1:]:
            assert torch.equal(o["params"][k], out[0]["params"][k]), k


@pytest.mark.parametrize("mode", ["interpolation", "extrapolation"])
def test_temporal_dp_matches_jax(tmp_path, rng, mode):
    """TemporalTrainer(mesh=(2, 1)): one step (global-mean NLL, replicated
    leave-one-out exclusion) and evaluate('valid') (interpolation raw,
    extrapolation raw / fil / fil_t) equal the JAX trainer's on a (2, 1)
    mesh."""
    d = str(write_temporal_dir(tmp_path, rng))
    cfg = dict(TEMPORAL, mode=mode)
    if mode == "extrapolation":
        cfg["window"] = 6
    jt = jtloop.TemporalTrainer(JTKG.load_vocab_dir(d), JTConfig(**cfg),
                                mesh=jmake_mesh(2, 1))
    state = {"params": params_from_flax(jax.device_get(jt.params)),
             "opt_state": temporal_opt_state_from_optax(
                 serialization.to_state_dict(jax.device_get(jt.opt_state)))}
    want_m = jt.evaluate("valid")
    b = cfg["batch_size"]
    rows = np.arange(b)
    data = jt.kg.splits["train"][rows]
    caps = jt._get_caps("train", data, jt._cap_b(b))
    excl = jt.kg.exclusion_slots(rows) if mode == "interpolation" else None
    p, _, jl, jov, jbad = jax.jit(jt._train_step_impl,
                                  static_argnames=("caps",))(
        jt.params, jt.opt_state, jt._kgarrs,
        *(jnp.asarray(data[:, j], jnp.int32) for j in range(4)),
        jnp.ones(b, bool),
        None if excl is None else jnp.asarray(excl, jnp.int32),
        jax.random.PRNGKey(3), caps)
    out = run_mesh(W.temporal_trainer, 2, 1, CPUS,
                   args=(d, cfg, state, rows))
    for o in out:
        assert o["cap0"] == b // 2 == caps.node_caps[0]
        assert not o["overflow"] and not o["bad"] and not bool(jov)
        np.testing.assert_allclose(o["loss"], float(jl), rtol=1e-5)
        for k, v in params_from_flax(jax.device_get(p)).items():
            np.testing.assert_allclose(o["params"][k].numpy(), v.numpy(),
                                       atol=2e-5, err_msg=k)
        keys = (("mrr", "h1", "h10", "n", "loss") if mode == "interpolation"
                else ("raw_mrr", "fil_mrr", "fil_t_mrr", "found_rate", "n"))
        for k in keys:
            np.testing.assert_allclose(o["metrics"][k], want_m[k],
                                       rtol=1e-5, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------- the mesh

@pytest.mark.parametrize("n_data,n_edge", MESHES)
def test_all_reduce_sum_backward_is_sum(n_data, n_edge):
    """The differentiable all-reduce under gloo: its value is the group's
    sum and its backward sums the cotangents over the group."""
    axis = "edge" if n_edge > 1 else "data"
    out = run_mesh(W.all_reduce_grad, n_data, n_edge, CPUS, args=(axis,))
    x = np.arange(4, dtype=np.float32)
    for rank, o in enumerate(out):
        group = [r for r in range(n_data * n_edge)
                 if all(out[r]["coords"][a] == o["coords"][a]
                        for a in ("data", "edge") if a != axis)]
        s = sum(r + 1 for r in group)
        np.testing.assert_array_equal(o["out"].numpy(), s * x)
        np.testing.assert_array_equal(o["grad"].numpy(),
                                      np.full(4, (rank + 1) * s, np.float32))


def test_mesh_layout_and_refusals():
    """Ranks lie edge-major within a data row, as jax.make_mesh lays
    devices out; too few devices and two NCCL ranks on one card raise."""
    out = run_mesh(W.mesh_coords, 2, 2, CPUS)
    assert [o["coords"] for o in out] == [
        {"data": d, "edge": e} for d in range(2) for e in range(2)]
    jm = jmake_mesh(2, 2)
    ids = np.vectorize(lambda dv: dv.id)(jm.devices)
    assert [int(ids[o["coords"]["data"], o["coords"]["edge"]]) for o in out] \
        == [o["rank"] for o in out]
    with pytest.raises(ValueError, match="needs 4 devices, have 3"):
        make_mesh(2, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        make_mesh(1, 2, devices=["cuda:0", "cuda:0"], backend="nccl")


def test_hung_rank_fails_fast():
    """A rank that never joins a collective makes the others fail within
    the collective timeout, and run_mesh ends every process."""
    t0 = time.monotonic()
    with pytest.raises(Exception):
        run_mesh(W.skip_collective, 1, 2, CPUS, timeout=60,
                 collective_timeout=3)
    assert time.monotonic() - t0 < 45


def test_initialize_distributed_single_process(monkeypatch, capsys):
    """Without torchrun's environment --distributed stays single-process,
    with the JAX package's warning and summary dict;
    default_mesh_shape is the JAX package's."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    info = runtime.initialize_distributed(device="cpu")
    assert "no coordinator environment found" in capsys.readouterr().out
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert info["local_devices"] >= 1
    assert info["global_devices"] >= info["local_devices"]
    for n in (1, 2, 3, 4, 6, 8, 16):
        assert runtime.default_mesh_shape(n) == \
            jruntime.default_mesh_shape(n)


# ----------------------------------------------------------------- the CLI

CLI_SET = ["hidden_dim=16", "n_layer=2", "n_batch=16", "n_tbatch=16",
           "dropout=0.0"]


def test_cli_mesh_cpu(kg_dir, tmp_path, capfd):
    """--mesh 2x2 --device cpu starts 4 gloo workers; rank 0 alone prints
    the config echo and BEST, and writes the checkpoints and reports; the
    epoch's loss equals a single-process run's."""
    res, ck = str(tmp_path / "res"), str(tmp_path / "ck")
    argv = ["--task", "transductive", "--data_path", kg_dir, "--device",
            "cpu", "--epochs", "1", "--results_dir", res, "--set", *CLI_SET]
    cli_main(argv + ["--mesh", "2x2", "--ckpt_dir", ck])
    out = capfd.readouterr().out.strip().splitlines()
    assert sum(ln.startswith("BEST ") for ln in out) == 1
    assert sum(ln.startswith("{") for ln in out) == 1  # one config echo
    best = json.loads(out[-1][len("BEST "):])
    assert "latest.pt" in os.listdir(ck)
    assert os.path.exists(os.path.join(res, "kg_perf.txt"))
    cli_main(argv)
    single = json.loads(capfd.readouterr().out.strip().splitlines()[-1][5:])
    np.testing.assert_allclose(best["loss"], single["loss"], rtol=1e-4)


def test_cli_mesh_refusals(kg_dir, tmp_path):
    """The JAX package's refusals (a non-redgnn model, E > 1 on a temporal
    task), and a host with fewer GPUs than ranks exits with its reason."""
    base = ["--data_path", kg_dir, "--results_dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="redgnn model only"):
        cli_main(base + ["--task", "extrapolation", "--model", "simple",
                         "--mesh", "2"])
    with pytest.raises(SystemExit, match="data axis only"):
        cli_main(base + ["--task", "interpolation", "--mesh", "2x2"])
    if torch.cuda.device_count() < 64:
        with pytest.raises(SystemExit, match="needs 64 GPUs"):
            cli_main(base + ["--task", "transductive", "--mesh", "64"])


def test_cli_temporal_mesh_and_distributed(tmp_path, rng, capfd,
                                           monkeypatch):
    """--mesh 2 on a temporal task (data axis), and --distributed with no
    torchrun environment (single process, with the warning)."""
    d = str(write_temporal_dir(tmp_path, rng))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    sets = ["hidden_dim=8", "attn_dim=6", "n_layer=2", "batch_size=16",
            "eval_batch_size=16", "max_train_batches=2",
            "max_eval_batches=2", "dropout=0.0"]
    base = ["--task", "interpolation", "--data_path", d, "--device", "cpu",
            "--epochs", "1", "--results_dir", str(tmp_path / "r"), "--set",
            *sets]
    cli_main(base + ["--mesh", "2"])
    mesh_out = capfd.readouterr().out.strip().splitlines()
    assert mesh_out[0].startswith("mesh: 2 data x 1 edge")
    cli_main(base + ["--distributed"])
    out = capfd.readouterr().out
    assert "no coordinator environment found" in out
    single = json.loads(out.strip().splitlines()[-1][5:])
    meshed = json.loads(mesh_out[-1][5:])
    np.testing.assert_allclose(meshed["loss"], single["loss"], rtol=1e-4)
