"""The port's XErteTrainer vs the JAX package's on the CPU: steps with
clipping and MultiSteps, the overflow replay, evaluation and `.msgpack`
restores. The trainers draw nothing from the sampler's RNG here ('first'
and 'last' sampling): the JAX trainer's draws come from `jax.random`
inside its jitted step, which torch cannot replay."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from redgnn_tpu.models import xerte as jx
from redgnn_tpu.train.xerte_loop import XErteTrainer as JTrainer
from redgnn_tpu.utils.checkpoint import save_checkpoint as jsave
from redgnn_tpu_torch.models import xerte as tx
from redgnn_tpu_torch.train.xerte_loop import XErteTrainer
from redgnn_tpu_torch.utils.port_params import (
    params_from_flax,
    temporal_opt_state_from_optax,
)

from test_torch_xerte import deterministic, kgs, small_cfg  # noqa: F401


def trainer_pair(jkg, kg, lr=1e-3, **kw):
    """(JAX trainer, port trainer continuing from its parameters and
    optimizer state)."""
    tkw = {k: kw.pop(k) for k in ("batch_size", "grad_clip",
                                  "grad_accum_steps", "max_train_batches",
                                  "max_eval_batches") if k in kw}
    jt = JTrainer(jkg, small_cfg(jkg, jx, **kw), lr=lr, **tkw)
    pt = XErteTrainer(kg, small_cfg(kg, tx, **kw), lr=lr, device="cpu",
                      **tkw)
    pt.load_state({
        "params": params_from_flax(jax.device_get(jt.params)),
        "opt_state": temporal_opt_state_from_optax(
            serialization.to_state_dict(jax.device_get(jt.opt_state)), lr)})
    return jt, pt


def assert_state_close(pt, jt, atol, state_rel=None):
    """Parameters within ``atol``; every optimizer leaf within ``atol``,
    or with ``state_rel`` within ``state_rel`` times that leaf's largest
    magnitude (a step clipped at 1e-3 leaves mu <= 1e-4 and nu <= 1e-9,
    which an absolute bound would not see). Returns JAX's optimizer
    state."""
    want = temporal_opt_state_from_optax(
        serialization.to_state_dict(jax.device_get(jt.opt_state)), pt.lr)
    got = pt.state()
    for k, v in params_from_flax(jax.device_get(jt.params)).items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                   rtol=0, atol=atol, err_msg=k)
    for group in ("mu", "nu", "acc_grads"):
        for k, v in want.get(group, {}).items():
            w = v.numpy()
            tol = atol if state_rel is None else (
                state_rel * float(np.abs(w).max()))
            np.testing.assert_allclose(got["opt_state"][group][k].numpy(),
                                       w, rtol=0, atol=tol,
                                       err_msg=f"{group}/{k}")
    for k in ("count", "mini_step", "gradient_step"):
        if k in want:
            assert int(got["opt_state"][k]) == int(want[k]), k
    return want


@pytest.mark.parametrize("opt", [
    dict(grad_clip=1e-3), dict(grad_clip=1e-3, grad_accum_steps=2),
    dict(grad_clip=0.0)], ids=["clip", "clip_multisteps", "no_clip"])
def test_train_step_matches_jax(kgs, opt):
    """One update from the same state (the clip active at 1e-3; under
    MultiSteps(2) two calls make one update): loss and parameters within
    2e-5, every optimizer leaf within 2e-5 of its largest magnitude, and
    with the clip the first moment's global norm (1 - b1) * grad_clip in
    both packages: the clipped gradient's norm."""
    jkg, kg = kgs
    jt, pt = trainer_pair(jkg, kg, batch_size=8, sampling="first", **opt)
    qm = np.ones(8, bool)
    calls = opt.get("grad_accum_steps", 1)
    for step in range(1, calls + 1):
        batch = kg.splits["train"][8 * step:8 * step + 8]
        cols = [batch[:, j].astype(np.int32) for j in range(4)]
        jt.params, jt.opt_state, jloss, jov = jt._train_step(
            jt.params, jt.opt_state, jt._kgarrs,
            *(jnp.asarray(c) for c in cols), jnp.asarray(qm),
            jnp.int32(step))
        loss, ov = pt._train_step(*(torch.tensor(c) for c in cols),
                                  torch.tensor(qm), step)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)
        assert bool(ov) == bool(jov)
    want = assert_state_close(pt, jt, atol=2e-5, state_rel=2e-5)
    assert int(pt.opt_state["count"]) == 1
    if opt["grad_clip"]:
        for mu in (pt.state()["opt_state"]["mu"], want["mu"]):
            norm = float(torch.sqrt(sum(torch.sum(v.double() ** 2)
                                        for v in mu.values())))
            np.testing.assert_allclose(norm, 0.1 * opt["grad_clip"],
                                       rtol=1e-5)


def test_overflow_replay_matches_jax(kgs, capsys):
    """A configuration whose visited set overflows (the JAX package's
    test_xerte_overflow_grows_caps with 3 attended edges, not 2, and
    'first' sampling): the epoch replays from a snapshot that the port's
    in-place updates did not touch, with the cap factor doubled. The
    replayed epoch is bit-equal to a straight run at the final cap
    factor, and the replay sequence, step counter, loss, parameters,
    optimizer state and then the evaluation's metrics equal JAX's. (With
    2 attended edges the float32 gradients of both packages lie 2-4e-6
    off a float64 run, ~5e-4 of the largest, and Adam's first steps turn
    such errors on gradients near zero into updates of up to lr: the
    packages drift apart by up to 2e-3 in 4 steps.)"""
    jkg, kg = kgs
    mkw = dict(emb_dim=(16, 8, 8), dp_steps=2, dp_num_edges=8,
               max_attended_edges=3, sampling="first")
    tkw = dict(batch_size=16, max_train_batches=4)
    jt, pt = trainer_pair(jkg, kg, **mkw, **tkw)
    straight = XErteTrainer(kg, small_cfg(kg, tx, cap_factor=2.0, **mkw),
                            device="cpu", **tkw)
    straight.load_state(pt.state())
    jloss = jt.train_epoch(0)
    j_out = capsys.readouterr().out
    loss = pt.train_epoch(0)
    assert capsys.readouterr().out == j_out
    assert "overflow" in j_out and jt.cfg.cap_factor == 2.0
    assert pt.cfg.cap_factor == pt.model.cfg.cap_factor == 2.0
    assert pt._step_counter == jt._step_counter == 4
    assert straight.train_epoch(0) == loss
    assert capsys.readouterr().out == ""
    assert torch.equal(straight._flat, pt._flat)
    np.testing.assert_allclose(loss, jloss, rtol=2e-5)
    assert_state_close(pt, jt, atol=2e-5)
    jm, m = jt.evaluate("valid"), pt.evaluate("valid")
    assert m.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", [dict(sampling="last"),
                                  dict(sampling="first", time_bound="query",
                                       node_score_aggregation="max")],
                         ids=["last", "first-query-max"])
def test_evaluate_matches_jax(kgs, case):
    """Raw / filtered / time-filtered metrics, found rate and loss within
    rtol 1e-5, over batches with padding (60 queries, batch 8)."""
    jkg, kg = kgs
    jt, pt = trainer_pair(jkg, kg, batch_size=8, **case)
    jm, m = jt.evaluate("test"), pt.evaluate("test")
    assert list(m) == list(jm)
    for k in jm:
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, err_msg=k)
    assert 0 < m["found_rate"] <= 1 and m["n"] == len(kg.splits["test"])


@pytest.mark.parametrize("accum", [1, 2])
def test_restore_jax_msgpack_checkpoint(kgs, tmp_path, accum):
    """A checkpoint the JAX XErteTrainer wrote (flax msgpack + host
    sidecar) restores into the port: parameters, every optimizer leaf,
    numpy rng, step counter and cap factor; the port's own .pt round
    trip; another optimizer structure raises."""
    jkg, kg = kgs
    jt = JTrainer(jkg, small_cfg(jkg, jx), batch_size=8,
                  grad_accum_steps=accum)
    key = iter(jax.random.split(jax.random.PRNGKey(5), 200))
    jt.opt_state = jax.tree_util.tree_map(
        lambda x: (jax.random.uniform(next(key), x.shape, x.dtype)
                   if jnp.issubdtype(x.dtype, jnp.floating) else x + 3),
        jt.opt_state)
    jt._step_counter = 7
    jt._np_rng.permutation(5)
    jt._grow_caps()
    path = jsave(str(tmp_path / "jck"), jt.state(), 4, 0.5,
                 host=jt.host_state())
    pt = XErteTrainer(kg, small_cfg(kg, tx), batch_size=8,
                      grad_accum_steps=accum, device="cpu")
    assert pt.restore(path) == 4
    assert_state_close(pt, jt, atol=0)
    assert pt._step_counter == 7 and pt.cfg.cap_factor == 2.0
    assert pt.model.cfg.cap_factor == 2.0
    assert pt._np_rng.bit_generator.state == jt._np_rng.bit_generator.state
    assert float(pt.opt_state["lr"]) == np.float32(1e-3)

    saved = pt.save(str(tmp_path / "pck"), 5, 0.25)
    again = XErteTrainer(kg, small_cfg(kg, tx), grad_accum_steps=accum,
                         device="cpu")
    assert again.restore(saved) == 5
    assert torch.equal(again._flat, pt._flat)
    assert again._step_counter == 7 and again.cfg.cap_factor == 2.0
    wrong = XErteTrainer(kg, small_cfg(kg, tx), grad_accum_steps=3 - accum,
                         device="cpu")
    with pytest.raises(RuntimeError, match="does not match"):
        wrong.restore(path)
