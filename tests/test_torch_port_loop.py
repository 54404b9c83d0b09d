"""The port's training loop, checkpoints and rollout against the JAX package.

Both loops train on the same synthetic Water-3D trio from the same weights
(carried over by ``state_dict_from_jax_params``); each port step gets the
JAX step's MMD draw from the loop's host key.  FastEGNN, 2 layers, batch 2,
2 epochs, ``test_interval`` 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastegnn_tpu.data import simulation as jsim
from fastegnn_tpu.models import FastEGNN as JFastEGNN
from fastegnn_tpu.train import TrainState, torch_adam as jadam, train as jtrain
from fastegnn_tpu.train.rollout import make_rollout as jmake_rollout
from fastegnn_tpu.train.rollout import rollout_rebuild as jrollout_rebuild
from fastegnn_tpu.train.step import make_eval_step as jeval_step
from fastegnn_tpu_torch.data import simulation as psim
from fastegnn_tpu_torch.models.fast_egnn import FastEGNN
from fastegnn_tpu_torch.ops.neighbors import radius_graph_np
from fastegnn_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from fastegnn_tpu_torch.train.loop import step_key, train
from fastegnn_tpu_torch.train.optim import torch_adam
from fastegnn_tpu_torch.train.rollout import make_rollout, rollout_rebuild
from fastegnn_tpu_torch.train.step import make_eval_step, make_train_step
from fastegnn_tpu_torch.utils.weights import state_dict_from_jax_params

GRAV = (0.0, -1.0, 0.0)
STEP = dict(sigma=1.0, weight=0.01, sample=3, per_graph_sampling=True)
LOOP = dict(batch_size=2, test_interval=1, seed=43, verbose=False, **STEP)
# 40 particles, radius 0.15: ~140 edges per sample; 7 train samples (3
# batches), 2 valid and 2 test (1 batch each)
SIZES = dict(train=7, valid=2, test=2)
OPTS = dict(virtual_channels=3, cutoff_rate=0.25, seed=5, frames_per_trajectory=4,
            radius=0.15)


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    root = tmp_path_factory.mktemp("sim")
    psim.make_synthetic_simulation_h5(str(root / "Water-3D"), n_trajectories=2,
                                      n_particles=40, n_frames=40, seed=3)
    return str(root)


def _jax_sets(trio):
    return [jsim.SimulationDataset(trio, partition=s, max_samples=n, **OPTS)
            for s, n in SIZES.items()]


def _port_sets(trio):
    return [psim.SimulationDataset(trio, partition=s, max_samples=n, device="cpu", **OPTS)
            for s, n in SIZES.items()]


def _jax_draw(key, graph):
    """The scores the JAX step draws from the loop's host key
    (``fastegnn_tpu/train/loss.py:73``)."""
    key = jax.random.wrap_key_data(jnp.asarray(key))
    return torch.tensor(np.asarray(
        jax.random.uniform(key, (graph.n_graphs, graph.num_nodes // graph.n_graphs))))


def _recording(step, record):
    def run(*args):
        out = step(*args)
        record.append(float(out["mse"]))
        return out
    return run


def _port_train(trio, params, compute_dtype, evals, epochs=2):
    """The port's ``train`` from the JAX ``params``, each step handed the
    JAX step's draw; ``evals`` collects the MSE of every eval batch."""
    pm = FastEGNN(2, 2, hidden=64, virtual_channels=3, n_layers=2, gravity=GRAV,
                  device="cpu", compute_dtype=getattr(torch, compute_dtype))
    pm.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)))
    opt = torch_adam(pm.parameters(), 5e-4, 1e-12)
    ptrain, peval = make_train_step(pm, opt, **STEP), make_eval_step(pm, **STEP)
    pbest, plog, step = train(
        pm, opt, *_port_sets(trio), max_epochs=epochs,
        train_step_fn=lambda g, key: ptrain(g, draw=_jax_draw(key, g)),
        eval_step_fn=_recording(lambda g, key: peval(g, draw=_jax_draw(key, g)), evals),
        **LOOP)
    assert step == 3 * epochs
    return pbest, plog


def _train_both(trio, compute_dtype, fuse_edge, epochs=2):
    """JAX ``train`` and port ``train`` from the same weights; the logs and
    the eval MSE of every eval batch, in order, and the weights."""
    jsets = _jax_sets(trio)
    jm = JFastEGNN(fuse_edge=fuse_edge, compute_dtype=compute_dtype, hidden=64,
                   virtual_channels=3, n_layers=2, gravity=GRAV)
    params = jm.init(jax.random.key(0), jsets[0].collate([0, 1]))["params"]
    tx = jadam(5e-4, 1e-12)
    j_evals, p_evals = [], []
    jbest, jlog, _ = jtrain(
        jm, TrainState.create(params, tx), tx, *jsets, max_epochs=epochs,
        eval_step_fn=_recording(jeval_step(jm, **STEP), j_evals), **LOOP)
    pbest, plog = _port_train(trio, params, compute_dtype, p_evals, epochs)
    return (jbest, jlog, j_evals), (pbest, plog, p_evals), params


def _logged(log, evals):
    return np.array(log["loss_train"] + log["loss"] + evals)


# The logged MSEs are ~2e-4 here.  f32: measured 9.8e-6 relative at most
# over three data seeds.  Adam's first updates are lr * sign(g), and where
# |g| is at the rounding noise the two packages can take opposite signs, so
# two epochs drift apart a little (the one-step test in
# test_torch_port_train.py leaves those entries out); rtol 3e-5.
#
# bf16: F1's loss tolerance, rtol 2e-2 (test_torch_port_model.py), with
# atol 2e-5.  At these MSEs, a thousandth of the F1 batch's, the rounding
# of the coordinates sets the difference: the JAX bf16 pool rounds x
# (reference defect 5) where the port keeps f32.  Measured over data seeds
# 3-5: port bf16 against JAX bf16 up to 8.4e-6 absolute (3.4e-2 relative),
# port f32 against JAX bf16 up to 8.7e-6 (1.9e-2), as close.  So the JAX
# comparison alone cannot tell a bf16 run from an f32 one here (F1's model
# tests hold the bf16 arithmetic), and the bf16 case also requires the
# port's bf16 run to differ from its own f32 run on the same weights and
# draws: measured 1.1e-2 - 2.2e-2 relative at most over the same seeds, 0
# if the compute dtype were ignored; required above 2e-3.
@pytest.mark.parametrize("compute_dtype,fuse_edge,tol", [
    ("float32", None, dict(rtol=3e-5)), ("bfloat16", True, dict(rtol=2e-2, atol=2e-5))])
def test_train_tracks_the_jax_train(trio, compute_dtype, fuse_edge, tol):
    (jbest, jlog, j_evals), (pbest, plog, p_evals), params = _train_both(
        trio, compute_dtype, fuse_edge)
    assert plog["epochs"] == jlog["epochs"] == [1, 2]
    np.testing.assert_allclose(plog["loss_train"], jlog["loss_train"], **tol)
    np.testing.assert_allclose(plog["loss"], jlog["loss"], **tol)
    # valid and test, each epoch: one batch of each
    assert len(p_evals) == len(j_evals) == 4
    np.testing.assert_allclose(p_evals, j_evals, **tol)
    assert pbest["epoch_index"] == jbest["epoch_index"]
    np.testing.assert_allclose(pbest["loss_valid"], jbest["loss_valid"], **tol)
    if compute_dtype == "bfloat16":
        f32_evals = []
        _, f32_log = _port_train(trio, params, "float32", f32_evals)
        bf16, f32 = _logged(plog, p_evals), _logged(f32_log, f32_evals)
        assert (np.abs(bf16 - f32) / np.abs(f32)).max() > 2e-3


def _port_run(trio, max_epochs, init_seed=0, **kw):
    model = FastEGNN(2, 2, hidden=64, virtual_channels=3, n_layers=2, gravity=GRAV,
                     device="cpu", generator=torch.Generator().manual_seed(init_seed))
    opt = torch_adam(model.parameters(), 5e-4, 1e-12)
    best, log, step = train(model, opt, *_port_sets(trio), max_epochs=max_epochs,
                            **dict(LOOP, **kw))
    return best, log, step, model, opt


def test_resume_without_shuffle_equals_the_uninterrupted_run(trio, tmp_path):
    _port_run(trio, 1, shuffle=False, ckpt_directory=str(tmp_path))
    ck = restore_checkpoint(str(tmp_path / "best"))
    assert (ck["epoch"], ck["step"]) == (1, 3)
    _, log, step, model, opt = _port_run(trio, 3, shuffle=False)
    # another initialisation: everything the run goes on from is restored
    _, rlog, rstep, rmodel, ropt = _port_run(trio, 3, init_seed=9, shuffle=False,
                                             resume_from=str(tmp_path / "best"))
    assert rstep == step == 9 and rlog["epochs"] == [2, 3]
    assert rlog["loss_train"] == log["loss_train"][1:]
    assert rlog["loss"] == log["loss"][1:]
    for (name, a), b in zip(model.state_dict().items(), rmodel.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(opt.state_dict()["state"].values(), ropt.state_dict()["state"].values()):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_last_checkpoint_resumes_the_log_and_the_best(trio, tmp_path):
    # every run with a checkpoint directory keeps its last epoch beside the
    # best one, with the best and log dicts: resumed from it, the run logs
    # what the uninterrupted run logs
    _port_run(trio, 2, shuffle=False, ckpt_directory=str(tmp_path))
    assert restore_checkpoint(str(tmp_path / "last"))["epoch"] == 2
    best, log, step, _, _ = _port_run(trio, 3, shuffle=False)
    rbest, rlog, rstep, _, _ = _port_run(trio, 3, init_seed=9, shuffle=False,
                                         resume_from=str(tmp_path / "last"))
    assert rstep == step == 9 and rlog["epochs"] == log["epochs"] == [1, 2, 3]
    for key in ("loss_train", "loss"):
        assert rlog[key] == log[key]
    assert [t["epoch"] for t in rlog["telemetry"]] == [1, 2, 3]
    assert {k: v for k, v in rbest.items() if k != "time_cost"} == \
        {k: v for k, v in best.items() if k != "time_cost"}


def test_resume_restarts_the_shuffle_from_the_seed(trio, tmp_path):
    # the JAX loop makes its shuffle generator afresh from `seed` on resume
    # (fastegnn_tpu/train/loop.py:131), and the port keeps that: the resumed
    # epoch 2 sees the batches of an uninterrupted run's epoch 1
    def recorder(seen):
        def step(g, key):
            seen.append(g.coord[:, 0].sum().item())
            return {"mse": torch.zeros(())}
        return step

    first, resumed = [], []
    _port_run(trio, 2, train_step_fn=recorder(first), ckpt_directory=str(tmp_path))
    ck = str(tmp_path / "resume")
    save_checkpoint(ck, dict(restore_checkpoint(str(tmp_path / "best")), epoch=1))
    _port_run(trio, 2, train_step_fn=recorder(resumed), resume_from=ck)
    assert len(first) == 6 and len(resumed) == 3
    assert resumed == first[:3] and resumed != first[3:]


def test_checkpoint_round_trips_and_overwrites(tmp_path):
    model = FastEGNN(2, 2, hidden=16, virtual_channels=2, n_layers=1, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    opt = torch_adam(model.parameters(), 1e-3)
    path = str(tmp_path / "ck" / "best")
    save_checkpoint(path, {"model": {}, "step": 0})
    save_checkpoint(path, {"model": model.state_dict(), "optimizer": opt.state_dict(),
                           "step": 5, "epoch": 2})
    ck = restore_checkpoint(path, map_location="cpu")
    assert (ck["step"], ck["epoch"]) == (5, 2)
    for k, v in model.state_dict().items():
        assert torch.equal(ck["model"][k], v)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["best"]


def test_step_keys_are_the_jax_loop_keys_and_seed_the_draw():
    from fastegnn_tpu.train.loop import _step_key

    for args in [(43, 0, 1, 0), (43, 1, 10_000_002, 3), (7, 0, 2, 1)]:
        np.testing.assert_array_equal(step_key(*args), _step_key(*args))
    from fastegnn_tpu_torch.train.step import draw_sample, key_generator

    g = dataclasses.make_dataclass("G", ["n_graphs", "num_nodes", "device"])(
        2, 10, torch.device("cpu"))
    a, b, c = (draw_sample(g, True, key_generator(step_key(43, 0, e, 0), "cpu"))
               for e in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c) and a.shape == (2, 5)


@pytest.fixture(scope="module")
def rollout_case(trio):
    jds = jsim.SimulationDataset(trio, partition="test", max_samples=2, **OPTS)
    pds = psim.SimulationDataset(trio, partition="test", max_samples=2, device="cpu", **OPTS)
    jm = JFastEGNN(hidden=64, virtual_channels=3, n_layers=2, gravity=GRAV)
    params = jm.init(jax.random.key(2), jds.collate([0]))["params"]
    pm = FastEGNN(2, 2, hidden=64, virtual_channels=3, n_layers=2, gravity=GRAV, device="cpu")
    pm.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)))
    return jds, pds, jm, params, pm


# f32 over 3 steps, coordinates of size < 1: measured 2.4e-7 (make_rollout)
# and 2.1e-7 (rollout_rebuild) at most over two data seeds; 1e-5 holds both
def test_rollout_matches_jax(rollout_case):
    jds, pds, jm, params, pm = rollout_case
    jb, pb = jds.collate([0, 1]), pds.collate([0, 1])
    jtraj, jv = jmake_rollout(jm, 3)(params, jb)
    traj, v = make_rollout(pm, 3)(pb)
    mask = pb.node_mask.numpy()
    assert traj.shape == (3, pb.num_nodes, 3) and not traj.requires_grad
    np.testing.assert_allclose(traj.numpy()[:, mask], np.asarray(jtraj)[:, mask], atol=1e-5)
    np.testing.assert_allclose(v.numpy()[mask], np.asarray(jv)[mask], atol=1e-5)
    held, _ = make_rollout(pm, 2, vel_mode="hold")(pb)
    jheld, _ = jmake_rollout(jm, 2, vel_mode="hold")(params, jb)
    np.testing.assert_allclose(held.numpy()[:, mask], np.asarray(jheld)[:, mask], atol=1e-5)


def test_rollout_rebuild_matches_jax(rollout_case):
    jds, pds, jm, params, pm = rollout_case
    radius = 0.15
    # the rebuilt graphs keep every pair in the radius: room for all of them
    n = pds.graphs[0]["n_nodes"]
    jspec, spec = (dataclasses.replace(ds.spec, max_edges=n * (n - 1)) for ds in (jds, pds))
    want = jrollout_rebuild(jm, params, jds.graphs[:1], jspec, 3, 2, radius)
    got = rollout_rebuild(pm, pds.graphs[:1], spec, 3, 2, radius)
    assert got.shape == want.shape == (3, spec.max_nodes, 3)
    np.testing.assert_allclose(got[:, :n], want[:, :n], atol=1e-5)
    # the graphs were rebuilt from frames with no pair at the radius, where
    # the two packages' predicted frames (~2e-7 apart) could disagree
    for frame in (pds.graphs[0]["coord"][:n], got[1, :n]):
        d = np.linalg.norm(frame[:, None] - frame[None], axis=-1)
        assert np.abs(d - radius).min() > 1e-4
        dst, _ = radius_graph_np(frame, radius)
        assert dst.size == int(((d < radius) & (d > 0)).sum())


def test_rollout_rebuild_batches_match_jax(rollout_case, monkeypatch):
    """Each graph the rollout rebuilds is the JAX package's: the same cell
    list (pairs with 0 < d^2 < r^2 in f32, in its walk's order), so the
    same edges in the same order."""
    import fastegnn_tpu.graph as jgraph
    import fastegnn_tpu_torch.train.rollout as prollout

    jds, pds, jm, params, pm = rollout_case
    radius = 0.15
    n = pds.graphs[0]["n_nodes"]
    jspec, spec = (dataclasses.replace(ds.spec, max_edges=n * (n - 1)) for ds in (jds, pds))
    seen = {"jax": [], "port": []}
    for key, module in (("jax", jgraph), ("port", prollout)):
        def record(*args, _batch=module.batch_graphs, _seen=seen[key], **kwargs):
            _seen.append(_batch(*args, **kwargs))
            return _seen[-1]
        monkeypatch.setattr(module, "batch_graphs", record)
    jrollout_rebuild(jm, params, jds.graphs[:1], jspec, 3, 2, radius)
    rollout_rebuild(pm, pds.graphs[:1], spec, 3, 2, radius)
    assert len(seen["jax"]) == len(seen["port"]) == 2
    for k, (jb, pb) in enumerate(zip(seen["jax"], seen["port"])):
        assert pb.n_real_edges == int(np.asarray(jb.edge_mask).sum()) > 0
        for f in ("dst", "src", "edge_mask", "node_mask", "graph_id", "dst_count"):
            np.testing.assert_array_equal(getattr(pb, f).numpy(), np.asarray(getattr(jb, f)),
                                          err_msg=f)
        # the first graph is built from the same frame; the next from each
        # package's own prediction, within test_rollout_matches_jax's 1e-5
        for f in ("coord", "vel", "edge_attr", "loc_mean"):
            np.testing.assert_allclose(getattr(pb, f).numpy(), np.asarray(getattr(jb, f)),
                                       rtol=0, atol=0 if k == 0 else 1e-5, err_msg=f)
