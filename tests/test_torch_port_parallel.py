"""The port's data parallelism (``fastegnn_tpu_torch/parallel``) on the CPU,
as ``tests/test_parallel.py`` and ``tests/test_cli_mesh.py`` hold the JAX
package's: a spawned 2-process gloo group runs the data-parallel steps on
the two halves of a global batch (``torch_dp_worker.py``), which must match
the JAX one-device step on the whole batch; the N-body CLI under
``torchrun --nproc_per_node 2 ... --mesh data=2`` must train as it does in
one process; and the port's ``--mesh`` parser is the JAX one."""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from fastegnn_tpu.cli.common import parse_mesh as jparse_mesh
from fastegnn_tpu.graph import GraphSpec as JSpec, batch_graphs as jbatch, pad_graph as jpad
from fastegnn_tpu.models import FastEGNN as JFastEGNN
from fastegnn_tpu.train import TrainState, torch_adam as jadam
from fastegnn_tpu.train.step import make_eval_step as jeval, make_loss_fn as jloss_fn
from fastegnn_tpu.train.step import make_train_step as jstep
from fastegnn_tpu_torch.cli import generate_nbody as pgen
from fastegnn_tpu_torch.cli import nbody as pnbody
from fastegnn_tpu_torch.cli.common import check_mesh, parse_mesh
from fastegnn_tpu_torch.parallel import rank_key
from fastegnn_tpu_torch.utils.weights import state_dict_from_jax_params

import torch_dp_worker
from helpers import random_raw_graph

REPO = Path(__file__).resolve().parent.parent
HIDDEN, LAYERS, LR = 16, 2, 1e-3
N_GRAPHS, N_NODES = 4, 6
SPEC = dict(max_nodes=N_NODES, max_edges=N_NODES * (N_NODES - 1), edge_attr_dim=2,
            virtual_channels=3)
JOIN_S = 120


@pytest.mark.parametrize("spec", [None, "", "data=1", "graph=1", "graph=1,data=1", "data=2",
                                  "graph=4", "data=2,graph=4", "tensor=2", "data=0"])
def test_parse_mesh_is_the_jax_parser(spec):
    if spec in ("tensor=2", "data=0"):
        for parser in (parse_mesh, jparse_mesh):
            with pytest.raises(ValueError):
                parser(spec)
    else:
        assert parse_mesh(spec) == jparse_mesh(spec)


@pytest.mark.parametrize("mesh,model,batch,env,device,match", [
    ("data=3", "FastEGNN", 2, "2", "cpu", "must divide by the data axis 3"),
    ("data=2", "DimeNet", 2, "2", "cpu", "custom step"),
    ("data=2", "DimeNet++", 2, "2", "cpu", "custom step"),
    ("data=2", "EGHN", 2, "2", "cpu", "custom step"),
    ("graph=2", "FastEGNN", 2, "2", "cpu", None),
    ("data=2,graph=2", "FastEGNN", 4, "4", "cpu", None),
    ("data=2", "FastEGNN", 2, None, "cpu", "torchrun --standalone --nproc_per_node 2"),
    ("data=2", "FastEGNN", 2, "3", "cpu", "WORLD_SIZE is 3"),
    ("data=2", "FastEGNN", 2, "2", "cuda", "needs 2 devices, have 1"),
    ("data=2", "FastEGNN", 2, "2", "cpu", None),
    ("data=1,graph=1", "EGHN", 3, None, "cpu", None),
])
def test_mesh_checks_come_before_any_process_group(monkeypatch, mesh, model, batch, env,
                                                   device, match):
    # what the JAX CLI refuses, then D processes on D devices; never one
    # process when D > 1 was asked for
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    if env is not None:
        monkeypatch.setenv("WORLD_SIZE", env)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = argparse.Namespace(mesh=mesh, model=model, batch_size=batch, attention_required=False,
                              tanh_required=False, direction_vector_normalize_required=False)
    if match is None:
        assert check_mesh(args, torch.device(device)) == parse_mesh(mesh)
    else:
        with pytest.raises(ValueError, match=match):
            check_mesh(args, torch.device(device))
    assert not torch.distributed.is_initialized()


def test_rank_key_leaves_rank_0_alone_and_mixes_the_others():
    key = np.array([7, 9], np.uint32)
    assert (rank_key(key, 0) == key).all()
    others = [tuple(rank_key(key, r)) for r in (1, 2)]
    assert len({tuple(key), *others}) == 3
    assert others == [tuple(rank_key(key, r)) for r in (1, 2)]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The JAX reference on the global batch, and the two ranks' results."""
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    raws = [random_raw_graph(rng, N_NODES) for _ in range(N_GRAPHS)]
    js = JSpec(**SPEC, n_graphs=N_GRAPHS)
    jb = jbatch([jpad(js, **r) for r in raws], js)
    jm = JFastEGNN(hidden=HIDDEN, virtual_channels=3, n_layers=LAYERS, fuse_edge=False)
    params = jax.jit(jm.init)(jax.random.key(0), jb)["params"]
    key = jax.random.key(1)
    tx = jadam(LR)
    state, metrics = jstep(jm, tx, use_mmd=False, donate=False)(
        TrainState.create(params, tx), jb, key)
    grads = jax.jit(jax.grad(
        lambda p: jloss_fn(jm, 1.5, 0.01, 3, False, False)(p, jb, key)[0]))(params)
    ref = dict(params=state.params, metrics=metrics, grads=grads,
               eval=jeval(jm, use_mmd=False)(params, jb, key), raws=raws)

    inputs = dict(raws=raws, spec=SPEC, hidden=HIDDEN, n_layers=LAYERS, lr=LR,
                  state_dict=state_dict_from_jax_params(jax.tree.map(np.asarray, params)))
    torch.save(inputs, tmp / "inputs.pt")
    ctx = mp.start_processes(torch_dp_worker.run,
                             args=(str(tmp / "store"), str(tmp / "inputs.pt"), str(tmp)),
                             nprocs=torch_dp_worker.N_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, f"the ranks did not end in {JOIN_S} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(torch_dp_worker.N_RANKS)]
    return ref, ranks


def _as_port(tree):
    """A JAX param tree (or its gradient) in the port's state-dict layout."""
    return {k: v.numpy() for k, v in
            state_dict_from_jax_params(jax.tree.map(np.asarray, tree)).items()}


def test_meshes_have_their_shapes_and_names(dp):
    for out in dp[1]:
        assert out["meshes"] == {"data": ((2,), ("data",)),
                                 "hybrid": ((1, 2), ("data", "graph")),
                                 "hybrid n_outer=2": ((2, 1), ("data", "graph"))}


def test_each_rank_collates_its_contiguous_half(dp):
    ref, ranks = dp
    per = N_GRAPHS // len(ranks)
    for r, out in enumerate(ranks):
        (n_graphs, coord), = out["sub_batches"]
        want = np.concatenate([g["coord"] for g in ref["raws"][r * per:(r + 1) * per]])
        assert n_graphs == per
        np.testing.assert_array_equal(coord, want)


def test_dp_train_step_matches_the_jax_step_on_the_global_batch(dp):
    ref, ranks = dp
    for out in ranks:
        for k in ("loss", "mse"):
            np.testing.assert_allclose(out["train"][k], float(ref["metrics"][k]), rtol=1e-5)
        # Adam's first update is ~lr * sign(g): where |g| < 1e-6 the two
        # packages' last-bit gradient differences can flip it, so those
        # entries are left out (as in test_torch_port_train.py)
        want, grads = _as_port(ref["params"]), _as_port(ref["grads"])
        assert out["params"].keys() == want.keys()
        for name, a in out["params"].items():
            keep = np.abs(grads[name]) >= 1e-6
            np.testing.assert_allclose(a[keep], want[name][keep], atol=1e-6, rtol=0,
                                       err_msg=name)


def test_dp_gradient_is_the_jax_gradient_of_the_global_batch(dp):
    # the mean of the two halves' gradients, before Adam (whose update
    # hardly moves when a gradient is scaled)
    ref, ranks = dp
    want = _as_port(ref["grads"])
    for out in ranks:
        assert out["grads"].keys() <= want.keys()
        for name, g in out["grads"].items():
            np.testing.assert_allclose(g, want[name], rtol=1e-4,
                                       atol=1e-6 * np.abs(want[name]).max(), err_msg=name)


def test_dp_eval_step_matches_the_jax_eval_step(dp):
    ref, ranks = dp
    for out in ranks:
        for k in ("loss", "mse"):
            np.testing.assert_allclose(out["eval"][k], float(ref["eval"][k]), rtol=1e-5)


def test_the_ranks_hold_equal_parameters(dp):
    a, b = dp[1]
    for key in ("params", "params_mmd"):
        assert a[key].keys() == b[key].keys()
        for name in a[key]:
            np.testing.assert_array_equal(a[key][name], b[key][name], err_msg=name)


def test_dp_with_mmd_is_finite_and_draws_an_mmd(dp):
    for out in dp[1]:
        for m in out["train_mmd"]:
            assert all(np.isfinite(v) for v in m.values())
            assert m["mmd"] != 0.0


def test_one_rank_with_mmd_is_the_plain_step(dp):
    for out in dp[1]:
        assert out["d1"] == out["plain"]
        assert out["d1"][0]["mmd"] != 0.0
        for name, v in out["plain_params"].items():
            np.testing.assert_array_equal(out["d1_params"][name], v, err_msg=name)



def test_the_ranks_decide_the_early_stop_on_rank_0s_losses(dp):
    # rank 1's valid loss of epoch 2 lies one ulp below rank 0's: alone it
    # would improve there and go on to epoch 3, while rank 0 stops
    for out in dp[1]:
        assert out["early_stop"] == {"early_stop": 2, "epoch_index": 1, "loss_valid": 1.0}


# --- the N-body CLI under torchrun -------------------------------------------

TRAIN = ["--virtual_channel", "3", "--batch_size", "2", "--num_layer", "2",
         "--max_epochs", "2", "--test_interval", "1", "--platform", "cpu", "--weight", "0"]


@pytest.fixture(scope="module")
def nbody_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("nbody")
    name = pgen.main(["--path", str(root), "--n_isolated", "5", "--num-train", "4",
                      "--num-valid", "2", "--num-test", "2", "--length", "410",
                      "--sample-freq", "10", "--seed", "0"])
    return ["--data_directory", str(root), "--dataset_name", name]


def _log(directory):
    logs = list(directory.glob("*_loss_*.json"))
    assert len(logs) == 1, logs
    return json.loads(logs[0].read_text())


def test_cli_under_torchrun_trains_as_in_one_process(nbody_data, tmp_path):
    common = [*nbody_data, *TRAIN]
    pnbody.main(common + ["--log_directory", str(tmp_path / "one")])
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "fastegnn_tpu_torch.cli.nbody", *common, "--mesh", "data=2",
         "--log_directory", str(tmp_path / "dp"), "--ckpt_directory", str(tmp_path / "ck")],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "mesh training: data=2" in run.stdout
    # rank 0 alone writes the log
    (best_one, log_one), (best_dp, log_dp) = _log(tmp_path / "one"), _log(tmp_path / "dp")
    assert log_dp["epochs"] == log_one["epochs"] == [1, 2]
    for a, b in ((log_dp["loss_train"], log_one["loss_train"]), (log_dp["loss"], log_one["loss"]),
                 (best_dp["loss_valid"], best_one["loss_valid"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    # its checkpoint is the one-process kind: it resumes in one process
    best = pnbody.main(common + ["--max_epochs", "3", "--resume", str(tmp_path / "ck" / "best"),
                                 "--log_directory", str(tmp_path / "resumed")])
    assert np.isfinite(best["loss_valid"])
    assert _log(tmp_path / "resumed")[1]["epochs"][-1] == 3
