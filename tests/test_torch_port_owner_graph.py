"""The port's owner-sharded graph parallelism
(``fastegnn_tpu_torch/parallel/owner_graph.py``) against the JAX package's
(``fastegnn_tpu/parallel/owner_graph.py``), as ``tests/test_graph_parallel.py``
and ``tests/test_cli_mesh.py`` hold the JAX one.

The host partitioner must give the JAX arrays exactly; a spawned 4-process
gloo group (``torch_gp_worker.py``) runs the G = 4 forward, two train steps
on the JAX step's MMD draws and two ``data=2,graph=2`` steps, held against
the JAX functions on 4 virtual CPU devices; the N-body CLI under ``torchrun
--nproc_per_node 2 ... --mesh graph=2`` must train as it does in one
process.  The inputs are ``test_graph_parallel.py::_spatial_batch``'s
graphs (x-sorted radius graphs), and a batch of three padded graphs, apart
in space, whose boundaries fall inside the shards.
"""

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
from jax.sharding import Mesh

from fastegnn_tpu.graph import GraphSpec as JSpec, batch_graphs as jbatch, pad_graph as jpad
from fastegnn_tpu.models import FastEGNN as JFastEGNN
from fastegnn_tpu.parallel import owner_graph as jog
from fastegnn_tpu.train import TrainState, torch_adam as jadam
from fastegnn_tpu.train.step import make_loss_fn as jloss_fn
from fastegnn_tpu_torch.cli import generate_nbody as pgen
from fastegnn_tpu_torch.cli import nbody as pnbody
from fastegnn_tpu_torch.cli.common import check_mesh
from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph
from fastegnn_tpu_torch.models.fastegnn_core import (
    LayerCfg, per_graph_pool, per_graph_take, virtual_and_node_update)
from fastegnn_tpu_torch.models.fast_egnn import FastEGNN
from fastegnn_tpu_torch.ops.neighbors import radius_graph_np
from fastegnn_tpu_torch.parallel import (
    OwnerBatchFactory,
    OwnerCapacityError,
    halo_pair_rows,
    make_owner_sharded_batch,
)
from fastegnn_tpu_torch.train.loop import step_key
from fastegnn_tpu_torch.utils.weights import state_dict_from_jax_params

import torch_gp_worker
from test_graph_parallel import _spatial_batch

REPO = Path(__file__).resolve().parent.parent
G, HIDDEN, LAYERS = 4, 64, 2
GRAV = (0.0, 0.0, -0.1)
ADAM = (5e-4, 1e-12)
JOIN_S = 120


def _spatial_raw(n=256, seed=0, radius=0.22, shift=0.0):
    """The raw arrays of ``_spatial_batch(n, seed, radius)``'s graph,
    moved by ``shift`` along x."""
    rng = np.random.default_rng(seed)
    loc = rng.random((n, 3)).astype(np.float32)
    loc = loc[np.argsort(loc[:, 0], kind="stable")] + np.float32(shift) * np.eye(3, dtype=np.float32)[0]
    vel = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    dst, src = radius_graph_np(loc, radius)
    o = np.argsort(dst, kind="stable")
    dst, src = dst[o].astype(np.int32), src[o].astype(np.int32)
    d0 = np.linalg.norm(loc[dst] - loc[src], axis=1, keepdims=True)
    return dict(node_feat=np.concatenate([np.linalg.norm(vel, axis=1, keepdims=True),
                                          np.ones((n, 1), np.float32)], axis=1),
                coord=loc, vel=vel, dst=dst, src=src,
                edge_attr=np.concatenate([d0, d0], 1).astype(np.float32),
                coord_target=loc + vel)


def _case(raws, max_nodes=None):
    """``{raws, spec}`` of one batch: every graph padded to ``max_nodes``."""
    spec = dict(max_nodes=max_nodes or raws[0]["coord"].shape[0],
                max_edges=max(r["dst"].size for r in raws), edge_attr_dim=2,
                virtual_channels=3)
    return dict(raws=raws, spec=spec)


def _jax_batch(case):
    spec = JSpec(**case["spec"], n_graphs=len(case["raws"]))
    return jbatch([jpad(spec, **r) for r in case["raws"]], spec, edge_align=256)


def _port_batch(case):
    spec = GraphSpec(**case["spec"], n_graphs=len(case["raws"]))
    return batch_graphs([pad_graph(spec, **r) for r in case["raws"]], spec, edge_align=256,
                        device="cpu")


FORWARD = _case([_spatial_raw()])
# three 80-node graphs padded to 88 nodes: the shards' 66-row boundaries
# fall inside graphs, and padded rows fall inside shards; the graphs lie 2
# apart along x, so that a node given another graph's virtual nodes moves
PADDED = _case([_spatial_raw(80, 10 + k, 0.3, 2.0 * k) for k in range(3)], max_nodes=88)
DATA_GRAPH = _case([_spatial_raw(128, k) for k in range(2)])


def _jax_model():
    return JFastEGNN(hidden=HIDDEN, virtual_channels=3, n_layers=LAYERS, gravity=GRAV,
                     fuse_edge=False)


def _as_port(tree):
    """A JAX param tree (or its gradient) in the port's state-dict layout."""
    return {k: v.numpy() for k, v in
            state_dict_from_jax_params(jax.tree.map(np.asarray, tree)).items()}


@pytest.fixture(scope="module")
def gp(tmp_path_factory):
    """The JAX references, and the four ranks' results."""
    tmp = tmp_path_factory.mktemp("gp")
    jm = _jax_model()
    mesh = Mesh(np.asarray(jax.devices()[:G]), ("graph",))
    ref = {"forward": {}}

    jb = _jax_batch(FORWARD)
    params = jax.jit(jm.init)(jax.random.key(0), jb)["params"]
    fwd = jog.make_owner_gp_forward(mesh, axis="graph", n_layers=LAYERS, gravity=GRAV)
    for name, case in (("forward", FORWARD), ("padded", PADDED)):
        jb = _jax_batch(case)
        sharded = fwd(params, jog.make_owner_sharded_batch(jb, G, build_ek5=False))
        ref["forward"][name] = dict(owner=[np.asarray(a) for a in sharded],
                                    whole=[np.asarray(a) for a in jm.apply({"params": params}, jb)],
                                    mask=np.asarray(jb.node_mask))

    # G = 4, two steps with the MMD term (per-graph sampling, weight 0.01),
    # on the padded graphs; the whole batch's gradient before the first
    jb = _jax_batch(PADDED)
    tparams = jax.jit(jm.init)(jax.random.key(1), jb)["params"]
    tx = jadam(*ADAM)
    ref["train_grads"] = _as_port(jax.jit(jax.grad(
        lambda p: jloss_fn(jm, 1.5, 0.01, 3, True, True)(p, jb, jax.random.key(7))[0]))(tparams))
    step = jog.make_owner_gp_train_step(tx, mesh, axis="graph", n_layers=LAYERS, gravity=GRAV,
                                        sigma=1.5, weight=0.01, sample=3,
                                        per_graph_sampling=True)
    state = TrainState.create(tparams, tx)
    keys = [jax.random.key(7), jax.random.key(8)]
    ref["train"] = []
    for key in keys:
        state, metrics = step(state, jog.make_owner_sharded_batch(jb, G, build_ek5=False), key)
        ref["train"].append({k: float(v) for k, v in metrics.items()})
    ref["train_params"] = _as_port(state.params)
    draws = [np.asarray(jax.random.uniform(k, (jb.n_graphs, jb.num_nodes // jb.n_graphs)))
             for k in keys]

    # data = 2 x graph = 2, weight 0: one graph per replica
    mesh2 = Mesh(np.asarray(jax.devices()[:G]).reshape(2, 2), ("data", "graph"))
    factory = jog.OwnerBatchFactory(2, build_ek5=False)
    subs = [_jax_batch(dict(raws=[r], spec=DATA_GRAPH["spec"])) for r in DATA_GRAPH["raws"]]
    [factory(b) for b in subs]          # settle the capacities
    stacked = jax.tree.map(lambda *xs: jax.numpy.stack(xs), *[factory(b) for b in subs])
    dparams = jax.jit(jm.init)(jax.random.key(2), subs[0])["params"]
    step = jog.make_owner_gp_train_step(tx, mesh2, axis="graph", data_axis="data",
                                        n_layers=LAYERS, gravity=GRAV, weight=0.0)
    state = TrainState.create(dparams, tx)
    ref["dg"] = []
    for i in range(2):
        state, metrics = step(state, stacked, jax.random.key(11 + i))
        ref["dg"].append({k: float(v) for k, v in metrics.items()})
    ref["dg_params"] = _as_port(state.params)

    inputs = dict(hidden=HIDDEN, n_layers=LAYERS, gravity=GRAV, forward=FORWARD, padded=PADDED,
                  state_dict=state_dict_from_jax_params(jax.tree.map(np.asarray, params)),
                  train=dict(PADDED, draws=draws, adam=ADAM, state_dict=state_dict_from_jax_params(
                      jax.tree.map(np.asarray, tparams))),
                  data_graph=dict(DATA_GRAPH, adam=ADAM,
                                  keys=[step_key(43, 0, 1, i) for i in range(2)],
                                  state_dict=state_dict_from_jax_params(
                                      jax.tree.map(np.asarray, dparams))))
    torch.save(inputs, tmp / "inputs.pt")
    ctx = mp.start_processes(torch_gp_worker.run,
                             args=(str(tmp / "store"), str(tmp / "inputs.pt"), str(tmp)),
                             nprocs=torch_gp_worker.N_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, f"the ranks did not end in {JOIN_S} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(torch_gp_worker.N_RANKS)]
    return ref, ranks


# --- the host partitioner (no process group) ---------------------------------

def test_the_raw_graphs_are_test_graph_parallels():
    want = _spatial_batch()
    got = _jax_batch(FORWARD)
    for name in ("dst", "src", "coord", "edge_attr", "node_feat", "edge_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("name", ["forward", "padded"])
def test_partitioner_gives_the_jax_arrays(n_shards, name):
    case = {"forward": FORWARD, "padded": PADDED}[name]
    want = jog.make_owner_sharded_batch(_jax_batch(case), n_shards, build_ek5=False)
    pb = _port_batch(case)
    for i in range(n_shards):
        got = make_owner_sharded_batch(pb, n_shards, shard=i)
        for port, jname in (("send_idx", "send_idx"), ("dst", "dst_local"),
                            ("src", "src_local"), ("edge_attr", "edge_attr"),
                            ("edge_mask", "edge_mask"), ("dst_count", "dst_count"),
                            ("coord", "coord"), ("node_mask", "node_mask"),
                            ("graph_id", "graph_id")):
            np.testing.assert_array_equal(getattr(got, port).numpy(),
                                          np.asarray(getattr(want, jname))[i], err_msg=port)
        # the CSR tables over the shard's table of Nl + G * S rows
        ne, NT = got.n_real_edges, got.n_owned + got.send_idx.numel()
        assert got.rowptr.shape == got.src_rowptr.shape == (NT + 1,)
        d, s = got.dst[:ne].numpy(), got.src[:ne].numpy()
        np.testing.assert_array_equal(got.rowptr.numpy(),
                                      np.searchsorted(d, np.arange(NT + 1)))
        np.testing.assert_array_equal(s[got.src_perm.numpy()], np.sort(s))
        assert got.edge_mask[:ne].all() and not got.edge_mask[ne:].any()
    assert halo_pair_rows(pb, n_shards) == jog.halo_pair_rows(_jax_batch(case), n_shards)


def test_factory_keeps_shapes_stable_and_quantised():
    factory = OwnerBatchFactory(2)
    shapes = []
    for seed in range(3):
        shard = factory(_port_batch(_case([_spatial_raw(seed=seed)])), 1)
        shapes.append((shard.dst.shape, shard.send_idx.shape, shard.rowptr.shape))
    assert shapes[0] == shapes[1] == shapes[2]
    assert shapes[0][0][0] % 1024 == 0 and shapes[0][1][1] % 256 == 0


def test_factory_capacities_only_grow():
    factory = OwnerBatchFactory(2)
    small = factory(_port_batch(_case([_spatial_raw(128, 0)])), 0)
    big = factory(_port_batch(_case([_spatial_raw(512, 1)])), 0)
    assert big.dst.shape[0] > small.dst.shape[0]
    small2 = factory(_port_batch(_case([_spatial_raw(128, 2)])), 0)
    assert small2.dst.shape == big.dst.shape and small2.send_idx.shape == big.send_idx.shape


def test_capacity_overflow_raises_the_capacity_error():
    pb = _port_batch(FORWARD)
    exact = make_owner_sharded_batch(pb, 2, shard=0)
    S, El = exact.send_idx.shape[1], max(
        make_owner_sharded_batch(pb, 2, shard=i).dst.shape[0] for i in range(2))
    assert make_owner_sharded_batch(pb, 2, shard=0, el_capacity=El,
                                    halo_capacity=S).dst.shape == (El,)
    with pytest.raises(OwnerCapacityError, match="per-shard edges"):
        make_owner_sharded_batch(pb, 2, shard=0, el_capacity=El - 1)
    with pytest.raises(OwnerCapacityError, match="halo rows"):
        make_owner_sharded_batch(pb, 2, shard=0, halo_capacity=S - 1)
    # a node capacity that G does not divide is not a capacity overflow
    with pytest.raises(ValueError, match="must divide by 3") as err:
        make_owner_sharded_batch(pb, 3, shard=0)
    assert not isinstance(err.value, OwnerCapacityError)


def test_take_and_pool_defaults_leave_the_layer_bit_for_bit():
    pb = _port_batch(PADDED)
    model = FastEGNN(2, 2, hidden=HIDDEN, virtual_channels=3, n_layers=1, gravity=GRAV,
                     device="cpu", generator=torch.Generator().manual_seed(0))
    layer = model.gcl_0
    h, vx, vh = model.embed(pb)
    n, B = pb.num_nodes, pb.n_graphs
    gen = torch.Generator().manual_seed(1)
    agg_x, agg_e = torch.randn(n, 3, generator=gen), torch.randn(n, HIDDEN, generator=gen)
    args = (LayerCfg(HIDDEN, 3, has_gravity=True), layer, h, pb.coord, pb.vel, vx, vh,
            pb.graph_id, pb.node_mask, agg_x, agg_e)
    default = virtual_and_node_update(*args, gravity=model.gravity)
    explicit = virtual_and_node_update(
        *args, gravity=model.gravity, take=lambda t: per_graph_take(t, n),
        pool=lambda z: per_graph_pool(z.float(), pb.node_mask, B))
    for a, b in zip(default, explicit):
        assert torch.equal(a, b)


# --- the 4-rank gloo group -------------------------------------------------------

def test_halo_exchange_brings_each_edge_its_src_row(gp):
    pb = _port_batch(FORWARD)
    Nl = pb.num_nodes // G
    dst, src = pb.dst.numpy(), pb.src.numpy()
    for r, out in enumerate(gp[1]):
        mine = pb.edge_mask.numpy() & (dst // Nl == r) & (dst < pb.num_nodes)
        np.testing.assert_array_equal(out["halo_src"], src[mine].astype(np.float32))
        assert out["mesh"] == ((G,), ("graph",))
        assert out["mesh2"] == ((2, 2), ("data", "graph"))


@pytest.mark.parametrize("name", ["forward", "padded"])
@pytest.mark.parametrize("branch", ["fused", "csr"])
def test_owner_forward_matches_the_jax_owner_forward_and_the_whole_model(gp, name, branch):
    ref, ranks = gp
    want = ref["forward"][name]
    mask = want["mask"]
    for out in ranks:
        x, vloc = out["forward"][name][branch]
        # all rows: padded rows read graph B - 1 in both packages' owner paths
        np.testing.assert_allclose(x, want["owner"][0], atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(vloc, want["owner"][1], atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(x[mask], want["whole"][0][mask], atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(vloc, want["whole"][1], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", ["forward", "padded"])
def test_fused_branch_matches_the_csr_branch(gp, name):
    for out in gp[1]:
        (xf, vf), (xc, vc) = out["forward"][name]["fused"], out["forward"][name]["csr"]
        np.testing.assert_allclose(xf, xc, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(vf, vc, atol=2e-5, rtol=2e-5)


def _masked_params_close(got, want, grads):
    # Adam's first update is ~lr * sign(g): where |g| < 1e-6 the two
    # packages' last-bit gradient differences can flip it, so those entries
    # are left out (as in test_torch_port_parallel.py)
    assert got.keys() == want.keys()
    for name, a in got.items():
        keep = np.ones(a.shape, bool)
        for g in grads:
            keep &= np.abs(g.get(name, np.zeros_like(a))) >= 1e-6
        np.testing.assert_allclose(a[keep], want[name][keep], atol=1e-6, rtol=2e-4,
                                   err_msg=name)


def test_owner_train_steps_match_the_jax_owner_steps(gp):
    ref, ranks = gp
    for out in ranks:
        for got, want in zip(out["train"], ref["train"]):
            for k in ("loss", "mse", "mmd"):
                np.testing.assert_allclose(got[k], want[k], rtol=2e-4, err_msg=k)
        _masked_params_close(out["train_params"], ref["train_params"], out["train_grads"])
    # every rank holds the same parameters
    for name, v in ranks[0]["train_params"].items():
        for out in ranks[1:]:
            np.testing.assert_array_equal(out["train_params"][name], v, err_msg=name)


def test_owner_gradient_is_the_jax_gradient_of_the_whole_batch(gp):
    # the sum over the ranks of their gradients, before Adam (whose first
    # updates hardly move when a gradient is scaled)
    # (a tensor whose gradient is rounding noise, ~1e-11 here, is held to
    # 1e-6 of the largest gradient entry of the model)
    ref, ranks = gp
    want = ref["train_grads"]
    top = max(np.abs(g).max() for g in want.values())
    for out in ranks:
        assert out["train_grads"][0].keys() <= want.keys()
        for name, g in out["train_grads"][0].items():
            np.testing.assert_allclose(g, want[name], rtol=1e-4, atol=1e-6 * top, err_msg=name)


def test_owner_eval_step_is_the_one_process_eval_step(gp):
    for out in gp[1]:
        for k in ("loss", "mse", "mmd"):
            np.testing.assert_allclose(out["eval"][k], out["eval_one"][k], rtol=1e-5, err_msg=k)


def test_data_by_graph_steps_match_the_jax_steps(gp):
    ref, ranks = gp
    for r, out in enumerate(ranks):
        # rank r is shard r % 2 of replica r // 2, which takes graph r // 2
        shard = out["dg_shard"]
        assert (shard["n_graphs"], shard["shard"]) == (1, r % 2)
        assert shard["el"] % 1024 == 0 and shard["halo"] % 256 == 0
        Nl = shard["coord"].shape[0]
        np.testing.assert_array_equal(
            shard["coord"], DATA_GRAPH["raws"][r // 2]["coord"][(r % 2) * Nl:(r % 2 + 1) * Nl])
        for got, want in zip(out["dg"], ref["dg"]):
            for k in ("loss", "mse"):
                np.testing.assert_allclose(got[k], want[k], rtol=2e-4, err_msg=k)
        _masked_params_close(out["dg_params"], ref["dg_params"], out["dg_grads"])


# --- the CLI ---------------------------------------------------------------------

@pytest.mark.parametrize("mesh,model,flag,env,device,match", [
    ("graph=2", "EGNN", None, "2", "cpu", "only supported for FastEGNN"),
    ("data=2,graph=2", "DimeNet", None, "4", "cpu", "only supported for FastEGNN"),
    ("graph=2", "FastEGNN", "attention_required", "2", "cpu", "paper FastEGNN configuration"),
    ("graph=2", "FastEGNN", "tanh_required", "2", "cpu", "paper FastEGNN configuration"),
    ("graph=2", "FastEGNN", "direction_vector_normalize_required", "2", "cpu",
     "paper FastEGNN configuration"),
    ("graph=2", "FastEGNN", None, None, "cpu", "torchrun --standalone --nproc_per_node 2"),
    ("data=2,graph=2", "FastEGNN", None, "2", "cpu", "WORLD_SIZE is 2"),
    ("graph=2", "FastEGNN", None, "2", "cuda", "needs 2 devices, have 1"),
    ("graph=2", "FastEGNN", None, "2", "cpu", None),
    ("data=2,graph=2", "FastEGNN", None, "4", "cpu", None),
])
def test_graph_mesh_checks_come_before_any_process_group(monkeypatch, mesh, model, flag, env,
                                                         device, match):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    if env is not None:
        monkeypatch.setenv("WORLD_SIZE", env)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    flags = ("attention_required", "tanh_required", "direction_vector_normalize_required")
    args = argparse.Namespace(mesh=mesh, model=model, batch_size=4,
                              **{f: f == flag for f in flags})
    if match is None:
        d, g = check_mesh(args, torch.device(device))
        assert (d, g) == ((2, 2) if mesh.startswith("data") else (1, 2))
    else:
        with pytest.raises(ValueError, match=match):
            check_mesh(args, torch.device(device))
    assert not torch.distributed.is_initialized()


TRAIN_CLI = ["--virtual_channel", "3", "--batch_size", "2", "--num_layer", "2",
             "--max_epochs", "2", "--test_interval", "1", "--platform", "cpu",
             "--weight", "0.01"]


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


def test_cli_under_torchrun_with_a_graph_mesh_trains_as_in_one_process(nbody_data, tmp_path):
    common = [*nbody_data, *TRAIN_CLI]
    pnbody.main(common + ["--log_directory", str(tmp_path / "one")])
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "fastegnn_tpu_torch.cli.nbody", *common, "--mesh", "graph=2",
         "--log_directory", str(tmp_path / "gp"), "--ckpt_directory", str(tmp_path / "ck")],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "mesh training: data=1 x graph=2" in run.stdout
    # the MMD draw of one replica is the one-process draw, so the MMD term
    # (weight 0.01) keeps the run exact
    (best_one, log_one), (best_gp, log_gp) = _log(tmp_path / "one"), _log(tmp_path / "gp")
    assert log_gp["epochs"] == log_one["epochs"] == [1, 2]
    for a, b in ((log_gp["loss_train"], log_one["loss_train"]), (log_gp["loss"], log_one["loss"]),
                 (best_gp["loss_valid"], best_one["loss_valid"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    # its checkpoint is the one-process kind: it resumes in one process
    best = pnbody.main(common + ["--max_epochs", "3", "--resume", str(tmp_path / "ck" / "best"),
                                 "--log_directory", str(tmp_path / "resumed")])
    assert np.isfinite(best["loss_valid"])
    assert _log(tmp_path / "resumed")[1]["epochs"][-1] == 3
