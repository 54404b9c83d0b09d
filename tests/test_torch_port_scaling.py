"""The port's weak-scaling sweep (``scripts/torch_bench_scaling.py``)
against the JAX script (``bench_scaling.py``) and the JAX partitioner
(``fastegnn_tpu/parallel/owner_graph.py``), on the CPU.

The sweep's graph must be the JAX script's array for array, its halo
accounting the JAX partitioner's at the JAX default of 512 nodes per shard,
and the step it times the JAX script's step from the same weights.
One sweep over gloo worlds of 1 and 2 ranks runs with ``jax`` and
``fastegnn_tpu`` made unimportable, so it also shows that no process of it
imports either.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (kept on the CPU by conftest.py)
import numpy as np
import pytest
import torch

from jax.sharding import Mesh

from fastegnn_tpu.models import FastEGNN as JFastEGNN
from fastegnn_tpu.parallel import owner_graph as jog
from fastegnn_tpu.train import TrainState, torch_adam as jadam
from fastegnn_tpu_torch.parallel import (
    halo_pair_rows,
    initialize_distributed,
    make_mesh,
    make_owner_sharded_batch,
)
from fastegnn_tpu_torch.utils.weights import state_dict_from_jax_params

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import bench_scaling as jscript  # noqa: E402
import torch_bench_scaling as pscript  # noqa: E402

FIELDS = ("node_feat", "coord", "vel", "node_mask", "graph_id", "dst", "src", "edge_attr",
          "edge_mask", "coord_target", "loc_mean", "dst_count")
# bench_scaling.py at 512 nodes per shard: G -> (S, real halo rows over all pairs)
JAX_HALO = {1: (1, 0), 2: (153, 303), 4: (152, 1111), 8: (161, 2936)}
SWEEP = ["--platform", "cpu", "--devices", "1,2", "--nodes-per-shard", "64", "--layers", "2",
         "--iters", "2"]


def jax_halo_fields(jbatch, n_shards: int) -> dict:
    """``bench_scaling.py:113-128``'s halo figures of the JAX batch."""
    halo = int(jog.make_owner_sharded_batch(jbatch, n_shards, build_ek5=False).send_idx.shape[-1])
    total = jog.halo_pair_rows(jbatch, n_shards)
    row_bytes = (64 + 3) * 4
    return dict(halo_rows_max_pair=halo, halo_rows_total=total,
                halo_kb_per_layer=round(total * row_bytes / 1024, 1),
                halo_kb_padded=round(n_shards * n_shards * halo * row_bytes / 1024, 1))


def port_halo_fields(batch, n_shards: int) -> dict:
    halo = int(make_owner_sharded_batch(batch, n_shards, shard=0, device="cpu").send_idx.shape[-1])
    return pscript.halo_fields(n_shards, halo, halo_pair_rows(batch, n_shards))


@pytest.mark.parametrize("n_nodes", [512, 1024])
def test_batch_is_the_jax_scripts_batch(n_nodes):
    jb, jedges = jscript.build_batch(n_nodes)
    pb, pedges = pscript.build_batch(n_nodes)
    assert pedges == jedges
    assert (pb.num_nodes, pb.num_edges, pb.n_graphs) == (jb.num_nodes, jb.num_edges, jb.n_graphs)
    assert pb.n_real_edges == pedges
    for name in FIELDS:
        want = np.asarray(getattr(jb, name))
        got = getattr(pb, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_halo_fields_are_the_jax_partitioners(n_shards):
    n = 512 * n_shards
    jb, _ = jscript.build_batch(n)
    pb, _ = pscript.build_batch(n)
    want = jax_halo_fields(jb, n_shards)
    assert (want["halo_rows_max_pair"], want["halo_rows_total"]) == JAX_HALO[n_shards]
    assert port_halo_fields(pb, n_shards) == want


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo group of this process alone and its ``("graph",)`` mesh."""
    initialize_distributed("cpu", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                           rank=0)
    try:
        yield make_mesh((1,), ("graph",))
    finally:
        torch.distributed.destroy_process_group()


def test_the_timed_step_is_the_jax_scripts_step(world_of_one):
    # bench_scaling.main at G = 1 on the 64-node batch: init from key(0),
    # torch_adam(5e-4, 1e-12), sigma 1.5, weight 0.01; the warm-up step on
    # key(1), then timed step 0 on fold_in(key(1), 0).  The port's step is
    # the script's own, from the JAX weights, on the JAX MMD draws.
    jb, _ = jscript.build_batch(64)
    jm = JFastEGNN(hidden=64, virtual_channels=3, n_layers=2)
    params = jax.jit(jm.init)(jax.random.key(0), jb)["params"]
    tx = jadam(5e-4, 1e-12)
    state = TrainState.create(params, tx)
    jstep = jog.make_owner_gp_train_step(tx, Mesh(np.asarray(jax.devices()[:1]), ("graph",)),
                                         axis="graph", n_layers=2, sigma=1.5, weight=0.01)
    sb = jog.make_owner_sharded_batch(jb, 1)
    keys = [jax.random.key(1), jax.random.fold_in(jax.random.key(1), 0)]
    want = []
    for key in keys:
        state, metrics = jstep(state, sb, key)
        want.append({k: float(v) for k, v in metrics.items()})
    want_params = {k: v.numpy() for k, v in
                   state_dict_from_jax_params(jax.tree.map(np.asarray, state.params)).items()}

    pb, _ = pscript.build_batch(64)
    shard = make_owner_sharded_batch(pb, 1, shard=0, device="cpu")
    model, step = pscript.make_step(world_of_one, 2, "cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # the script's init is seeded: a second build starts from the same weights
    again, _ = pscript.make_step(world_of_one, 2, "cpu")
    for (name, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)))
    n_max = shard.node_mask_full.shape[0] // shard.n_graphs
    grads = []
    for key, ref in zip(keys, want):
        draw = torch.as_tensor(np.array(jax.random.permutation(key, n_max)))
        got = {k: float(v) for k, v in step(shard, draw=draw).items()}
        for k in ("loss", "mse", "mmd"):
            np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, err_msg=k)
        grads.append({n: np.zeros(p.shape) if p.grad is None else p.grad.numpy().copy()
                      for n, p in model.named_parameters()})
    # Adam's first updates are ~lr * sign(g): where |g| < 1e-6 the two
    # packages' last-bit gradient differences can flip them, so those
    # entries are left out (as in test_torch_port_owner_graph.py)
    for name, p in model.named_parameters():
        keep = np.ones(p.shape, bool)
        for g in grads:
            keep &= np.abs(g[name]) >= 1e-6
        np.testing.assert_allclose(p.detach().numpy()[keep], want_params[name][keep],
                                   atol=1e-6, rtol=2e-4, err_msg=name)
    # the script's keys: the warm-up's, then one of its own for each timed step
    warm, timed = pscript.step_keys(3)
    assert len({tuple(k) for k in [warm, *timed]}) == 4


@pytest.fixture(scope="module")
def sweep_run(tmp_path_factory):
    """One sweep with ``jax`` and ``fastegnn_tpu`` shadowed by packages
    that raise on import, for the sweep, its launchers and every rank."""
    block = tmp_path_factory.mktemp("block")
    for name in ("jax", "fastegnn_tpu"):
        (block / name).mkdir()
        (block / name / "__init__.py").write_text(
            f"raise ImportError('{name} must not be imported by the sweep')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(block), str(REPO)]),
               OMP_NUM_THREADS="1")
    blocked = subprocess.run([sys.executable, "-c", "import fastegnn_tpu"], env=env,
                             capture_output=True, text=True, timeout=60)
    run = subprocess.run([sys.executable, str(REPO / "scripts" / "torch_bench_scaling.py"), *SWEEP],
                         env=env, capture_output=True, text=True, timeout=240)
    return blocked, run


def test_sweep_imports_no_jax(sweep_run):
    blocked, run = sweep_run
    assert blocked.returncode != 0 and "must not be imported" in blocked.stderr
    assert run.returncode == 0, run.stderr[-4000:]


def test_sweep_prints_the_jax_lines(sweep_run):
    _, run = sweep_run
    assert run.returncode == 0, run.stderr[-4000:]
    lines = [json.loads(s) for s in run.stdout.splitlines() if s.startswith("{")]
    assert [s["metric"] for s in lines] == ["gp_launches_per_rank_step", "gp_weak_scaling"] * 2
    results = lines[1::2]
    for G, launches, line in zip((1, 2), lines[0::2], results):
        assert list(line) == [*pscript.KEYS, "backend", "ranks_per_card", "device", "mse"]
        assert (line["devices"], line["nodes"], line["backend"], line["device"]) == (
            G, 64 * G, "gloo", "cpu")
        batch, edges = pscript.build_batch(64 * G)
        assert line["edges"] == edges
        halo = {k: line[k] for k in pscript.KEYS[7:]}
        assert halo == port_halo_fields(batch, G) == jax_halo_fields(
            jscript.build_batch(64 * G)[0], G)
        assert math.isfinite(line["mse"]) and line["mse"] > 0
        assert line["step_ms"] > 0
        assert math.isclose(line["medges_per_s"], edges * 2 / line["step_ms"] / 1e3)
        # the plain versions run on the CPU: no kernel launch is counted
        assert launches["devices"] == G and launches["ranks"] == [
            {"edge_block_fwd": 0.0, "edge_block_bwd": 0.0, "segment_sum": 0.0}] * G
    assert results[0]["efficiency"] == 1.0
    assert math.isclose(results[1]["efficiency"],
                        results[1]["medges_per_s"] / (2 * results[0]["medges_per_s"]))


def test_without_a_card_the_script_raises(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pscript, "run_world", lambda *a, **k: pytest.fail("a world started"))
    with pytest.raises(RuntimeError, match="--platform cpu"):
        pscript.main(["--devices", "1"])


def test_more_ranks_than_cards_raise_unless_they_share(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(pscript, "run_world", lambda *a, **k: pytest.fail("a world started"))
    with pytest.raises(ValueError, match="needs 2 cards"):
        pscript.main(["--devices", "1,2"])
    args = pscript.parse_args(["--devices", "1,2"])
    assert pscript.plan(args, [1]) == ("cuda", "nccl")
    with pytest.raises(ValueError, match="needs 2 cards"):
        pscript.plan(args, [2])
    shared = pscript.parse_args(["--devices", "1,2", "--ranks-per-card", "2"])
    assert pscript.plan(shared, shared.devices) == ("cuda", "gloo")
    with pytest.raises(ValueError, match="needs 2 cards"):
        pscript.plan(shared, [4])
