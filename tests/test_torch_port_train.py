"""One port train step against the JAX train step, the MMD loss in both
sampling modes, the package's import boundary and its device rule."""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastegnn_tpu.graph as jgraph
from fastegnn_tpu.graph import GraphSpec as JSpec, batch_graphs as jbatch, pad_graph as jpad
from fastegnn_tpu.models import FastEGNN as JFastEGNN
from fastegnn_tpu.train import TrainState, torch_adam as jadam
from fastegnn_tpu.train.loss import mmd_loss as jmmd
from fastegnn_tpu.train.step import make_loss_fn as jloss_fn, make_train_step as jstep
from fastegnn_tpu.utils.torch_import import params_from_reference_state_dict
import fastegnn_tpu_torch
from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph
from fastegnn_tpu_torch.models.fast_egnn import FastEGNN
from fastegnn_tpu_torch.train.loss import mmd_loss
from fastegnn_tpu_torch.train.optim import torch_adam
from fastegnn_tpu_torch.train.step import make_eval_step, make_train_step
from fastegnn_tpu_torch.utils.weights import state_dict_from_jax_params

from helpers import random_raw_graph

REPO = Path(__file__).resolve().parent.parent
GRAV = (0.0, -1.0, 0.0)


def _batches(sizes=(30, 24, 30), cap=30, seed=7, csr=False):
    rng = np.random.default_rng(seed)
    raws = [random_raw_graph(rng, n, cutoff_rate=0.5) for n in sizes]
    kw = dict(max_nodes=cap, max_edges=cap * (cap - 1), n_graphs=len(sizes),
              edge_attr_dim=2, virtual_channels=3)
    js, ps = JSpec(**kw), GraphSpec(**kw)
    # csr: one graph per fused-kernel group, so that the JAX batch carries
    # the CSR tables of its Pallas segment-sum branch (csr_for_groups)
    old = jgraph.EK5_MAX_NODES
    jgraph.EK5_MAX_NODES = cap if csr else old
    try:
        jb = jbatch([jpad(js, **r) for r in raws], js, csr_for_groups=csr)
    finally:
        jgraph.EK5_MAX_NODES = old
    assert (jb.csr_dst is not None) == csr
    return jb, batch_graphs([pad_graph(ps, **r) for r in raws], ps, device="cpu")


def test_train_step_matches_jax():
    _check_train_step(attention=False)


def test_attention_train_step_matches_jax():
    # the CSR edge branch on both sides, the JAX side through the Pallas
    # segment-sum kernel
    _check_train_step(attention=True)


def _check_train_step(attention):
    jb, pb = _batches(csr=attention)
    jm = JFastEGNN(hidden=64, virtual_channels=3, n_layers=2, gravity=GRAV, fuse_edge=False,
                   attention=attention)
    params = jm.init(jax.random.key(0), jb)["params"]
    key = jax.random.key(1)
    kw = dict(sigma=1.0, weight=0.01, sample=3, per_graph_sampling=True)
    tx = jadam(5e-4, 1e-12)
    state, mj = jstep(jm, tx, donate=False, **kw)(TrainState.create(params, tx), jb, key)
    gj = jax.jit(jax.grad(lambda p: jloss_fn(jm, 1.0, 0.01, 3, True)(p, jb, key)[0]))(params)

    pm = FastEGNN(2, 2, hidden=64, virtual_channels=3, n_layers=2, gravity=GRAV,
                  attention=attention, device="cpu")
    assert pm.gcl_0.fused != attention
    pm.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)))
    step = make_train_step(pm, torch_adam(pm.parameters(), 5e-4, 1e-12), **kw)
    # the JAX step draws exactly these scores from `key` (train/loss.py:73)
    scores = jax.random.uniform(key, (jb.n_graphs, jb.num_nodes // jb.n_graphs))
    mp = step(pb, draw=torch.tensor(np.asarray(scores)))
    for k in ("loss", "mse"):
        np.testing.assert_allclose(float(mp[k]), float(mj[k]), rtol=1e-5)
    # mmd = l_vv - l_rv cancels two terms of size up to 1 and 2 (kernel
    # values lie in (0, 1]) down to ~0.03, so its 1e-5 relative tolerance is
    # taken against the terms' scale, 2, not against the difference
    np.testing.assert_allclose(float(mp["mmd"]), float(mj["mmd"]), rtol=1e-5, atol=2e-5)

    new = params_from_reference_state_dict(
        {k: v.detach().numpy() for k, v in pm.state_dict().items()},
        n_layers=2, has_gravity=True, attention=attention)
    # Adam's first update is ~lr * sign(g): where |g| < 1e-6 the two
    # packages' last-bit gradient differences can flip it, so those entries
    # are left out
    for a, b, g in zip(jax.tree.leaves(new), jax.tree.leaves(state.params),
                       jax.tree.leaves(gj)):
        keep = np.abs(np.asarray(g)) >= 1e-6
        np.testing.assert_allclose(a[keep], np.asarray(b)[keep], atol=1e-6, rtol=0)


@pytest.mark.parametrize("per_graph", [True, False])
def test_mmd_loss_matches_jax(per_graph):
    jb, pb = _batches(seed=3)
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(pb.num_nodes, 3)).astype(np.float32)
    vloc = rng.normal(size=(pb.n_graphs, 3, 3)).astype(np.float32)
    key = jax.random.key(4)
    n_max = pb.num_nodes // pb.n_graphs
    want = jmmd(jnp.asarray(pred), jnp.asarray(vloc), jb, key, 1.0, 3, per_graph)
    draw = (jax.random.uniform(key, (pb.n_graphs, n_max)) if per_graph
            else jax.random.permutation(key, n_max))
    kw = {"scores" if per_graph else "perm": torch.tensor(np.asarray(draw))}
    got = mmd_loss(torch.tensor(pred), torch.tensor(vloc), pb.node_mask, pb.n_graphs,
                   1.0, 3, **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7)


def test_steps_draw_their_own_sample_from_a_generator():
    _, pb = _batches(seed=9)
    pm = FastEGNN(2, 2, hidden=64, virtual_channels=3, n_layers=1, gravity=GRAV,
                  device="cpu", generator=torch.Generator().manual_seed(0))
    kw = dict(sigma=1.0, weight=0.01, sample=3, per_graph_sampling=False)
    ev = make_eval_step(pm, generator=torch.Generator().manual_seed(2), **kw)
    before = ev(pb)
    step = make_train_step(pm, torch_adam(pm.parameters(), 5e-4),
                           generator=torch.Generator().manual_seed(1), **kw)
    out = [step(pb) for _ in range(3)]
    assert all(np.isfinite(float(o[k])) for o in out for k in ("loss", "mse", "mmd"))
    assert float(ev(pb)["mse"]) < float(before["mse"])


def test_package_never_imports_jax():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {str(REPO)!r})
        import fastegnn_tpu_torch
        for m in pkgutil.walk_packages(fastegnn_tpu_torch.__path__, "fastegnn_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "fastegnn_tpu")]
        assert not bad, bad
        print("ok", len([m for m in sys.modules if m.startswith("fastegnn_tpu_torch")]))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    spec = GraphSpec(max_nodes=6, max_edges=30, n_graphs=1, edge_attr_dim=2)
    padded = [pad_graph(spec, **random_raw_graph(rng, 6))]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fastegnn_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError):
        batch_graphs(padded, spec)
    with pytest.raises(RuntimeError):
        FastEGNN(2, 2, hidden=16, n_layers=1)
    with pytest.raises(RuntimeError):
        fastegnn_tpu_torch.resolve_device("cuda")
    from fastegnn_tpu_torch.data.synthetic_water import build_batch
    with pytest.raises(RuntimeError):
        build_batch(n_nodes=200, degree=10)
    assert fastegnn_tpu_torch.resolve_device("cpu") == torch.device("cpu")
