"""The port's FastEGNN against the JAX FastEGNN on the same weights.

Weights cross through the reference state-dict layout: JAX params ->
``state_dict_from_jax_params`` -> port, and back through
``params_from_reference_state_dict``.  Inputs are 4 graphs x 40 nodes
(``helpers.random_raw_graph``), H=64, C=3, L=2, f32.
"""

import jax
import numpy as np
import pytest
import torch

from fastegnn_tpu.graph import GraphSpec as JSpec, batch_graphs as jbatch, pad_graph as jpad
from fastegnn_tpu.models import FastEGNN as JFastEGNN
from fastegnn_tpu.ops.rotation import random_rotation
from fastegnn_tpu.train.loss import masked_mse as jmse
from fastegnn_tpu.utils.torch_import import params_from_reference_state_dict
from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph
from fastegnn_tpu_torch.models.fast_egnn import FastEGNN
from fastegnn_tpu_torch.train.loss import masked_mse
from fastegnn_tpu_torch.utils.weights import state_dict_from_jax_params

from helpers import random_raw_graph

GRAV = (0.0, -1.0, 0.0)


def _batches(n_graphs=4, n_nodes=40, seed=5):
    rng = np.random.default_rng(seed)
    raws = [random_raw_graph(rng, n_nodes) for _ in range(n_graphs)]
    kw = dict(max_nodes=n_nodes, max_edges=n_nodes * (n_nodes - 1), n_graphs=n_graphs,
              edge_attr_dim=2, virtual_channels=3)
    js, ps = JSpec(**kw), GraphSpec(**kw)
    return (jbatch([jpad(js, **r) for r in raws], js),
            batch_graphs([pad_graph(ps, **r) for r in raws], ps, device="cpu"))


def _models(jb, hidden=64, gravity=GRAV, **variant):
    jm = JFastEGNN(hidden=hidden, virtual_channels=3, n_layers=2, gravity=gravity,
                   fuse_edge=False, **variant)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jb)["params"])
    pm = FastEGNN(2, 2, hidden=hidden, virtual_channels=3, n_layers=2, gravity=gravity,
                  device="cpu", **variant)
    pm.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jm, params, pm


@pytest.fixture(scope="module")
def setup():
    jb, pb = _batches()
    jm, params, pm = _models(jb)
    return jb, pb, jm, params, pm


@pytest.mark.parametrize("gravity,attention", [(GRAV, False), (None, True)])
def test_weight_transfer_round_trips_bit_for_bit(gravity, attention):
    jb, _ = _batches(n_graphs=2, n_nodes=6)
    _, params, pm = _models(jb, gravity=gravity, attention=attention)
    sd = {k: v.detach().numpy() for k, v in pm.state_dict().items()}
    back = params_from_reference_state_dict(
        sd, n_layers=2, hidden=64, virtual_channels=3,
        has_gravity=gravity is not None, attention=attention)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


# Coordinates within 1e-4: both packages sum the edge messages, pools and
# matmuls in different orders, which compounds across the two layers.
@pytest.mark.parametrize("jax_fused", [False, True])
def test_forward_matches_jax(setup, jax_fused):
    jb, pb, jm, params, pm = setup
    if jax_fused:   # the JAX fused Pallas kernel, in interpret mode on the CPU
        jm = jm.clone(fuse_edge=True)
    xj, vj = jm.apply({"params": params}, jb)
    with torch.no_grad():
        xp, vp = pm(pb)
    mask = np.asarray(jb.node_mask)
    np.testing.assert_allclose(xp.numpy()[mask], np.asarray(xj)[mask], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=1e-4, atol=1e-4)


def test_param_gradients_of_mse_match_jax(setup):
    jb, pb, jm, params, pm = setup

    def jloss(p):
        x, _ = jm.apply({"params": p}, jb)
        return jmse(x, jb.coord_target, jb.node_mask)

    gj = jax.jit(jax.grad(jloss))(params)
    pm.zero_grad()
    x, _ = pm(pb)
    masked_mse(x, pb.coord_target, pb.node_mask).backward()
    # the last layer's virtual-feature MLPs do not reach the coordinates
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in pm.named_parameters()}
    gp = params_from_reference_state_dict(grads, n_layers=2, has_gravity=True)
    for a, b in zip(jax.tree.leaves(gp), jax.tree.leaves(gj)):
        b = np.asarray(b)
        scale = float(np.abs(b).max()) + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4)


def test_unfused_variant_matches_jax():
    # attention + normalize + tanh at hidden 32: the edge_messages path
    jb, pb = _batches(n_graphs=2, n_nodes=12, seed=2)
    variant = dict(attention=True, normalize=True, tanh=True)
    jm, params, pm = _models(jb, hidden=32, **variant)
    assert not pm.gcl_0.fused
    xj, vj = jm.apply({"params": params}, jb)
    with torch.no_grad():
        xp, vp = pm(pb)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=1e-4, atol=1e-4)


def test_se3_equivariance_without_gravity():
    _, pb = _batches(n_graphs=2, n_nodes=10, seed=11)
    pm = FastEGNN(2, 2, hidden=64, virtual_channels=3, n_layers=2, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    assert pm.gcl_0.fused
    mask = pb.node_mask.numpy()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        x0, v0 = (a.numpy() for a in pm(pb))
        for trial in range(2):
            R = random_rotation(np.random.default_rng(100 + trial)).astype(np.float32)
            t = rng.normal(size=3).astype(np.float32)
            Rt, tt = torch.tensor(R), torch.tensor(t)
            moved = pb.to("cpu")
            moved.coord = pb.coord @ Rt + tt
            moved.vel = pb.vel @ Rt
            moved.loc_mean = torch.einsum("ji,bjc->bic", Rt, pb.loc_mean) + tt[None, :, None]
            x1, v1 = (a.numpy() for a in pm(moved))
            np.testing.assert_allclose(x1[mask], (x0 @ R + t)[mask], atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(
                v1, np.einsum("ji,bjc->bic", R, v0) + t[None, :, None], atol=1e-4, rtol=1e-4)
