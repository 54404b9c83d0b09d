"""The port's VNEGNN against the JAX VNEGNN on the same weights.

Weights cross through the reference state-dict layout: JAX params ->
``state_dict_from_vnegnn_params`` -> port, and back through
``params_from_vnegnn_state_dict`` (which has no attention weights: the
attention cases map those linears themselves).  Inputs are 3 graphs x 30
nodes (``helpers.random_raw_graph``), H=64, C=3, L=2, f32.  Both branches
of the A2A cell are covered: the fused edge block (its plain version on the
CPU, with the node messages summed) and, with attention on, the CSR branch;
both sources of the virtual positions, ``loc_mean`` and
``virtual_fibonacci``; and the options no CLI sets, ``residual=False`` with
the charges as node attributes (the JAX ``use_node_attr``, the port's
``node_attr_dim=1``), on the fused branch.  VNEGNN trains on the MSE alone;
training is held on the N-body data of ``tests/test_torch_port_nbody.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastegnn_tpu.graph import GraphSpec as JSpec, batch_graphs as jbatch, pad_graph as jpad
from fastegnn_tpu.models import VNEGNN as JVNEGNN
from fastegnn_tpu.train.loss import masked_mse as jmse
from fastegnn_tpu.utils.torch_import import params_from_vnegnn_state_dict
from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph
from fastegnn_tpu_torch.models import VNEGNN
from fastegnn_tpu_torch.ops.rotation import random_rotation
from fastegnn_tpu_torch.train.loss import masked_mse
from fastegnn_tpu_torch.utils.weights import state_dict_from_vnegnn_params

from helpers import random_raw_graph
from test_torch_port_nbody import (
    check_one_train_step, leaf_gaps, make_trio, one_train_step,
    run_training_on_the_jax_draw)

KW = dict(hidden=64, virtual_channels=3, n_layers=2)
CELLS = ("A2A", "A2V", "V2A")


def _batches(n_graphs=3, n_nodes=30, seed=5, fibonacci=False):
    rng = np.random.default_rng(seed)
    raws = [random_raw_graph(rng, n_nodes) for _ in range(n_graphs)]
    kw = dict(max_nodes=n_nodes, max_edges=n_nodes * (n_nodes - 1), n_graphs=n_graphs,
              edge_attr_dim=2, virtual_channels=3)
    js, ps = JSpec(**kw), GraphSpec(**kw)
    jb = jbatch([jpad(js, **r) for r in raws], js)
    pb = batch_graphs([pad_graph(ps, **r) for r in raws], ps, device="cpu")
    if fibonacci:
        fib = rng.normal(size=(n_graphs, 3, 3)).astype(np.float32)
        jb = jb.replace(virtual_fibonacci=jnp.asarray(fib))
        pb.virtual_fibonacci = torch.tensor(fib)
    return jb, pb


def to_jax(sd, n_layers=2, attention=False):
    """A port ``state_dict``-shaped dict -> JAX params: the JAX importer,
    plus the attention linears it does not map."""
    p = params_from_vnegnn_state_dict(sd, n_layers=n_layers)
    if attention:
        for i in range(n_layers):
            for cell in CELLS:
                g = f"{cell}_{i}"
                p[g]["att_mlp"] = {"kernel": np.asarray(sd[f"{g}.att_mlp.0.weight"]).T,
                                   "bias": np.asarray(sd[f"{g}.att_mlp.0.bias"])}
    return p


def _models(jb, attention=False, options=False):
    """The JAX model, its init and the port model with its weights; with
    ``options``, ``residual=False`` and the node attributes."""
    jm = JVNEGNN(attention=attention, residual=not options, use_node_attr=options, **KW)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jb)["params"])
    pm = VNEGNN(2, 2, attention=attention, residual=not options,
                node_attr_dim=1 if options else 0, device="cpu", **KW)
    pm.load_state_dict(state_dict_from_vnegnn_params(params), strict=True)
    return jm, params, pm


@pytest.fixture(scope="module", params=["fused", "attention", "fibonacci", "options"])
def case(request):
    """The JAX forward and MSE parameter gradients, and the port model with
    the same weights: the fused A2A branch, the CSR branch (attention), the
    fused branch with the virtual positions from ``virtual_fibonacci``, and
    the fused branch with ``residual=False`` and the node attributes."""
    jb, pb = _batches(fibonacci=request.param == "fibonacci")
    attention = request.param == "attention"
    jm, params, pm = _models(jb, attention=attention, options=request.param == "options")
    assert pm.A2A_0.fused == (not attention)

    def jloss(p):
        x, vx = jm.apply({"params": p}, jb)
        return jmse(x, jb.coord_target, jb.node_mask), (x, vx)

    (_, (xj, vj)), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    return dict(jb=jb, pb=pb, pm=pm, attention=attention, xj=np.asarray(xj),
                vj=np.asarray(vj), gj=gj)


@pytest.mark.parametrize("attention,node_attr", [
    pytest.param(False, False, id="False"), pytest.param(True, False, id="True"),
    pytest.param(False, True, id="node_attr")])
def test_weights_round_trip_bit_for_bit(attention, node_attr):
    # port -> params_from_vnegnn_state_dict -> the inverse, from a port
    # init; and JAX params -> the inverse -> the importer.  With the node
    # attributes node_mlp.0 of A2A and V2A is 2H + 1 wide
    pm = VNEGNN(2, 2, attention=attention, node_attr_dim=int(node_attr), device="cpu",
                generator=torch.Generator().manual_seed(0), **KW)
    assert pm.V2A_1.node_mlp[0].in_features == 2 * 64 + int(node_attr)
    assert pm.A2V_1.node_mlp[0].in_features == 2 * 64
    sd = {k: v.detach().numpy() for k, v in pm.state_dict().items()}
    back = state_dict_from_vnegnn_params(to_jax(sd, attention=attention))
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    jb, _ = _batches(n_graphs=2, n_nodes=6)
    _, params, pm = _models(jb, attention=attention, options=node_attr)
    again = to_jax({k: v.detach().numpy() for k, v in pm.state_dict().items()},
                   attention=attention)
    assert jax.tree.structure(again) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_keys_and_initialisation_follow_the_reference():
    pm = VNEGNN(2, 2, device="cpu", generator=torch.Generator().manual_seed(0), **KW)
    keys = set(pm.state_dict())
    assert {f"{c}_{i}.{m}.{j}.weight" for c in CELLS for i in range(2)
            for m in ("edge_mlp", "coord_mlp", "node_mlp") for j in (0, 2)} <= keys
    assert not any("gravity" in k or k.startswith("gcl_") for k in keys)
    assert pm.A2A_0.edge_mlp[0].in_features == 2 * 64 + 1 + 2
    assert pm.A2V_0.edge_mlp[0].in_features == pm.V2A_0.edge_mlp[0].in_features == 2 * 64 + 1
    assert pm.A2A_0.coord_mlp[2].bias is None
    assert float(pm.V2A_1.coord_mlp[2].weight.detach().abs().max()) <= 1e-3 * (6 / 65) ** 0.5
    assert tuple(pm.virtual_node_feat.shape) == (1, 64, 3)


# 1e-5 of the largest value: the packages sum in different orders
# (measured: 0 in every case, the coordinate updates of the two packages
# differing below an f32 ulp of the positions; the gradients below see it)
def test_forward_matches_jax(case):
    with torch.no_grad():
        xp, vp = case["pm"](case["pb"])
    mask = np.asarray(case["jb"].node_mask)
    xj, vj = case["xj"][mask], case["vj"]
    np.testing.assert_allclose(xp.numpy()[mask], xj, rtol=0, atol=1e-5 * np.abs(xj).max())
    np.testing.assert_allclose(vp.numpy(), vj, rtol=0, atol=1e-5 * np.abs(vj).max())


# 1e-4 of each leaf's floored scale, as for FastRF and FastSchNet
# (measured: 1.7e-6 fused, 2.6e-6 attention, 2.2e-6 Fibonacci)
def test_param_gradients_of_mse_match_jax(case):
    pm, pb = case["pm"], case["pb"]
    pm.zero_grad()
    x, _ = pm(pb)
    masked_mse(x, pb.coord_target, pb.node_mask).backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in pm.named_parameters()}
    gp = to_jax(grads, attention=case["attention"])
    assert jax.tree.structure(gp) == jax.tree.structure(case["gj"])
    gaps, _ = leaf_gaps(gp, case["gj"])
    assert max(gaps) <= 1e-4, gaps


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    return make_trio(tmp_path_factory)


def test_one_train_step_without_mmd_matches_jax(trio):
    r = one_train_step(trio, JVNEGNN(**KW), VNEGNN(2, 2, device="cpu", **KW),
                       state_dict_from_vnegnn_params, to_jax, use_mmd=False)
    assert r["port"]["mmd"] == r["jax"]["mmd"] == 0.0
    assert r["port"]["loss"] == r["port"]["mse"]
    check_one_train_step(r)


# rtol 2e-4, the FastEGNN N-body test's; both train on the MSE alone
def test_cli_training_tracks_the_jax_train(monkeypatch, tmp_path, trio):
    (pbest, plog), (jbest, jlog) = run_training_on_the_jax_draw(
        monkeypatch, tmp_path, trio, "VNEGNN", JVNEGNN(**KW), state_dict_from_vnegnn_params)
    np.testing.assert_allclose(plog["loss_train"], jlog["loss_train"], rtol=2e-4)
    np.testing.assert_allclose(plog["loss"], jlog["loss"], rtol=2e-4)
    np.testing.assert_allclose(pbest["loss_valid"], jbest["loss_valid"], rtol=2e-4)
    assert pbest["epoch_index"] == jbest["epoch_index"]


def test_se3_equivariance():
    _, pb = _batches(n_graphs=2, n_nodes=10, seed=11)
    mask = pb.node_mask.numpy()
    for attention in (False, True):
        pm = VNEGNN(2, 2, attention=attention, device="cpu",
                    generator=torch.Generator().manual_seed(0), **KW)
        with torch.no_grad():
            x0, v0 = (a.numpy() for a in pm(pb))
            R = random_rotation(np.random.default_rng(100)).astype(np.float32)
            t = np.random.default_rng(0).normal(size=3).astype(np.float32)
            Rt, tt = torch.tensor(R), torch.tensor(t)
            moved = pb.to("cpu")
            moved.coord = pb.coord @ Rt + tt
            moved.vel = pb.vel @ Rt
            moved.loc_mean = torch.einsum("ji,bjc->bic", Rt, pb.loc_mean) + tt[None, :, None]
            x1, v1 = (a.numpy() for a in pm(moved))
        np.testing.assert_allclose(x1[mask], (x0 @ R + t)[mask], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(
            v1, np.einsum("ji,bjc->bic", R, v0) + t[None, :, None], atol=1e-4, rtol=1e-4)
