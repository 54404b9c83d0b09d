"""The port's baselines against the JAX package's on the same weights:
``models/basic.py`` (EGNN, GNN, RF, Linear, EGMN, FullMLP and the scalar
nets) and the standalone SchNet.

Weights cross through the reference state-dict layout: JAX params ->
``state_dict_from_*_params`` -> port, and back through the JAX importers
of ``fastegnn_tpu/utils/torch_import.py``.  Inputs are 3 graphs x 20 nodes
(``helpers.random_raw_graph``), H=64, L=2 (SchNet: 3 interactions, its
CLI's 128 filters, 64 Gaussians, cutoff 1), f32.  Training is held on the
N-body data of ``tests/test_torch_port_nbody.py``; the N-body CLI's
``run_training`` for EGNN against the JAX ``train()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastegnn_tpu.graph import GraphSpec as JSpec, batch_graphs as jbatch, pad_graph as jpad
from fastegnn_tpu.models import basic as jbasic
from fastegnn_tpu.models import SchNet as JSchNet
from fastegnn_tpu.train.loss import masked_mse as jmse
from fastegnn_tpu.utils import torch_import as ti
from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph
from fastegnn_tpu_torch.models import basic as pbasic
from fastegnn_tpu_torch.models.schnet import SchNet
from fastegnn_tpu_torch.ops import spmm
from fastegnn_tpu_torch.train.loss import masked_mse
from fastegnn_tpu_torch.train.step import prediction
from fastegnn_tpu_torch.utils import weights as pw

from helpers import random_raw_graph
from test_torch_port_nbody import (
    check_one_train_step, leaf_gaps, make_trio, one_train_step,
    run_training_on_the_jax_draw)

SCHNET_KW = dict(hidden=64, num_interactions=3)


def _batches(n_graphs=3, n_nodes=20, seed=5):
    rng = np.random.default_rng(seed)
    raws = [random_raw_graph(rng, n_nodes, cutoff_rate=0.3) for _ in range(n_graphs)]
    kw = dict(max_nodes=n_nodes + 2, max_edges=n_nodes * (n_nodes - 1), n_graphs=n_graphs,
              edge_attr_dim=2, virtual_channels=3)
    js, ps = JSpec(**kw), GraphSpec(**kw)
    return (jbatch([jpad(js, **r) for r in raws], js),
            batch_graphs([pad_graph(ps, **r) for r in raws], ps, device="cpu"))


# name -> (JAX model, port model, JAX params -> port, port state dict -> JAX params)
MODELS = {
    "EGNN": (lambda: jbasic.EGNN(hidden=64, n_layers=2),
             lambda: pbasic.EGNN(2, 2, hidden=64, n_layers=2, device="cpu"),
             pw.state_dict_from_egnn_params,
             lambda sd: ti.params_from_egnn_state_dict(sd, n_layers=2)),
    "GNN": (lambda: jbasic.GNN(hidden=64, n_layers=2),
            lambda: pbasic.GNN(2, 2, hidden=64, n_layers=2, device="cpu"),
            pw.state_dict_from_gnn_params,
            lambda sd: ti.params_from_gnn_state_dict(sd, n_layers=2)),
    "RF": (lambda: jbasic.RFVel(hidden=64, n_layers=2),
           lambda: pbasic.RFVel(2, 2, hidden=64, n_layers=2, device="cpu"),
           pw.state_dict_from_rfvel_params,
           lambda sd: ti.params_from_rfvel_state_dict(sd, n_layers=2)),
    "Linear": (jbasic.LinearDynamics,
               lambda: pbasic.LinearDynamics(2, 2, device="cpu"),
               pw.state_dict_from_linear_dynamics_params,
               ti.params_from_linear_dynamics_state_dict),
    "SchNet": (lambda: JSchNet(**SCHNET_KW),
               lambda: SchNet(2, 2, device="cpu", **SCHNET_KW),
               pw.state_dict_from_schnet_params,
               lambda sd: ti.params_from_schnet_state_dict(sd, num_interactions=3)),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_sd(pm):
    return {k: v.detach().numpy() for k, v in pm.state_dict().items()}


def _same_trees(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    """The JAX forward and MSE parameter gradients, and the port model with
    the same weights."""
    name = request.param
    make_j, make_p, inverse, to_jax = MODELS[name]
    jb, pb = _batches()
    jm = make_j()
    params = _np_tree(jm.init(jax.random.key(0), jb)["params"])
    pm = make_p()
    pm.load_state_dict(inverse(params), strict=True)

    def jloss(p):
        out = jm.apply({"params": p}, jb)
        x = out[0] if isinstance(out, tuple) else out
        return jmse(x, jb.coord_target, jb.node_mask), out

    (_, out), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    return dict(name=name, jb=jb, pb=pb, pm=pm, params=params, to_jax=to_jax,
                out=jax.tree.map(np.asarray, out), gj=gj, make_p=make_p, inverse=inverse)


def test_weights_round_trip_through_the_jax_importer_bit_for_bit(case):
    # JAX params -> the inverse -> the importer, and a port init -> the
    # importer -> the inverse
    _same_trees(case["to_jax"](_port_sd(case["pm"])), case["params"])
    torch.manual_seed(1)
    sd = _port_sd(case["make_p"]())
    back = case["inverse"](case["to_jax"](sd))
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def _outputs(out):
    """Each array of a model's output (EGNN's ``(x, v, h)``: all three)."""
    return list(out) if isinstance(out, tuple) else [out]


# 1e-5 of each output's largest value (measured: at most 2.8e-7, GNN)
def test_forward_matches_jax(case):
    with torch.no_grad():
        got = _outputs(case["pm"](case["pb"]))
    want = _outputs(case["out"])
    assert len(got) == len(want)
    mask = np.asarray(case["jb"].node_mask)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b)[mask].max() <= 1e-5 * np.abs(b[mask]).max()


# 1e-4 of each leaf's floored scale (measured: at most 2.3e-6, RF)
def test_param_gradients_of_mse_match_jax(case):
    pm, pb = case["pm"], case["pb"]
    pm.zero_grad()
    masked_mse(prediction(pm(pb)), pb.coord_target, pb.node_mask).backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in pm.named_parameters()}
    gp = case["to_jax"](grads)
    assert jax.tree.structure(gp) == jax.tree.structure(case["gj"])
    gaps, _ = leaf_gaps(gp, case["gj"])
    assert max(gaps) <= 1e-4, gaps


def test_schnet_skips_its_dead_last_feature_update():
    # the last interaction's feature update reaches no position: it does not
    # run, so its parameters get no gradient (zero in JAX)
    _, pb = _batches(n_graphs=2, n_nodes=10, seed=7)
    pm = SchNet(2, 2, device="cpu", **SCHNET_KW)
    prediction(pm(pb)).square().sum().backward()
    for i, block in enumerate(pm.interactions):
        got = [p.grad is not None for p in block.parameters()]
        assert all(got) if i < 2 else not any(got), i


def test_egnn_clips_its_coordinate_mean():
    # a coordinate mean beyond +-100 is clipped, as in the JAX layer
    jb, pb = _batches(n_graphs=1, n_nodes=8, seed=2)
    jm = jbasic.EGNN(hidden=16, n_layers=1)
    params = _np_tree(jm.init(jax.random.key(0), jb)["params"])
    params["layer_0"]["coord_net"]["lin1"]["bias"] = np.full((1,), 1e5, np.float32)
    pm = pbasic.EGNN(2, 2, hidden=16, n_layers=1, device="cpu")
    pm.load_state_dict(pw.state_dict_from_egnn_params(params), strict=True)
    xj, _, _ = jm.apply({"params": params}, jb)
    with torch.no_grad():
        xp, _, _ = pm(pb)
    mask = np.asarray(jb.node_mask)
    np.testing.assert_allclose(xp.numpy()[mask], np.asarray(xj)[mask], rtol=1e-6, atol=1e-4)
    moved = np.abs(xp.numpy() - pb.coord.numpy())[mask].max()
    assert 99.0 < moved < 110.0


@pytest.mark.parametrize("net,norm", [("invariant", True), ("invariant", False),
                                      ("equivariant", True), ("edge", True)])
def test_scalar_nets_match_jax(net, norm):
    # the EquivariantScalarNet in its default flat form (tanh, 4x hidden)
    rng = np.random.default_rng(3)
    vi = rng.normal(size=(7, 3, 3)).astype(np.float32)
    vj = rng.normal(size=(7, 3, 3)).astype(np.float32)
    sc = rng.normal(size=(7, 5)).astype(np.float32)
    if net == "invariant":
        jm = jbasic.InvariantScalarNet(hidden=16, out=4, norm=norm, last_act=True)
        pm = pbasic.InvariantScalarNet(3, 5, 16, 4, norm=norm, last_act=True)
        args = (vi, sc)
    elif net == "equivariant":
        jm, pm = jbasic.EquivariantScalarNet(hidden=16), pbasic.EquivariantScalarNet(3, 5, 16)
        args = (vi, sc)
    else:
        jm = jbasic.EquivariantEdgeScalarNet(hidden=16)
        pm = pbasic.EquivariantEdgeScalarNet(3, 5, 16)
        args = (vi, vj, sc)
    params = _np_tree(jm.init(jax.random.key(0), *map(jnp.asarray, args))["params"])
    sd = {}
    for name, p in params.items():
        pw._base_mlp(sd, name, p)
    pm.load_state_dict(sd, strict=True)
    want = _outputs(jm.apply({"params": params}, *map(jnp.asarray, args)))
    got = _outputs(pm(*map(torch.tensor, args)))
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.abs(a.detach().numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_egmn_matches_jax():
    rng = np.random.default_rng(4)
    vecs = [rng.normal(size=(9, 3)).astype(np.float32) for _ in range(2)]
    sc = rng.normal(size=(9, 6)).astype(np.float32)
    jm = jbasic.EGMN(hidden=16, n_layers=3, norm=True)
    params = _np_tree(jm.init(jax.random.key(0), [jnp.asarray(v) for v in vecs],
                              jnp.asarray(sc))["params"])
    pm = pbasic.EGMN(2, 6, 16, 3, norm=True)
    pm.load_state_dict(pw.state_dict_from_egmn_params(params), strict=True)
    _same_trees(ti.params_from_egmn_state_dict(_port_sd(pm), n_layers=3), params)
    want = jm.apply({"params": params}, [jnp.asarray(v) for v in vecs], jnp.asarray(sc))
    got = pm([torch.tensor(v) for v in vecs], torch.tensor(sc))
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.abs(a.detach().numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_full_mlp_matches_jax():
    x = np.random.default_rng(6).normal(size=(11, 5)).astype(np.float32)
    jm = jbasic.FullMLP(hidden=32, n_layers=2)
    params = _np_tree(jm.init(jax.random.key(0), jnp.asarray(x))["params"])
    pm = pbasic.FullMLP(5, hidden=32, n_layers=2, device="cpu")
    sd = pw.state_dict_from_fullmlp_params(params)
    assert sd.keys() == pm.state_dict().keys()
    pm.load_state_dict(sd, strict=True)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = pm(torch.tensor(x)).detach().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_rf_head_and_keys_follow_the_reference():
    pm = pbasic.RFVel(2, 2, hidden=64, n_layers=2, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    assert set(pm.state_dict()) == {f"gcl_{i}.{k}" for i in range(2) for k in (
        "phi.0.weight", "phi.0.bias", "phi.2.weight", "coord_mlp_vel.0.weight",
        "coord_mlp_vel.0.bias", "coord_mlp_vel.2.weight", "coord_mlp_vel.2.bias")}
    bound = 1e-3 * (6 / 65) ** 0.5   # xavier-uniform, gain 1e-3
    w = pm.gcl_0.phi[2].weight.detach().abs().max()
    assert 0.5 * bound < float(w) <= bound


def test_segment_sum_through_leaves_unlisted_rows_without_gradient():
    # rows left out of perm (masked bonds) carry an out-of-range id: they
    # add nothing and get no gradient
    ids = torch.tensor([2, 0, 2, 1, 0], dtype=torch.int32)
    keep = torch.tensor([True, True, False, True, True])
    sum_ids = torch.where(keep, ids, torch.full_like(ids, 3))
    perm = torch.tensor([1, 4, 3, 0], dtype=torch.int32)
    rowptr = torch.tensor([0, 2, 3, 4], dtype=torch.int32)
    data = torch.randn(5, 4, generator=torch.Generator().manual_seed(0), requires_grad=True)
    got = spmm.segment_sum_through(data, sum_ids, perm, rowptr, 3)
    want = torch.zeros(3, 4).index_add_(0, ids[keep].long(), data[keep])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    got.sum().backward()
    assert torch.equal(data.grad, keep[:, None].float().expand(5, 4))
    with pytest.raises(ValueError, match="differ"):
        spmm.segment_sum_through(data[:-1], sum_ids, perm, rowptr, 3)


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    return make_trio(tmp_path_factory)


# On the MSE alone (no model here trains with the MMD term).  Measured:
# gradients at most 1.9e-6 of their floored scale (SchNet), post-Adam
# parameters 7.5e-9
@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_train_step_matches_jax(trio, name):
    make_j, make_p, inverse, to_jax = MODELS[name]
    check_one_train_step(one_train_step(trio, make_j(), make_p(), inverse, to_jax,
                                        use_mmd=False))


# The logged MSEs are 8e-4 - 4e-3 here.  Measured: every train, valid and
# test MSE within 3.0e-5 relative; rtol 2e-4, the FastEGNN N-body test's
def test_cli_training_of_egnn_tracks_the_jax_train(monkeypatch, tmp_path, trio):
    (pbest, plog), (jbest, jlog) = run_training_on_the_jax_draw(
        monkeypatch, tmp_path, trio, "EGNN", jbasic.EGNN(hidden=64, n_layers=2),
        pw.state_dict_from_egnn_params)
    np.testing.assert_allclose(plog["loss_train"], jlog["loss_train"], rtol=2e-4)
    np.testing.assert_allclose(plog["loss"], jlog["loss"], rtol=2e-4)
    np.testing.assert_allclose(pbest["loss_valid"], jbest["loss_valid"], rtol=2e-4)
    assert pbest["epoch_index"] == jbest["epoch_index"]
