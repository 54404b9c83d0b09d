"""The port's FastSchNet against the JAX FastSchNet on the same weights,
and the parts it is built from.

Weights cross through the reference state-dict layout: JAX params ->
``state_dict_from_fastschnet_params`` -> port, and back through
``params_from_fastschnet_state_dict`` (which has no attention weights: the
attention tests map those two linears themselves).  Inputs are 3 graphs x
30 nodes (``helpers.random_raw_graph``), H=64, C=3, L=2, f32.  The embedded
SchNet's CFConv output never reaches FastSchNet's output (the reference
discards the SchNet's features), so the port does not run it and its
parameters get no gradient; the JAX package's are zero.  The options no CLI
sets, ``residual=False`` with the charges as node attributes (the JAX
``use_node_attr``, the port's ``node_attr_dim=1``: ``node_mlp.0``'s last
input column), are held too.  Training is held on the N-body data of
``tests/test_torch_port_nbody.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastegnn_tpu.graph import GraphSpec as JSpec, batch_graphs as jbatch, pad_graph as jpad
from fastegnn_tpu.models import FastSchNet as JFastSchNet
from fastegnn_tpu.models import schnet as jschnet
from fastegnn_tpu.train.loss import masked_mse as jmse
from fastegnn_tpu.utils.torch_import import params_from_fastschnet_state_dict
from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph
from fastegnn_tpu_torch.models import FastSchNet
from fastegnn_tpu_torch.models import schnet as pschnet
from fastegnn_tpu_torch.ops import spmm
from fastegnn_tpu_torch.ops.rotation import random_rotation
from fastegnn_tpu_torch.train.loss import masked_mse
from fastegnn_tpu_torch.utils.weights import state_dict_from_fastschnet_params

from helpers import random_raw_graph
from test_torch_port_nbody import (
    check_one_train_step, leaf_gaps, make_trio, one_train_step,
    run_training_on_the_jax_draw)

GRAV = (0.0, -1.0, 0.0)
KW = dict(hidden=64, virtual_channels=3, n_layers=2)


def _batches(n_graphs=3, n_nodes=30, seed=5):
    rng = np.random.default_rng(seed)
    raws = [random_raw_graph(rng, n_nodes) for _ in range(n_graphs)]
    kw = dict(max_nodes=n_nodes, max_edges=n_nodes * (n_nodes - 1), n_graphs=n_graphs,
              edge_attr_dim=2, virtual_channels=3)
    js, ps = JSpec(**kw), GraphSpec(**kw)
    return (jbatch([jpad(js, **r) for r in raws], js),
            batch_graphs([pad_graph(ps, **r) for r in raws], ps, device="cpu"))


def to_jax(sd, n_layers=2, has_gravity=True, attention=False):
    """A port ``state_dict``-shaped dict -> JAX params: the JAX importer,
    plus the attention linears it does not map."""
    p = params_from_fastschnet_state_dict(sd, n_layers=n_layers, hidden=64,
                                          virtual_channels=3, has_gravity=has_gravity)
    if attention:
        for i in range(n_layers):
            for name in ("att_mlp", "att_mlp_virtual"):
                p[f"gcl_{i}"][name] = {"kernel": np.asarray(sd[f"gcl_{i}.{name}.0.weight"]).T,
                                       "bias": np.asarray(sd[f"gcl_{i}.{name}.0.bias"])}
    return p


def _models(jb, gravity=GRAV, attention=False, options=False):
    """The JAX model, its init and the port model with its weights; with
    ``options``, ``residual=False`` and the node attributes."""
    jm = JFastSchNet(gravity=gravity, attention=attention, residual=not options,
                     use_node_attr=options, **KW)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jb)["params"])
    pm = FastSchNet(2, 2, gravity=gravity, attention=attention, residual=not options,
                    node_attr_dim=1 if options else 0, device="cpu", **KW)
    pm.load_state_dict(state_dict_from_fastschnet_params(params), strict=True)
    return jm, params, pm


@pytest.fixture(scope="module", params=["plain", "attention", "options"])
def case(request):
    """The JAX forward and MSE parameter gradients, and the port model with
    the same weights: without and with attention, and with
    ``residual=False`` and the node attributes."""
    jb, pb = _batches()
    attention = request.param == "attention"
    jm, params, pm = _models(jb, attention=attention, options=request.param == "options")

    def jloss(p):
        x, vx = jm.apply({"params": p}, jb)
        return jmse(x, jb.coord_target, jb.node_mask), (x, vx)

    (_, (xj, vj)), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    return dict(jb=jb, pb=pb, pm=pm, attention=attention, xj=np.asarray(xj),
                vj=np.asarray(vj), gj=gj)


@pytest.mark.parametrize("gravity,attention,node_attr", [
    pytest.param(GRAV, False, False, id="gravity0-False"),
    pytest.param(None, False, False, id="None-False"),
    pytest.param(GRAV, True, False, id="gravity2-True"),
    pytest.param(GRAV, False, True, id="node_attr")])
def test_weights_round_trip_bit_for_bit(gravity, attention, node_attr):
    # port -> the JAX importer -> the inverse, from a port init; and JAX
    # params -> the inverse -> the importer.  The [H, C] -> [C, H] column
    # permutation of node_mlp.0 leaves the attribute column last
    pm = FastSchNet(2, 2, gravity=gravity, attention=attention, node_attr_dim=int(node_attr),
                    device="cpu", generator=torch.Generator().manual_seed(0), **KW)
    assert pm.gcl_1.node_mlp[0].in_features == 2 * 64 + 3 * 64 + int(node_attr)
    sd = {k: v.detach().numpy() for k, v in pm.state_dict().items()}
    back = state_dict_from_fastschnet_params(to_jax(sd, has_gravity=gravity is not None,
                                                    attention=attention))
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    if node_attr:
        K = to_jax(sd)["gcl_1"]["node_mlp"]["lin0"]["kernel"]
        np.testing.assert_array_equal(K[-1], sd["gcl_1.node_mlp.0.weight"][:, -1])
    jb, _ = _batches(n_graphs=2, n_nodes=6)
    _, params, pm = _models(jb, gravity=gravity, attention=attention, options=node_attr)
    again = to_jax({k: v.detach().numpy() for k, v in pm.state_dict().items()},
                   has_gravity=gravity is not None, attention=attention)
    assert jax.tree.structure(again) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_keys_and_initialisation_follow_the_reference():
    pm = FastSchNet(2, 2, device="cpu", generator=torch.Generator().manual_seed(0), **KW)
    keys = set(pm.state_dict())
    s = "gcl_0.SchNetLayer"
    assert {f"{s}.coord_updates.0.weight", f"{s}.interactions.0.conv.nn.0.weight",
            f"{s}.interactions.0.conv.nn.2.bias", f"{s}.interactions.0.conv.lin1.weight",
            f"{s}.interactions.0.conv.lin2.bias", f"{s}.interactions.0.lin.weight"} <= keys
    # the reference's unused parameters are not there
    modules = {k.split(".")[1] for k in keys if k.startswith("gcl_")}
    assert not modules & {"coord_mlp_r", "coord_mlp_vel", "W"}
    assert not any(".SchNetLayer.lin" in k for k in keys)
    assert f"{s}.interactions.0.conv.lin1.bias" not in keys
    block = pm.gcl_0.SchNetLayer.interactions[0]
    for lin in (block.conv.nn[0], block.conv.nn[2], block.conv.lin2, block.lin):
        fan = lin.in_features + lin.out_features
        assert float(lin.weight.detach().abs().max()) <= (6 / fan) ** 0.5
        assert float(lin.weight.detach().abs().max()) > 0.5 * (6 / fan) ** 0.5
        assert not lin.bias.detach().any()


def test_shifted_softplus_matches_flax_above_20():
    # torch's softplus returns x itself above 20; flax's is logaddexp(x, 0)
    x = np.array([-40.0, -5.0, 0.0, 3.0, 19.5, 20.0, 20.5, 25.0, 60.0], np.float32)
    want = np.asarray(jschnet.shifted_softplus(jnp.asarray(x)))
    want_grad = np.asarray(jax.vmap(jax.grad(jschnet.shifted_softplus))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = pschnet.shifted_softplus(xt)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=1e-6, atol=1e-7)


def test_gaussian_smearing_matches_jax():
    d = np.random.default_rng(0).uniform(0, 12, size=(40,)).astype(np.float32)
    want = np.asarray(jschnet.gaussian_smearing(jnp.asarray(d), 0.0, 10.0, 50))
    got = pschnet.gaussian_smearing(torch.tensor(d), 0.0, 10.0, 50).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_src_segment_sum_matches_index_add():
    _, pb = _batches(n_graphs=2, n_nodes=12, seed=3)
    ne, n = pb.n_real_edges, pb.num_nodes
    gen = torch.Generator().manual_seed(0)
    data = torch.randn(ne, 7, generator=gen, requires_grad=True)
    got = spmm.src_segment_sum_csr(data, pb.src[:ne], pb.src_perm, pb.src_rowptr, n)
    ref_data = data.detach().clone().requires_grad_()
    want = torch.zeros(n, 7).index_add_(0, pb.src[:ne].long(), ref_data)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    g = torch.randn(n, 7, generator=gen)
    got.backward(g)
    want.backward(g)
    torch.testing.assert_close(data.grad, ref_data.grad, rtol=0, atol=0)
    with pytest.raises(ValueError, match="same real edges"):
        spmm.src_segment_sum_csr(data[:-1], pb.src[:ne], pb.src_perm, pb.src_rowptr, n)


# 1e-4, as for FastEGNN: the packages sum in different orders, which
# compounds over two layers (measured: 9.5e-7 on coordinates of up to 6.5)
def test_forward_matches_jax(case):
    with torch.no_grad():
        xp, vp = case["pm"](case["pb"])
    mask = np.asarray(case["jb"].node_mask)
    np.testing.assert_allclose(xp.numpy()[mask], case["xj"][mask], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vp.numpy(), case["vj"], rtol=1e-4, atol=1e-4)


# measured: 2.0e-6 (plain), 1.1e-6 (attention) of each leaf's floored scale
def test_param_gradients_of_mse_match_jax(case):
    pm, pb = case["pm"], case["pb"]
    pm.zero_grad()
    x, _ = pm(pb)
    masked_mse(x, pb.coord_target, pb.node_mask).backward()
    conv = {k for k, p in pm.named_parameters() if ".interactions." in k}
    assert all(p.grad is None for k, p in pm.named_parameters() if k in conv)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in pm.named_parameters()}
    gp = to_jax(grads, attention=case["attention"])
    assert jax.tree.structure(gp) == jax.tree.structure(case["gj"])
    gaps, _ = leaf_gaps(gp, case["gj"])
    assert max(gaps) <= 1e-4, gaps


@pytest.mark.parametrize("n_interactions", [1, 2])
def test_schnet_core_matches_jax(n_interactions):
    # FastSchNet discards the embedded SchNet's features: hold them here,
    # through the CFConv and its sum at src, with their gradients; with two
    # interactions the second gathers the moved positions afresh
    jb, pb = _batches(n_graphs=2, n_nodes=16, seed=4)
    core = jschnet.SchNetCore(hidden=64, num_interactions=n_interactions, cutoff=10.0,
                              embed_input=False)
    h = np.random.default_rng(1).normal(size=(pb.num_nodes, 64)).astype(np.float32)
    params = jax.tree.map(np.asarray, core.init(jax.random.key(0), jnp.asarray(h), jb.coord,
                                                jb)["params"])

    def jf(p, h):
        pos, hh = core.apply({"params": p}, h, jb.coord, jb)
        return (hh ** 2).sum() + (pos ** 2).sum(), (pos, hh)

    (_, (pj, hj)), (gpj, ghj) = jax.jit(jax.value_and_grad(jf, (0, 1), has_aux=True))(
        params, jnp.asarray(h))
    pm = pschnet.SchNetCore(64, num_interactions=n_interactions, cutoff=10.0)
    sd = {}
    for i in range(n_interactions):
        block, conv = params[f"interaction_{i}"], params[f"interaction_{i}"]["conv"]
        for key, lin in ((f"coord_updates.{i}", params[f"coord_update_{i}"]),
                         (f"interactions.{i}.conv.nn.0", conv["nn0"]),
                         (f"interactions.{i}.conv.nn.2", conv["nn1"]),
                         (f"interactions.{i}.conv.lin1", conv["lin1"]),
                         (f"interactions.{i}.conv.lin2", conv["lin2"]),
                         (f"interactions.{i}.lin", block["lin"])):
            sd[f"{key}.weight"] = torch.tensor(lin["kernel"].T)
            if "bias" in lin:
                sd[f"{key}.bias"] = torch.tensor(lin["bias"])
    pm.load_state_dict(sd, strict=True)
    ht = torch.tensor(h, requires_grad=True)
    pos, hh = pm(ht, pb.coord, pb)
    ((hh ** 2).sum() + (pos ** 2).sum()).backward()
    mask = np.asarray(jb.node_mask)
    np.testing.assert_allclose(pos.detach().numpy()[mask], np.asarray(pj)[mask],
                               rtol=1e-5, atol=1e-5)
    for a, b in ((hh.detach().numpy(), hj), (ht.grad.numpy(), ghj)):
        b = np.asarray(b)
        assert np.abs(a - b)[mask].max() <= 1e-5 * np.abs(b).max()
    for i in range(n_interactions):
        w = pm.interactions[i].conv.nn[0].weight.grad.numpy().T
        wj = np.asarray(gpj[f"interaction_{i}"]["conv"]["nn0"]["kernel"])
        assert np.abs(w - wj).max() <= 1e-5 * np.abs(wj).max()


@pytest.mark.parametrize("n_interactions", [1, 2])
def test_schnet_core_positions_only_skip_the_last_feature_update(n_interactions):
    # FastSchNet's mode: the same positions, bit for bit, and the last
    # interaction block (its CFConv and sum at src) never runs
    _, pb = _batches(n_graphs=2, n_nodes=16, seed=4)
    pm = pschnet.SchNetCore(64, num_interactions=n_interactions, cutoff=10.0)
    h = torch.tensor(np.random.default_rng(1).normal(size=(pb.num_nodes, 64)),
                     dtype=torch.float32)
    calls = []
    for i, block in enumerate(pm.interactions):
        block.register_forward_hook(lambda *_, i=i: calls.append(i))
    with torch.no_grad():
        pos, hh = pm(h, pb.coord, pb)
        assert calls == list(range(n_interactions)) and hh is not None
        calls.clear()
        pos_only, none = pm(h, pb.coord, pb, features=False)
    assert none is None and calls == list(range(n_interactions - 1))
    assert torch.equal(pos_only, pos)


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    return make_trio(tmp_path_factory)


# measured: gradients 5.0e-7, post-Adam parameters 7.5e-9
def test_one_train_step_with_the_shared_draw_matches_jax(trio):
    r = one_train_step(trio, JFastSchNet(**KW), FastSchNet(2, 2, device="cpu", **KW),
                       state_dict_from_fastschnet_params,
                       lambda sd: to_jax(sd, has_gravity=False))
    check_one_train_step(r)


# The logged MSEs are 1.2e-2 - 0.53.  Measured: every train, valid and
# test MSE within 5.4e-5 relative; rtol 2e-4, the FastEGNN N-body test's
def test_cli_training_tracks_the_jax_train(monkeypatch, tmp_path, trio):
    (pbest, plog), (jbest, jlog) = run_training_on_the_jax_draw(
        monkeypatch, tmp_path, trio, "FastSchNet", JFastSchNet(**KW),
        state_dict_from_fastschnet_params)
    np.testing.assert_allclose(plog["loss_train"], jlog["loss_train"], rtol=2e-4)
    np.testing.assert_allclose(plog["loss"], jlog["loss"], rtol=2e-4)
    np.testing.assert_allclose(pbest["loss_valid"], jbest["loss_valid"], rtol=2e-4)
    assert pbest["epoch_index"] == jbest["epoch_index"]


def test_se3_equivariance_without_gravity():
    _, pb = _batches(n_graphs=2, n_nodes=10, seed=11)
    mask = pb.node_mask.numpy()
    for attention in (False, True):
        pm = FastSchNet(2, 2, attention=attention, device="cpu",
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
