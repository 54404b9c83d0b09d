"""The port's FastTFN and the TFN parts it is built from against the JAX
package on the same weights and inputs.

Weights cross from JAX params to the port through
``state_dict_from_fasttfn_params`` (the JAX package has no FastTFN
importer) and back through :func:`to_jax` here.  Model inputs are 3 graphs
x 24 nodes (``helpers.random_raw_graph``) with a random 30% of the directed
edges dropped, so that the edge set is not symmetric: on a symmetric edge
set a TFN whose edge direction is flipped computes the same sums, and no
test could tell the flip.  H=64, C=3, L=2, f32; the model also with
``residual=False``, which no CLI sets.  Training is held on the N-body data
of ``tests/test_torch_port_nbody.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastegnn_tpu.graph import GraphSpec as JSpec, batch_graphs as jbatch, pad_graph as jpad
from fastegnn_tpu.models import FastTFN as JFastTFN
from fastegnn_tpu.models.tfn import layers as jlayers, so3 as jso3
from fastegnn_tpu.models.tfn.models import _edge_geometry as jgeometry
from fastegnn_tpu.train.loss import masked_mse as jmse
from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph
from fastegnn_tpu_torch.models import FastTFN
from fastegnn_tpu_torch.models.tfn import layers as players, so3 as pso3
from fastegnn_tpu_torch.models.tfn.models import OursTFN, edge_geometry
from fastegnn_tpu_torch.ops.rotation import random_rotation
from fastegnn_tpu_torch.train.loss import masked_mse
from fastegnn_tpu_torch.utils.weights import (
    state_dict_from_fasttfn_params, state_dict_from_gconv_params)

from helpers import random_raw_graph
from test_torch_port_nbody import (
    check_one_train_step, leaf_gaps, make_trio, one_train_step,
    run_training_on_the_jax_draw)

GRAV = (0.0, -1.0, 0.0)
KW = dict(hidden=64, virtual_channels=3, n_layers=2)


def _raws(n_graphs=3, n_nodes=24, seed=5):
    """Raw graphs with a random 70% of their directed edges."""
    rng = np.random.default_rng(seed)
    raws = []
    for _ in range(n_graphs):
        r = random_raw_graph(rng, n_nodes)
        keep = rng.random(r["dst"].shape[0]) < 0.7
        raws.append({**r, "dst": r["dst"][keep], "src": r["src"][keep],
                     "edge_attr": r["edge_attr"][keep]})
    return raws


def _batches(raws, flip=False):
    """The JAX and the port batch of ``raws``; with ``flip`` the port batch
    has every edge's src and dst swapped."""
    n = raws[0]["coord"].shape[0]
    kw = dict(max_nodes=n, max_edges=n * (n - 1), n_graphs=len(raws), edge_attr_dim=2,
              virtual_channels=3)
    js, ps = JSpec(**kw), GraphSpec(**kw)
    prs = [{**r, "dst": r["src"], "src": r["dst"]} for r in raws] if flip else raws
    return (jbatch([jpad(js, **r) for r in raws], js),
            batch_graphs([pad_graph(ps, **r) for r in prs], ps, device="cpu"))


def _gconv_to_jax(sd, prefix):
    """The port ``GConvSE3`` weights under ``prefix`` -> a JAX tree."""
    core = {}
    for k, v in sd.items():
        if not k.startswith(prefix + "core."):
            continue
        name, *rest = k[len(prefix) + 5:].split(".")
        if name.startswith("self_"):
            core[name] = np.asarray(v)
            continue
        _, layer, field = rest                              # rp.{lin,bn}{i}.{weight,bias}
        leaf = core.setdefault(name, {"rp": {}})["rp"].setdefault(layer, {})
        if layer.startswith("lin"):
            leaf["kernel" if field == "weight" else "bias"] = (
                np.asarray(v).T if field == "weight" else np.asarray(v))
        else:
            leaf["scale" if field == "weight" else "bias"] = np.asarray(v)
    return {"core": core}


def to_jax(sd, n_layers=2, H=64, C=3):
    """A port ``state_dict``-shaped dict of numpy arrays -> JAX ``FastTFN``
    params: the inverse of ``state_dict_from_fasttfn_params``."""
    def lin(k, bias=True):
        out = {"kernel": np.asarray(sd[f"{k}.weight"]).T}
        if bias:
            out["bias"] = np.asarray(sd[f"{k}.bias"])
        return out

    p = {"embedding_in": lin("embedding_in"),
         "virtual_node_feat": np.transpose(np.asarray(sd["virtual_node_feat"]), (0, 2, 1))}
    for i in range(n_layers):
        g, layer = f"gcl_{i}", {}
        for name in ("edge_mlp", "edge_mlp_virtual", "gravity_mlp", "node_mlp_virtual"):
            if f"{g}.{name}.0.weight" in sd:
                layer[name] = {"lin0": lin(f"{g}.{name}.0"), "lin1": lin(f"{g}.{name}.2")}
        for name in ("coord_mlp_r_virtual", "coord_mlp_v_virtual"):
            layer[name] = {"lin0": lin(f"{g}.{name}.0"), "head": lin(f"{g}.{name}.2", False)}
        node0 = lin(f"{g}.node_mlp.0")
        K = node0["kernel"]
        virt = K[2 * H:2 * H + C * H].reshape(H, C, -1).transpose(1, 0, 2).reshape(C * H, -1)
        node0["kernel"] = np.concatenate([K[:2 * H], virt, K[2 * H + C * H:]], 0)
        layer["node_mlp"] = {"lin0": node0, "lin1": lin(f"{g}.node_mlp.2")}
        for name in ("att_mlp", "att_mlp_virtual"):
            if f"{g}.{name}.0.weight" in sd:
                layer[name] = lin(f"{g}.{name}.0")
        layer["tfn_layer"] = {"conv_out": _gconv_to_jax(sd, f"{g}.tfn_layer.conv_out.")}
        p[g] = layer
    return p


def _numpy(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def _models(jb, gravity=GRAV, attention=False, residual=True):
    jm = JFastTFN(gravity=gravity, attention=attention, residual=residual, **KW)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jb)["params"])
    pm = FastTFN(2, 2, gravity=gravity, attention=attention, residual=residual, device="cpu",
                 **KW)
    pm.load_state_dict(state_dict_from_fasttfn_params(params), strict=True)
    return jm, params, pm


# --- SO(3) tables, harmonics and basis ----------------------------------------


def test_real_clebsch_gordan_tables_are_the_jax_tables_exactly():
    for j1 in range(4):
        for j2 in range(4):
            for j3 in range(abs(j1 - j2), min(j1 + j2, 3) + 1):
                np.testing.assert_array_equal(pso3.clebsch_gordan(j1, j2, j3),
                                              jso3.clebsch_gordan(j1, j2, j3))
                np.testing.assert_array_equal(pso3.real_clebsch_gordan(j1, j2, j3),
                                              jso3.real_clebsch_gordan(j1, j2, j3))


def _directions(seed=0):
    """Random vectors, and vectors along +z and -z, near z and zero, where
    the clamps and the ``rxy > eps`` branch decide the values."""
    rng = np.random.default_rng(seed)
    special = [[0, 0, 1], [0, 0, -1], [0, 0, 2.5], [0, 0, -0.3], [1e-7, 0, 1],
               [0, -1e-7, -1], [0, 0, 0]]
    return np.concatenate([rng.normal(size=(64, 3)), special]).astype(np.float32)


# values are O(1); both evaluate the same f32 recursions
@pytest.mark.parametrize("l_max", [2, 4])
def test_real_sph_harm_all_matches_jax(l_max):
    vec = _directions()
    want = jso3.real_sph_harm_all(l_max, jnp.asarray(vec))
    got = pso3.real_sph_harm_all(l_max, torch.tensor(vec))
    assert sorted(got) == sorted(want) == list(range(l_max + 1))
    for l in want:
        assert got[l].shape == (vec.shape[0], 2 * l + 1)
        np.testing.assert_allclose(got[l].numpy(), np.asarray(want[l]), rtol=0, atol=1e-6,
                                   err_msg=f"l={l}")


@pytest.mark.parametrize("max_degree", [1, 2])
def test_compute_basis_matches_jax(max_degree):
    vec = _directions(1)
    want = jlayers.compute_basis(jnp.asarray(vec), max_degree)
    got = players.compute_basis(torch.tensor(vec), max_degree)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6,
                                   err_msg=str(k))


# --- the convolution ----------------------------------------------------------

F_IN, F_OUT = ((2, 0), (3, 1)), ((2, 0), (2, 1), (1, 2))


# the sums run in different orders: measured below 1e-6 of the largest
# output; gradients against their floored scale as for the models
@pytest.mark.parametrize("edge_dim", [0, 2])
def test_gconv_se3_matches_jax(edge_dim):
    jb, pb = _batches(_raws(n_graphs=2, n_nodes=12, seed=7))
    rng = np.random.default_rng(8)
    h = {d: rng.normal(size=(pb.num_nodes, m, 2 * d + 1)).astype(np.float32) for m, d in F_IN}
    jconv = jlayers.GConvSE3(F_IN, F_OUT, self_interaction=True, edge_dim=edge_dim)
    r_j, basis_j = jgeometry(jb, 2)
    hj = {d: jnp.asarray(v) for d, v in h.items()}
    params = jax.tree.map(np.asarray, jconv.init(jax.random.key(1), hj, jb, r_j, basis_j)["params"])
    mask = np.asarray(jb.node_mask)

    def jloss(p, hj):
        out = jconv.apply({"params": p}, hj, jb, r_j, basis_j)
        return sum(jnp.sum(jnp.where(jb.node_mask[:, None, None], v, 0.0) ** 2)
                   for v in out.values()), out

    (_, want), (gp_j, gh_j) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, hj)

    pconv = players.GConvSE3(F_IN, F_OUT, self_interaction=True, edge_dim=edge_dim)
    pconv.load_state_dict(state_dict_from_gconv_params(params), strict=True)
    hp = {d: torch.tensor(v, requires_grad=True) for d, v in h.items()}
    r, basis = edge_geometry(pb, 2)
    got = pconv(hp, pb, r, basis)
    assert got.keys() == want.keys()
    top = max(float(np.abs(np.asarray(v)[mask]).max()) for v in want.values())
    for d in want:
        np.testing.assert_allclose(got[d].detach().numpy()[mask], np.asarray(want[d])[mask],
                                   rtol=0, atol=1e-5 * top, err_msg=f"degree {d}")
    sum((v[torch.tensor(mask)] ** 2).sum() for v in got.values()).backward()
    gp = _gconv_to_jax({k: p.grad.numpy() for k, p in pconv.named_parameters()}, "")
    assert jax.tree.structure(gp) == jax.tree.structure(gp_j)
    gaps, _ = leaf_gaps(gp, gp_j)
    assert max(gaps) <= 1e-4, gaps
    gaps, _ = leaf_gaps({d: hp[d].grad.numpy()[mask] for d in hp},
                        {d: np.asarray(gh_j[d])[mask] for d in hp})
    assert max(gaps) <= 1e-4, gaps


# --- the model ----------------------------------------------------------------


@pytest.mark.parametrize("gravity,attention", [(GRAV, False), (None, False), (GRAV, True)])
def test_weights_round_trip_bit_for_bit(gravity, attention):
    # port -> to_jax -> state_dict_from_fasttfn_params, from a port init;
    # and JAX params -> state_dict_from_fasttfn_params -> to_jax
    pm = FastTFN(2, 2, gravity=gravity, attention=attention, device="cpu",
                 generator=torch.Generator().manual_seed(0), **KW)
    sd = _numpy(pm.state_dict())
    back = state_dict_from_fasttfn_params(to_jax(sd))
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    jb, _ = _batches(_raws(n_graphs=2, n_nodes=6))
    _, params, pm = _models(jb, gravity=gravity, attention=attention)
    again = to_jax(_numpy(pm.state_dict()))
    assert jax.tree.structure(again) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_keys_and_initialisation_follow_the_jax_model():
    pm = FastTFN(2, 2, device="cpu", generator=torch.Generator().manual_seed(0), **KW)
    keys = set(pm.state_dict())
    c = "gcl_0.tfn_layer.conv_out.core"
    assert {f"{c}.pair_0_1.rp.lin0.weight", f"{c}.pair_1_1.rp.bn0.weight",
            f"{c}.pair_1_1.rp.lin2.bias", f"{c}.self_1", "gcl_1.node_mlp.0.weight",
            "virtual_node_feat"} <= keys
    assert not any(k.startswith("gcl_0.coord_mlp_r.") or "coord_mlp_vel" in k for k in keys)
    rp = pm.gcl_0.tfn_layer.conv_out.core.pair_1_1.rp
    assert rp.lin2.out_features == 3 and pm.gcl_0.tfn_layer.conv_out.core.self_1.shape == (1, 1)
    for lin in (rp.lin0, rp.lin1, rp.lin2):   # He-uniform: bound sqrt(6 / fan_in)
        bound = (6 / lin.in_features) ** 0.5
        w = lin.weight.detach()
        assert float(w.abs().max()) <= bound and float(w.std()) > bound / 4
    assert torch.equal(rp.bn0.weight, torch.ones(32)) and rp.bn0.eps == 1e-5
    assert tuple(pm.virtual_node_feat.shape) == (1, 64, 3)


@pytest.fixture(scope="module")
def raws():
    return _raws()


@pytest.fixture(scope="module", params=["plain", "attention", "options"])
def case(request, raws):
    """The JAX forward and MSE parameter gradients, and the port model with
    the same weights, with gravity: without and with attention, and with
    ``residual=False``."""
    jb, pb = _batches(raws)
    attention = request.param == "attention"
    jm, params, pm = _models(jb, attention=attention, residual=request.param != "options")

    def jloss(p):
        x, vx = jm.apply({"params": p}, jb)
        return jmse(x, jb.coord_target, jb.node_mask), (x, vx)

    (_, (xj, vj)), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    return dict(jb=jb, pb=pb, pm=pm, xj=np.asarray(xj), vj=np.asarray(vj), gj=gj)


def _forward_gaps(case, pb):
    """Max |port - JAX| of the masked positions and of the virtual
    positions, each over the largest JAX value."""
    with torch.no_grad():
        xp, vp = case["pm"](pb)
    mask = np.asarray(case["jb"].node_mask)
    xj, vj = case["xj"][mask], case["vj"]
    return (float(np.abs(xp.numpy()[mask] - xj).max() / np.abs(xj).max()),
            float(np.abs(vp.numpy() - vj).max() / np.abs(vj).max()))


# 1e-5 of the largest value: the packages sum in different orders
# (measured: 1.5e-7 of the positions, 5e-10 of the virtual positions)
def test_forward_matches_jax(case):
    gx, gv = _forward_gaps(case, case["pb"])
    assert gx <= 1e-5 and gv <= 1e-5, (gx, gv)


def test_a_flipped_tfn_edge_direction_fails_the_forward_test(case, raws, monkeypatch):
    # the same model with its TFN handed the batch with src and dst swapped:
    # features gathered at src, averaged at dst, x[dst] - x[src].  It stays
    # equivariant; only the comparison with the JAX model sees the flip
    _, flipped = _batches(raws, flip=True)
    forward = OursTFN.forward
    monkeypatch.setattr(OursTFN, "forward",
                        lambda self, h, graph, inputs=None: forward(self, h, flipped))
    gx, _ = _forward_gaps(case, case["pb"])
    assert gx > 100 * 1e-5, gx


# 1e-4 of each leaf's floored scale, as for FastRF and FastSchNet
# (measured: 1.7e-6 plain, 4.4e-6 with attention)
def test_param_gradients_of_mse_match_jax(case):
    pm, pb = case["pm"], case["pb"]
    pm.zero_grad()
    x, _ = pm(pb)
    masked_mse(x, pb.coord_target, pb.node_mask).backward()
    # the last layer's edge MLP and feature updates do not reach the
    # positions: no gradient in the port, zeros in JAX
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in pm.named_parameters()}
    gp = to_jax(grads)
    assert jax.tree.structure(gp) == jax.tree.structure(case["gj"])
    gaps, _ = leaf_gaps(gp, case["gj"])
    assert max(gaps) <= 1e-4, gaps


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    return make_trio(tmp_path_factory)


def test_one_train_step_with_the_shared_draw_matches_jax(trio):
    r = one_train_step(trio, JFastTFN(**KW), FastTFN(2, 2, device="cpu", **KW),
                       state_dict_from_fasttfn_params, to_jax)
    check_one_train_step(r)


# rtol 2e-4, the FastEGNN N-body test's
def test_cli_training_tracks_the_jax_train(monkeypatch, tmp_path, trio):
    (pbest, plog), (jbest, jlog) = run_training_on_the_jax_draw(
        monkeypatch, tmp_path, trio, "FastTFN", JFastTFN(**KW), state_dict_from_fasttfn_params)
    np.testing.assert_allclose(plog["loss_train"], jlog["loss_train"], rtol=2e-4)
    np.testing.assert_allclose(plog["loss"], jlog["loss"], rtol=2e-4)
    np.testing.assert_allclose(pbest["loss_valid"], jbest["loss_valid"], rtol=2e-4)
    assert pbest["epoch_index"] == jbest["epoch_index"]


def test_se3_equivariance_without_gravity(raws):
    _, pb = _batches(raws[:2])
    mask = pb.node_mask.numpy()
    for attention in (False, True):
        pm = FastTFN(2, 2, attention=attention, device="cpu",
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
