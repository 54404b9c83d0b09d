"""The port's TFN family (``OursTFN``, ``OurSE3Transformer``, the pooled
``TFN`` and ``SE3Transformer``, and ``OurDynamics``, the CLIs' ``--model
TFN``) against the JAX package on the same weights and inputs.

Weights cross through ``utils/weights.py``'s converters and back through
``test_torch_port_tfn_layers.py::to_jax``; the inputs are that file's
graphs (2 x 8 nodes and a padded node each, 70% of the directed edges,
every node keeping an edge at src: reference defect 9).  Widths 4, 2-3
layers, f32.

The models are held against the JAX function evaluated in f64
(:func:`jax64`): forward within 1e-5 of the largest value, gradients
within 1e-4 of each leaf's floored scale.  Through two or more layers the
radial MLPs' LayerNorms, each over 32 affine functions of one distance,
make the f32 gradients ill-conditioned: measured against the f64
evaluation, the JAX f32 gradients are up to 8.8e-5 off and the port's
2.6e-5 (``OursTFN`` with degree 2 and edge features), so no f32 pair can
be held at 1e-5 (the layers are, in ``test_torch_port_tfn_layers.py``).
Training is held on the N-body data of ``tests/test_torch_port_nbody.py``
against the JAX f32 step and ``train()``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastegnn_tpu.models.tfn import models as jmodels
from fastegnn_tpu.train.loss import masked_mse as jmse
from fastegnn_tpu_torch.models import MMD_MODELS, get_model
from fastegnn_tpu_torch.models.tfn import models as pmodels
from fastegnn_tpu_torch.ops.rotation import random_rotation
from fastegnn_tpu_torch.train.loss import masked_mse
from fastegnn_tpu_torch.utils.weights import (
    state_dict_from_gconv_params, state_dict_from_ourdynamics_params,
    state_dict_from_se3transformer_params, state_dict_from_tfn_params)

from test_torch_port_nbody import (
    check_one_train_step, one_train_step, run_training_on_the_jax_draw)
from test_torch_port_tfn_layers import (
    FWD_TOL, GRAD_TOL, batches, check_grads, port_grads, raws, to_jax)

NF, LAYERS = 4, 2
MODEL_GRAD_TOL = 1e-4


def _numpy(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def _init(jm, *args):
    return jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0), *args)["params"])


@pytest.fixture(scope="module")
def graphs():
    return raws()


@pytest.fixture(scope="module")
def batch(graphs):
    return batches(graphs)


def jax64(fn, *args):
    """``fn(*args)`` evaluated by JAX in f64 (the f32 leaves of ``args``
    cast up), as a tree of numpy arrays."""
    def up(tree):
        return jax.tree.map(lambda a: np.asarray(a, np.float64)
                            if np.asarray(a).dtype == np.float32 else a, tree)

    with jax.enable_x64():
        return jax.tree.map(np.asarray, jax.jit(fn)(*(up(a) for a in args)))


def _gap(got, want, mask):
    """Max |got - want| over the masked rows, over the largest |want|."""
    want = np.asarray(want)[mask]
    return float(np.abs(got[mask] - want).max() / np.abs(want).max())


# --- OurDynamics (--model TFN), both kinds ------------------------------------


@pytest.fixture(scope="module", params=["tfn", "se3_transformer"])
def dynamics(request, batch):
    """The JAX OurDynamics' positions and MSE gradients, and the port model
    with the same weights."""
    jb, pb = batch
    jm = jmodels.OurDynamics(nf=NF, n_layers=LAYERS, model=request.param)
    params = _init(jm, jb)

    def jloss(p, g):
        x = jm.apply({"params": p}, g)
        return jmse(x, g.coord_target, g.node_mask), x

    (_, xj), gj = jax64(jax.value_and_grad(jloss, has_aux=True), params, jb)
    pm = pmodels.OurDynamics(2, 2, nf=NF, n_layers=LAYERS, model=request.param, device="cpu")
    pm.load_state_dict(state_dict_from_ourdynamics_params(params), strict=True)
    return dict(kind=request.param, params=params, pm=pm, xj=xj, gj=gj)


def test_our_dynamics_forward_matches_jax(dynamics, batch):
    jb, pb = batch
    with torch.no_grad():
        x = dynamics["pm"](pb).numpy()
    assert _gap(x, dynamics["xj"], np.asarray(jb.node_mask)) <= FWD_TOL


def test_our_dynamics_mse_gradients_match_jax(dynamics, batch):
    _, pb = batch
    pm = dynamics["pm"]
    pm.zero_grad()
    masked_mse(pm(pb), pb.coord_target, pb.node_mask).backward()
    check_grads(port_grads(pm), dynamics["gj"], tol=MODEL_GRAD_TOL)


def test_a_flipped_tfn_edge_direction_fails_the_forward_test(dynamics, graphs, batch):
    # the batch with src and dst swapped: features gathered at src, summed
    # at dst, x[dst] - x[src]; equivariant still, so only the comparison
    # with the JAX model sees it
    jb, _ = batch
    _, flipped = batches(graphs, flip=True)
    with torch.no_grad():
        x = dynamics["pm"](flipped).numpy()
    assert _gap(x, dynamics["xj"], np.asarray(jb.node_mask)) > 100 * FWD_TOL


def test_our_dynamics_is_se3_equivariant(dynamics, batch):
    _, pb = batch
    R = torch.tensor(random_rotation(np.random.default_rng(3)), dtype=torch.float32)
    t = torch.tensor([0.3, -1.2, 0.7])
    moved = dataclasses.replace(pb, coord=pb.coord @ R + t, vel=pb.vel @ R)
    with torch.no_grad():
        x0, x1 = dynamics["pm"](pb), dynamics["pm"](moved)
    mask = pb.node_mask
    torch.testing.assert_close(x1[mask], (x0 @ R + t)[mask], rtol=0, atol=1e-5)


# --- the inner models at other configurations ---------------------------------


@pytest.mark.parametrize("num_layers,num_degrees,edge_dim", [(2, 3, 2), (3, 2, 0)])
def test_ours_tfn_matches_jax(batch, num_layers, num_degrees, edge_dim):
    jb, pb = batch
    kw = dict(num_layers=num_layers, num_channels=NF, num_degrees=num_degrees,
              edge_dim=edge_dim, in_types=((2, 0), (1, 1)), out_types=((2, 0), (1, 1)))
    rng = np.random.default_rng(20)
    h = {0: rng.normal(size=(pb.num_nodes, 2, 1)).astype(np.float32),
         1: rng.normal(size=(pb.num_nodes, 1, 3)).astype(np.float32)}
    hj = {d: jnp.asarray(v) for d, v in h.items()}
    jm = jmodels.OursTFN(**kw)
    params = _init(jm, hj, jb)
    mask = np.asarray(jb.node_mask)

    def jloss(p, hj, g):
        out = jm.apply({"params": p}, hj, g)
        return sum(jnp.sum(jnp.where(g.node_mask[:, None, None], v, 0.0) ** 2)
                   for v in out.values()), out

    (_, want), gj = jax64(jax.value_and_grad(jloss, has_aux=True), params, hj, jb)
    pm = pmodels.OursTFN(**kw)
    pm.load_state_dict(state_dict_from_gconv_params(params), strict=True)
    assert len([k for k in params if k.startswith("norm_")]) == num_layers - 1
    got = pm({d: torch.tensor(v) for d, v in h.items()}, pb)
    top = max(float(np.abs(np.asarray(v)[mask]).max()) for v in want.values())
    for d in want:
        np.testing.assert_allclose(got[d].detach().numpy()[mask], np.asarray(want[d])[mask],
                                   rtol=0, atol=FWD_TOL * top, err_msg=f"degree {d}")
    sum((v[torch.tensor(mask)] ** 2).sum() for v in got.values()).backward()
    check_grads(port_grads(pm), gj, tol=MODEL_GRAD_TOL)


def test_our_se3_transformer_with_two_heads_matches_jax(batch):
    jb, pb = batch
    kw = dict(num_layers=2, num_channels=NF, num_degrees=2, n_heads=2)
    rng = np.random.default_rng(21)
    h = {0: rng.normal(size=(pb.num_nodes, 1, 1)).astype(np.float32),
         1: rng.normal(size=(pb.num_nodes, 1, 3)).astype(np.float32)}
    hj = {d: jnp.asarray(v) for d, v in h.items()}
    jm = jmodels.OurSE3Transformer(**kw)
    params = _init(jm, hj, jb)
    mask = np.asarray(jb.node_mask)

    def jloss(p, hj, g):
        out = jm.apply({"params": p}, hj, g)[1]
        return jnp.sum(jnp.where(g.node_mask[:, None, None], out, 0.0) ** 2), out

    (_, want), gj = jax64(jax.value_and_grad(jloss, has_aux=True), params, hj, jb)
    pm = pmodels.OurSE3Transformer(**kw)
    pm.load_state_dict(state_dict_from_gconv_params(params), strict=True)
    assert float(pm.scalar_trick.detach()) == pytest.approx(0.01)
    got = pm({d: torch.tensor(v) for d, v in h.items()}, pb)[1]
    assert _gap(got.detach().numpy(), want, mask) <= FWD_TOL
    (got[torch.tensor(mask)] ** 2).sum().backward()
    check_grads(port_grads(pm), gj, tol=MODEL_GRAD_TOL)


# the JAX SE3Transformer at its default div = 4 (4 channels: 1 per degree
# after the attention, broadcast by the next layer, reference defect 10)
# and at div = 1
@pytest.mark.parametrize("name,kw", [("TFN", dict(num_degrees=3)),
                                     ("SE3Transformer", dict(num_degrees=2, div=1)),
                                     ("SE3Transformer", dict(num_degrees=2))])
def test_pooled_models_match_jax(batch, name, kw):
    jb, pb = batch
    jm = getattr(jmodels, name)(num_layers=2, atom_feature_size=2, num_channels=NF, **kw)
    params = _init(jm, jb.node_feat, jb)
    y = np.random.default_rng(22).normal(size=(2, 1)).astype(np.float32)

    def jloss(p, g):
        out = jm.apply({"params": p}, g.node_feat, g)
        return jnp.sum((out - y) ** 2), out

    (_, want), gj = jax64(jax.value_and_grad(jloss, has_aux=True), params, jb)
    pm = getattr(pmodels, name)(2, 2, NF, device="cpu", **kw)
    convert = state_dict_from_tfn_params if name == "TFN" else state_dict_from_se3transformer_params
    pm.load_state_dict(convert(params), strict=True)
    got = pm(pb.node_feat, pb)
    assert got.shape == (2, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=FWD_TOL * float(np.abs(np.asarray(want)).max()))
    ((got - torch.tensor(y)) ** 2).sum().backward()
    check_grads(port_grads(pm), gj, tol=MODEL_GRAD_TOL)


# --- weights, registry, the zero-feature gradient -------------------------------


@pytest.mark.parametrize("name", ["tfn", "se3_transformer", "TFN", "SE3Transformer"])
def test_weights_round_trip_bit_for_bit(batch, name):
    # port -> to_jax -> converter, from a port init; and JAX params ->
    # converter -> to_jax
    jb, _ = batch
    gen = torch.Generator().manual_seed(0)
    if name in ("tfn", "se3_transformer"):
        pm = pmodels.OurDynamics(2, 2, nf=NF, n_layers=2, model=name, device="cpu",
                                 generator=gen)
        jm, args, convert = (jmodels.OurDynamics(nf=NF, n_layers=2, model=name), (jb,),
                             state_dict_from_ourdynamics_params)
    else:
        pm = getattr(pmodels, name)(2, 2, NF, num_degrees=2, device="cpu", generator=gen)
        jm = getattr(jmodels, name)(num_layers=2, atom_feature_size=2, num_channels=NF,
                                    num_degrees=2)
        args = (jb.node_feat, jb)
        convert = (state_dict_from_tfn_params if name == "TFN"
                   else state_dict_from_se3transformer_params)
    sd = _numpy(pm.state_dict())
    back = convert(to_jax(sd))
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    params = _init(jm, *args)
    pm.load_state_dict(convert(params), strict=True)
    again = to_jax(_numpy(pm.state_dict()))
    assert jax.tree.structure(again) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_get_model_builds_the_clis_tfn():
    m = get_model("TFN", 2, 2, hidden=64, virtual_channels=3, n_layers=3, num_blocks=3,
                  device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(m, pmodels.OurDynamics) and isinstance(m.se3, pmodels.OursTFN)
    assert m.se3.num_layers == 3 and m.se3.max_degree == 1
    assert m.se3.conv_1.core.pair_1_1.rp.lin2.out_features == 3 * 32 * 32   # nf = 32
    assert not hasattr(m.se3, "conv_2") and "TFN" not in MMD_MODELS
    # no bf16 path: built in float32 when bf16 is asked for, as in JAX
    m = get_model("TFN", 2, 2, compute_dtype=torch.bfloat16, device="cpu")
    assert all(p.dtype == torch.float32 for p in m.parameters())


def test_the_zero_feature_gradient_is_finite_in_the_port():
    # reference defect 9: batch node 0 without an edge at src has zero
    # features after each convolution, and the JAX norm layer's gradient
    # there is NaN; it reaches the parameters through the padded edges,
    # whose src is node 0.  The port's gradient is finite and its forward
    # still matches
    rs = raws(seed=6)
    r0 = rs[0]
    keep = r0["src"] != 0
    rs[0] = {**r0, "dst": r0["dst"][keep], "src": r0["src"][keep],
             "edge_attr": r0["edge_attr"][keep]}
    jb, pb = batches(rs)
    jm = jmodels.OurDynamics(nf=NF, n_layers=LAYERS)
    params = _init(jm, jb)

    def jloss(p):
        x = jm.apply({"params": p}, jb)
        return jmse(x, jb.coord_target, jb.node_mask), x

    (_, xj), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    assert not all(np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(gj))
    pm = pmodels.OurDynamics(2, 2, nf=NF, n_layers=LAYERS, device="cpu")
    pm.load_state_dict(state_dict_from_ourdynamics_params(params), strict=True)
    x = pm(pb)
    assert _gap(x.detach().numpy(), xj, np.asarray(jb.node_mask)) <= FWD_TOL
    masked_mse(x, pb.coord_target, pb.node_mask).backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in pm.parameters())


# --- training on the N-body data ----------------------------------------------


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    from test_torch_port_nbody import make_trio

    return make_trio(tmp_path_factory)


def test_one_train_step_matches_jax(trio):
    # the MSE alone, as the CLIs train TFN
    r = one_train_step(trio, jmodels.OurDynamics(nf=8, n_layers=2),
                       pmodels.OurDynamics(2, 2, nf=8, n_layers=2, device="cpu"),
                       state_dict_from_ourdynamics_params, to_jax, use_mmd=False)
    check_one_train_step(r, grad_tol=GRAD_TOL)


# rtol 2e-4, the FastEGNN N-body test's; the CLI's TFN (nf = 32, 2 layers)
def test_cli_training_tracks_the_jax_train(monkeypatch, tmp_path, trio):
    (pbest, plog), (jbest, jlog) = run_training_on_the_jax_draw(
        monkeypatch, tmp_path, trio, "TFN", jmodels.OurDynamics(n_layers=2),
        state_dict_from_ourdynamics_params)
    np.testing.assert_allclose(plog["loss_train"], jlog["loss_train"], rtol=2e-4)
    np.testing.assert_allclose(plog["loss"], jlog["loss"], rtol=2e-4)
    np.testing.assert_allclose(pbest["loss_valid"], jbest["loss_valid"], rtol=2e-4)
    assert pbest["epoch_index"] == jbest["epoch_index"]
