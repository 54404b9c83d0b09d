"""The port's GVP against the JAX GVPNet on the same weights, and the parts
it is built from.

Weights cross through the reference state-dict layout: JAX params ->
``state_dict_from_gvpnet_params`` -> port, and back through
``params_from_gvpnet_state_dict``.  Inputs are 3 graphs x 12 nodes with a
random 30% of the directed edges dropped (``_batches``; a message that
swapped its dst and src ends would pass on a symmetric edge set), f32.  The
whole-model tests run at narrow widths (node (16, 4), edge (8, 2), 2
layers); the N-body CLI test at the CLI's (100, 16) / (32, 4) and 2 layers.
Training is held on the N-body data of ``tests/test_torch_port_nbody.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastegnn_tpu.graph import GraphSpec as JSpec, batch_graphs as jbatch, pad_graph as jpad
from fastegnn_tpu.models import gvp as jgvp
from fastegnn_tpu.train.loss import masked_mse as jmse
from fastegnn_tpu.utils.torch_import import params_from_gvpnet_state_dict
from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph
from fastegnn_tpu_torch.models import gvp as pgvp
from fastegnn_tpu_torch.models.gvp import GVPNet
from fastegnn_tpu_torch.ops.rotation import random_rotation
from fastegnn_tpu_torch.train.loss import masked_mse
from fastegnn_tpu_torch.utils.weights import state_dict_from_gvpnet_params

from helpers import random_raw_graph
from test_torch_port_nbody import (
    check_one_train_step, leaf_gaps, one_train_step, run_training_on_the_jax_draw)

KW = dict(n_layers=2, node_h_dim=(16, 4), edge_h_dim=(8, 2))


def _batches(n_graphs=3, n_nodes=12, seed=5, drop=0.3):
    rng = np.random.default_rng(seed)
    raws = []
    for _ in range(n_graphs):
        r = random_raw_graph(rng, n_nodes)
        keep = rng.random(r["dst"].shape[0]) >= drop
        for k in ("dst", "src", "edge_attr"):
            r[k] = r[k][keep]
        raws.append(r)
    kw = dict(max_nodes=n_nodes, max_edges=n_nodes * (n_nodes - 1), n_graphs=n_graphs,
              edge_attr_dim=2)
    js, ps = JSpec(**kw), GraphSpec(**kw)
    return (jbatch([jpad(js, **r) for r in raws], js),
            batch_graphs([pad_graph(ps, **r) for r in raws], ps, device="cpu"))


def _sd_numpy(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _models(jb, **kw):
    kw = {**KW, **kw}
    jm = jgvp.GVPNet(**kw)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0), jb)["params"])
    pm = GVPNet(2, 2, device="cpu", **kw)
    pm.load_state_dict(state_dict_from_gvpnet_params(params), strict=True)
    return jm, params, pm


@pytest.fixture(scope="module")
def case():
    """The JAX forward and MSE parameter gradients, and the port model with
    the same weights."""
    jb, pb = _batches()
    jm, params, pm = _models(jb)

    def jloss(p):
        x, out = jm.apply({"params": p}, jb)
        return jmse(x, jb.coord_target, jb.node_mask), (x, out)

    (_, (xj, outj)), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    return dict(jb=jb, pb=pb, pm=pm, xj=np.asarray(xj), sj=np.asarray(outj[0]),
                vj=np.asarray(outj[1]), gj=gj)


def test_weights_round_trip_bit_for_bit():
    # port -> the JAX importer -> the inverse, from a port init; and JAX
    # params -> the inverse -> the importer; at the CLI's widths
    pm = GVPNet(2, 2, n_layers=2, device="cpu", generator=torch.Generator().manual_seed(0))
    sd = _sd_numpy(pm)
    back = state_dict_from_gvpnet_params(params_from_gvpnet_state_dict(sd, n_layers=2))
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    jb, _ = _batches(n_graphs=2, n_nodes=6)
    _, params, pm = _models(jb, node_h_dim=(100, 16), edge_h_dim=(32, 4))
    again = params_from_gvpnet_state_dict(_sd_numpy(pm), n_layers=2)
    assert jax.tree.structure(again) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_keys_follow_the_reference():
    pm = GVPNet(2, 2, n_layers=2, device="cpu")
    keys = set(pm.state_dict())
    assert {"W_v.0.scalar_norm.weight", "W_v.1.wh.weight", "W_v.1.ws.bias", "W_v.1.wv.weight",
            "W_e.0.scalar_norm.bias", "W_e.1.ws.weight", "W_out.1.wv.weight",
            "layers.0.conv.message_func.0.wh.weight", "layers.1.conv.message_func.2.ws.bias",
            "layers.1.norm.1.scalar_norm.weight", "layers.0.ff_func.1.wv.weight"} <= keys
    # no bias on wh / wv, no dense head
    assert not any(k.endswith(("wh.bias", "wv.bias")) or k.startswith("dense") for k in keys)
    # the first message GVP reads [s_dst, e_s, s_src] / [V_dst, e_V, V_src]
    cell = pm.layers[0].conv.message_func[0]
    assert cell.wh.in_features == 2 * 16 + 4 and cell.ws.in_features == 2 * 100 + 32 + 36


def _cell_sd(p, prefix=""):
    return {f"{prefix}{name}.{'weight' if kind == 'kernel' else 'bias'}":
            torch.tensor(np.asarray(a).T if kind == "kernel" else np.asarray(a))
            for name, lin in p.items() for kind, a in lin.items()}


def _held(jf, jparams, jinputs, pf, weights):
    """Forward within 1e-5 of the largest value and the gradients of a
    random weighting of the outputs (parameters and inputs) within 1e-4 of
    their floored scale; ``pf(torch inputs)`` runs the port module with the
    JAX weights loaded."""
    outs = jax.jit(jf)(jparams, *jinputs)
    cot = [np.random.default_rng(i).normal(size=np.shape(o)).astype(np.float32)
           for i, o in enumerate(outs)]

    def jloss(p, *xs):
        return sum(jnp.sum(o * c) for o, c in zip(jf(p, *xs), cot))

    gj = jax.jit(jax.grad(jloss, argnums=tuple(range(len(jinputs) + 1))))(jparams, *jinputs)
    xs = [torch.tensor(np.asarray(x), requires_grad=True) for x in jinputs]
    pouts = pf(*xs)
    sum((o * torch.tensor(c)).sum() for o, c in zip(pouts, cot)).backward()
    for a, b in zip(pouts, outs):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a.detach().numpy() - b).max() <= 1e-5 * np.abs(b).max()
    gaps, _ = leaf_gaps([x.grad.numpy() for x in xs] + weights(), list(gj[1:]) + [gj[0]])
    assert max(gaps) <= 1e-4, gaps


@pytest.mark.parametrize("act", [True, False])
def test_gvp_cell_matches_jax(act):
    rng = np.random.default_rng(0)
    s = rng.normal(size=(7, 6)).astype(np.float32)
    v = rng.normal(size=(7, 3, 3)).astype(np.float32)
    jc = jgvp.GVPCell(5, 4, scalar_act="relu" if act else None,
                      vector_act="sigmoid" if act else None)
    params = jax.tree.map(np.asarray, jc.init(jax.random.key(1), (s, v))["params"])
    cell = pgvp.GVPCell((6, 3), (5, 4), activations=act)
    cell.load_state_dict(_cell_sd(params), strict=True)
    _held(lambda p, s, v: jc.apply({"params": p}, (s, v)), params, (s, v),
          lambda s, v: cell((s, v)), lambda: _cell_sd_grads(cell))


def _cell_sd_grads(module):
    """A module's parameter gradients as the JAX tree they came from
    (name -> {kernel, bias}), in the order of ``jax.tree.leaves``."""
    tree = {}
    for name, p in module.named_parameters():
        lin, kind = name.rsplit(".", 1)
        tree.setdefault(lin, {})["kernel" if kind == "weight" else "bias"] = (
            p.grad.numpy().T if kind == "weight" else p.grad.numpy())
    return jax.tree.leaves(tree)


def test_tuple_layer_norm_matches_jax():
    rng = np.random.default_rng(2)
    s = rng.normal(size=(9, 5)).astype(np.float32)
    v = (rng.normal(size=(9, 3, 3)) * rng.uniform(0.01, 3, size=(9, 1, 1))).astype(np.float32)
    v[0] = 0.0   # the clamp inside the root keeps a zero vector finite
    jn = jgvp.TupleLayerNorm()
    params = {"scalar_norm": {"scale": np.linspace(0.5, 1.5, 5, dtype=np.float32),
                              "bias": np.linspace(-0.2, 0.2, 5, dtype=np.float32)}}
    norm = pgvp.TupleLayerNorm(5)
    norm.load_state_dict({"scalar_norm.weight": torch.tensor(params["scalar_norm"]["scale"]),
                          "scalar_norm.bias": torch.tensor(params["scalar_norm"]["bias"])})

    def grads():
        return [norm.scalar_norm.bias.grad.numpy(), norm.scalar_norm.weight.grad.numpy()]

    _held(lambda p, s, v: jn.apply({"params": p}, (s, v)), params, (s, v),
          lambda s, v: norm((s, v)), grads)
    out = norm((torch.tensor(s), torch.tensor(v)))
    assert torch.isfinite(out[1]).all() and not out[1][0].any()


def test_convolution_means_at_src_match_jax():
    # the message GVPs on the gathered ends, their [s | V] summed at src in
    # one segment-sum and divided by the real edges at each src
    jb, pb = _batches(n_graphs=2, n_nodes=10, seed=7)
    rng = np.random.default_rng(3)
    n, ne = pb.num_nodes, pb.n_real_edges
    s = rng.normal(size=(n, 16)).astype(np.float32)
    v = rng.normal(size=(n, 4, 3)).astype(np.float32)
    es = rng.normal(size=(jb.num_edges, 8)).astype(np.float32)
    ev = rng.normal(size=(jb.num_edges, 2, 3)).astype(np.float32)
    jc = jgvp.GVPConvolution((16, 4), (8, 2), 3)
    params = jax.tree.map(np.asarray,
                          jax.jit(jc.init)(jax.random.key(0), (s, v), (es, ev), jb)["params"])
    conv = pgvp.GVPConvolution((16, 4), (8, 2), 3)
    sd = {}
    for j in range(3):
        sd.update(_cell_sd(params[f"message{j}"], f"message_func.{j}."))
    conv.load_state_dict(sd, strict=True)
    mask = np.asarray(jb.node_mask)

    def jf(p, s, v):
        out_s, out_v = jc.apply({"params": p}, (s, v), (es, ev), jb)
        return out_s[mask], out_v[mask]

    def pf(s, v):
        out_s, out_v = conv((s, v), (torch.tensor(es[:ne]), torch.tensor(ev[:ne])), pb)
        m = torch.tensor(mask)
        return out_s[m], out_v[m]

    _held(jf, params, (s, v), pf, lambda: _cell_sd_grads(conv))


# Coordinates and vectors within 1e-5 of the largest value (measured
# 1.9e-7).  The output scalars differ by 1.6e-5 of the largest: that is the
# JAX package's own f32 error (1.6e-5 from the same model in f64, against
# the port's 2.1e-7), which its LayerNorm's variance E[x^2] - E[x]^2 makes;
# so they are held against the port in f64 at 1e-6 and against JAX at 5e-5.
def test_forward_matches_jax(case):
    pm, pb = case["pm"], case["pb"]
    with torch.no_grad():
        x, (s, v) = pm(pb)
        s64 = pm.double()(pb._apply(lambda t: t.double() if t.is_floating_point() else t))[1][0]
        pm.float()
    mask = np.asarray(case["jb"].node_mask)

    def gap(a, b):
        b = np.asarray(b)[mask]
        return np.abs(a.numpy()[mask] - b).max() / np.abs(b).max()

    assert gap(x, case["xj"]) <= 1e-5 and gap(v, case["vj"]) <= 1e-5
    assert gap(s, s64) <= 1e-6 and gap(s, case["sj"]) <= 5e-5


# measured: 3.6e-7 of each leaf's floored scale
def test_param_gradients_of_mse_match_jax(case):
    pm, pb = case["pm"], case["pb"]
    pm.zero_grad()
    masked_mse(pm(pb)[0], pb.coord_target, pb.node_mask).backward()
    # without a vector gate no scalar reaches a vector, so the scalar path
    # (ws, the LayerNorms) gets a zero gradient or none from the coordinates;
    # the JAX gradients there are zero
    for k, p in pm.named_parameters():
        scalar = ".ws." in k or ".scalar_norm." in k
        assert scalar == (p.grad is None or not p.grad.any()), k
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in pm.named_parameters()}
    gp = params_from_gvpnet_state_dict(grads, n_layers=2)
    assert jax.tree.structure(gp) == jax.tree.structure(case["gj"])
    gaps, _ = leaf_gaps(gp, case["gj"])
    assert max(gaps) <= 1e-4, gaps


def test_dropout_stays_off_in_train_mode(case):
    # the JAX CLI trains with train=False: nn.Module.train() changes nothing
    pm, pb = case["pm"], case["pb"]
    pm.eval()
    with torch.no_grad():
        want = pm(pb)[0]
        pm.train()
        got = [pm(pb)[0] for _ in range(2)]
        # asked for, dropout zeroes whole vector channels and scalars
        torch.manual_seed(0)
        s, v = pgvp.TupleDropout(0.5)((torch.ones(200, 3), torch.ones(200, 4, 3)), train=True)
    pm.eval()
    assert all(torch.equal(g, want) for g in got)
    assert not torch.equal(pm(pb, train=True)[0], want)
    assert set(s.unique().tolist()) == {0.0, 2.0}
    assert ((v == 0).all(-1) | (v == 2).all(-1)).all() and (v == 0).any()


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    from test_torch_port_nbody import make_trio

    return make_trio(tmp_path_factory)


# measured: gradients 2.2e-7, post-Adam parameters 7.5e-9
def test_one_train_step_matches_jax(trio):
    r = one_train_step(trio, jgvp.GVPNet(n_layers=2), GVPNet(2, 2, n_layers=2, device="cpu"),
                       state_dict_from_gvpnet_params,
                       lambda sd: params_from_gvpnet_state_dict(sd, n_layers=2), use_mmd=False)
    check_one_train_step(r)


# The logged MSEs are 1.5-1.9.  Measured: every train and test MSE within
# 9.3e-7 relative; rtol 2e-4, as for the other models' N-body CLI tests
def test_cli_training_tracks_the_jax_train(monkeypatch, tmp_path, trio):
    (pbest, plog), (jbest, jlog) = run_training_on_the_jax_draw(
        monkeypatch, tmp_path, trio, "GVP", jgvp.GVPNet(n_layers=2),
        state_dict_from_gvpnet_params)
    np.testing.assert_allclose(plog["loss_train"], jlog["loss_train"], rtol=2e-4)
    np.testing.assert_allclose(plog["loss"], jlog["loss"], rtol=2e-4)
    np.testing.assert_allclose(pbest["loss_valid"], jbest["loss_valid"], rtol=2e-4)
    assert pbest["epoch_index"] == jbest["epoch_index"]


def test_rotation_equivariance_and_no_translation_equivariance():
    # GVP reads absolute positions as vector features: O(3)-equivariant,
    # not translation-equivariant (tests/test_model_zoo.py:64-80)
    _, pb = _batches(n_graphs=2, n_nodes=6, seed=19)
    mask = pb.node_mask.numpy()
    pm = GVPNet(2, 2, n_layers=2, device="cpu", generator=torch.Generator().manual_seed(0))
    R = random_rotation(np.random.default_rng(5)).astype(np.float32)
    Rt = torch.tensor(R)
    with torch.no_grad():
        x0, (_, v0) = pm(pb)
        moved = pb.to("cpu")
        moved.coord, moved.vel = pb.coord @ Rt, pb.vel @ Rt
        x1, (_, v1) = pm(moved)
        moved.coord = pb.coord + torch.tensor([1.0, -2.0, 0.5])
        moved.vel = pb.vel
        x2, _ = pm(moved)
    np.testing.assert_allclose(x1.numpy()[mask], (x0.numpy() @ R)[mask], atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(v1.numpy()[mask], (v0.numpy() @ R)[mask], atol=2e-4, rtol=2e-4)
    assert np.abs(x2.numpy() - x0.numpy() - np.array([1.0, -2.0, 0.5]))[mask].max() > 1e-2
