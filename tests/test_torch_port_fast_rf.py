"""The port's FastRF against the JAX FastRF on the same weights.

Weights cross through the reference state-dict layout: JAX params ->
``state_dict_from_fastrf_params`` -> port, and back through
``params_from_fastrf_state_dict`` (which has no attention weights: the
attention tests map those two linears themselves).  Inputs are 3 graphs x
30 nodes (``helpers.random_raw_graph``), H=64, C=3, L=2, f32.  Both edge
branches are covered: the fused edge block (its plain version on the CPU,
``m_sum`` unused) and, with attention on, the CSR branch.  Training is held
on the N-body data of ``tests/test_torch_port_nbody.py``.
"""

import jax
import numpy as np
import pytest
import torch

from fastegnn_tpu.graph import GraphSpec as JSpec, batch_graphs as jbatch, pad_graph as jpad
from fastegnn_tpu.models import MMD_MODELS as JAX_MMD_MODELS, FastRF as JFastRF
from fastegnn_tpu.models import MODEL_KWARGS as JAX_MODEL_KWARGS
from fastegnn_tpu.train.loss import masked_mse as jmse
from fastegnn_tpu.utils.torch_import import params_from_fastrf_state_dict
from fastegnn_tpu_torch.cli import nbody as pcli_nbody
from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph
from fastegnn_tpu_torch.models import (
    MMD_MODELS, MODEL_KWARGS, FastRF, computes_in_float32_only, get_model)
from fastegnn_tpu_torch.ops import edge_kernel as ek
from fastegnn_tpu_torch.ops.rotation import random_rotation
from fastegnn_tpu_torch.train.loss import masked_mse
from fastegnn_tpu_torch.utils.weights import state_dict_from_fastrf_params

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
    p = params_from_fastrf_state_dict(sd, n_layers=n_layers, has_gravity=has_gravity)
    if attention:
        for i in range(n_layers):
            for name in ("att_mlp", "att_mlp_virtual"):
                p[f"gcl_{i}"][name] = {"kernel": np.asarray(sd[f"gcl_{i}.{name}.0.weight"]).T,
                                       "bias": np.asarray(sd[f"gcl_{i}.{name}.0.bias"])}
    return p


def _models(jb, gravity=GRAV, attention=False):
    jm = JFastRF(gravity=gravity, attention=attention, **KW)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jb)["params"])
    pm = FastRF(2, 2, gravity=gravity, attention=attention, device="cpu", **KW)
    pm.load_state_dict(state_dict_from_fastrf_params(params), strict=True)
    return jm, params, pm


@pytest.fixture(scope="module")
def batches():
    return _batches()


@pytest.fixture(scope="module", params=["fused", "attention"])
def case(request, batches):
    """The JAX forward and MSE parameter gradients, and the port model with
    the same weights, for the fused branch or the CSR branch (attention)."""
    jb, pb = batches
    attention = request.param == "attention"
    jm, params, pm = _models(jb, attention=attention)
    assert pm.gcl_0.fused == (not attention)

    def jloss(p):
        x, vx = jm.apply({"params": p}, jb)
        return jmse(x, jb.coord_target, jb.node_mask), (x, vx)

    (_, (xj, vj)), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    return dict(jb=jb, pb=pb, pm=pm, attention=attention, xj=np.asarray(xj),
                vj=np.asarray(vj), gj=gj)


@pytest.mark.parametrize("gravity,attention", [(GRAV, False), (None, False), (GRAV, True)])
def test_weights_round_trip_bit_for_bit(gravity, attention):
    # port -> the JAX importer -> the inverse, from a port init; and JAX
    # params -> the inverse -> the importer
    pm = FastRF(2, 2, gravity=gravity, attention=attention, device="cpu",
                generator=torch.Generator().manual_seed(0), **KW)
    sd = {k: v.detach().numpy() for k, v in pm.state_dict().items()}
    back = state_dict_from_fastrf_params(to_jax(sd, has_gravity=gravity is not None,
                                                attention=attention))
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    jb, _ = _batches(n_graphs=2, n_nodes=6)
    _, params, pm = _models(jb, gravity=gravity, attention=attention)
    again = to_jax({k: v.detach().numpy() for k, v in pm.state_dict().items()},
                   has_gravity=gravity is not None, attention=attention)
    assert jax.tree.structure(again) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_initialisation_follows_the_reference():
    pm = FastRF(2, 2, device="cpu", generator=torch.Generator().manual_seed(0), **KW)
    layer = pm.gcl_0
    assert not hasattr(layer, "node_mlp") and not hasattr(layer, "node_mlp_virtual")
    assert layer.coord_mlp_vel[0].in_features == 1
    assert layer.coord_mlp_r[2].bias is None
    # the coordinate heads: xavier with gain 1e-3 (bound 1e-3 sqrt(6 / 65))
    assert float(layer.coord_mlp_r[2].weight.detach().abs().max()) <= 1e-3 * (6 / 65) ** 0.5


# 1e-4, as for FastEGNN: the packages sum in different orders, which
# compounds over two layers (measured: 4.8e-7 on coordinates of up to 3.9)
def test_forward_matches_jax(case):
    with torch.no_grad():
        xp, vp = case["pm"](case["pb"])
    mask = np.asarray(case["jb"].node_mask)
    np.testing.assert_allclose(xp.numpy()[mask], case["xj"][mask], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vp.numpy(), case["vj"], rtol=1e-4, atol=1e-4)


# measured: 1.3e-6 (fused), 9.2e-7 (attention) of each leaf's floored scale
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


def test_fused_backward_without_an_m_sum_gradient_matches_autograd():
    # FastRF leaves the fused block's m_sum unused, so its backward gets no
    # d_msum and runs on zeros: its weight gradients must equal autograd's
    # through the plain chain
    _, pb = _batches(n_graphs=2, n_nodes=12, seed=9)
    gen = torch.Generator().manual_seed(1)
    n, H = pb.num_nodes, 64
    h = torch.randn(n, H, generator=gen, requires_grad=True)
    weights = [(torch.randn(s, generator=gen) * 0.2).requires_grad_()
               for s in [(2 * H + 3, H), (H,), (H, H), (H,), (H, H), (H,), (H, 1)]]
    args = (pb.rowptr, pb.src, pb.dst, pb.edge_attr)
    _, t_sum = ek.fused_edge_block(h, pb.coord, *args, *weights)
    got = torch.autograd.grad(t_sum.square().sum(), [h, *weights])
    W1, b1, W2, b2, Wg1, bg1, wg2 = weights
    ne = pb.n_real_edges
    d, s = pb.dst[:ne].long(), pb.src[:ne].long()
    diff = pb.coord[d] - pb.coord[s]
    e_in = torch.cat([h[d], h[s], (diff * diff).sum(1, keepdim=True), pb.edge_attr[:ne]], 1)
    m = torch.nn.functional.silu(torch.nn.functional.silu(e_in @ W1 + b1) @ W2 + b2)
    gate = torch.nn.functional.silu(m @ Wg1 + bg1) @ wg2
    want_t = torch.zeros(n, 3).index_add_(0, d, diff * gate)
    want = torch.autograd.grad(want_t.square().sum(), [h, *weights])
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_get_model_builds_the_ported_models_and_raises_for_the_rest():
    for name in ("FastEGNN", "FastRF", "FastSchNet", "FastTFN", "VNEGNN"):
        m = get_model(name, 2, 2, hidden=32, n_layers=1, virtual_channels=2, device="cpu",
                      sample=3, gravity=(0.0, -1.0, 0.0))   # keyword arguments a model
        assert type(m).__name__ == name and m.n_layers == 1   # does not take are dropped
        assert (name in MMD_MODELS) == (name != "VNEGNN")
    assert MMD_MODELS == JAX_MMD_MODELS
    assert not hasattr(get_model("VNEGNN", 2, 2, device="cpu").A2A_0, "gravity_mlp")
    # the baselines, with the JAX CLI's keyword arguments (SchNet keeps its 16
    # interactions whatever n_layers says; EGHN its 3 / 4 / 2 depths)
    built = {name: get_model(name, 2, 2, hidden=32, n_layers=1, virtual_channels=2,
                             gravity=(0.0, -1.0, 0.0), device="cpu")
             for name in ("EGNN", "GNN", "RF", "Linear", "SchNet", "EGHN", "MLP")}
    assert len(built["EGNN"].layers) == len(built["GNN"].layers) == built["RF"].n_layers == 1
    assert len(built["SchNet"].interactions) == 16 and built["SchNet"].embedding.out_features == 32
    assert len(built["EGHN"].low_force_net.layers) == 3
    assert len(built["EGHN"].low_pooling.layers) == 4
    assert len(built["EGHN"].kinematics_net.layers) == 2
    assert [p.shape for p in built["Linear"].parameters()] == [(1,)]
    assert built["MLP"].embedding.in_features == 2 and len(built["MLP"].layers) == 1
    assert not MMD_MODELS & set(built)
    # GVP at the JAX CLI's fixed widths, DimeNet with num_blocks = --num_layer
    built = {name: get_model(name, 2, 2, hidden=32, n_layers=1, num_blocks=1, device="cpu")
             for name in ("GVP", "DimeNet", "DimeNet++")}
    assert len(built["GVP"].layers) == 1 and built["GVP"].W_v[1].ws.out_features == 100
    assert len(built["DimeNet"].interaction_blocks) == 1
    assert len(built["DimeNet++"].output_blocks) == 2
    assert built["DimeNet"].emb.lin.out_features == 32
    assert hasattr(built["DimeNet++"].interaction_blocks[0], "lin_down")
    assert not MMD_MODELS & set(built)
    # the CLIs' TFN: OurDynamics at nf = 32, num_degrees = 2, L = n_layers
    tfn = get_model("TFN", 2, 2, hidden=32, n_layers=1, device="cpu")
    assert type(tfn).__name__ == "OurDynamics" and tfn.se3.num_layers == 1
    assert tfn.se3.conv_out.core.pair_1_1.rp.lin2.out_features == 3 and "TFN" not in MMD_MODELS
    with pytest.raises(ValueError, match="Unknown model"):
        get_model("NoSuchModel", 2, 2, device="cpu")
    # no bf16 path: built in float32 where bf16 was asked for, as the JAX
    # get_model drops the keyword; computes_in_float32_only tells the CLIs
    for name in ("FastRF", "FastSchNet", "FastTFN", "VNEGNN", "EGNN", "SchNet", "EGHN", "GVP",
                 "DimeNet", "DimeNet++", "TFN"):
        m = get_model(name, 2, 2, compute_dtype=torch.bfloat16, device="cpu")
        assert all(p.dtype == torch.float32 for p in m.parameters()), name
        layers = [c for c in m.modules() if hasattr(c, "cfg")]
        assert all(c.cfg.compute_dtype == torch.float32 for c in layers), name
        assert computes_in_float32_only(name, torch.bfloat16), name
        assert not computes_in_float32_only(name, torch.float32), name
    m = get_model("FastEGNN", 2, 2, compute_dtype=torch.bfloat16, device="cpu")
    assert m.gcl_0.cfg.compute_dtype == torch.bfloat16
    assert not computes_in_float32_only("FastEGNN", torch.bfloat16)
    # the keyword arguments each model takes are the JAX package's
    assert MODEL_KWARGS == JAX_MODEL_KWARGS


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    return make_trio(tmp_path_factory)


# measured: gradients 4.4e-7, post-Adam parameters 6.0e-8
def test_one_train_step_with_the_shared_draw_matches_jax(trio):
    r = one_train_step(trio, JFastRF(**KW), FastRF(2, 2, device="cpu", **KW),
                       state_dict_from_fastrf_params,
                       lambda sd: to_jax(sd, has_gravity=False))
    check_one_train_step(r)


def test_cli_raises_on_bfloat16_for_a_model_without_a_bf16_path(trio, tmp_path, monkeypatch,
                                                                capsys):
    # It no longer raises: the JAX CLI drops --compute_dtype for FastRF
    # (MODEL_KWARGS) and trains it in float32, and so does the port, with a
    # line that says so.  The training loop itself is stubbed out here.
    from fastegnn_tpu_torch import models
    from fastegnn_tpu_torch.train import loop

    built = []
    build = models.get_model
    monkeypatch.setattr(models, "get_model", lambda *a, **k: built.append(build(*a, **k))
                        or built[-1])
    monkeypatch.setattr(loop, "train", lambda *a, **k: ({"loss_valid": 0.0}, {}, 0))
    root, name = trio
    pcli_nbody.main(["--data_directory", root, "--dataset_name", name, "--model", "FastRF",
                     "--compute_dtype", "bfloat16", "--platform", "cpu",
                     "--virtual_channel", "3", "--max_epochs", "1",
                     "--log_directory", str(tmp_path)])
    assert "FastRF has no bfloat16 path and computes in float32" in capsys.readouterr().out
    assert all(p.dtype == torch.float32 for p in built[0].parameters())
    assert built[0].gcl_0.cfg.compute_dtype == torch.float32


# The logged MSEs are 1.7e-2 - 3.7e-2.  Measured: every train, valid and
# test MSE within 4.6e-6 relative; rtol 2e-4, the FastEGNN N-body test's
def test_cli_training_tracks_the_jax_train(monkeypatch, tmp_path, trio):
    (pbest, plog), (jbest, jlog) = run_training_on_the_jax_draw(
        monkeypatch, tmp_path, trio, "FastRF", JFastRF(**KW), state_dict_from_fastrf_params)
    np.testing.assert_allclose(plog["loss_train"], jlog["loss_train"], rtol=2e-4)
    np.testing.assert_allclose(plog["loss"], jlog["loss"], rtol=2e-4)
    np.testing.assert_allclose(pbest["loss_valid"], jbest["loss_valid"], rtol=2e-4)
    assert pbest["epoch_index"] == jbest["epoch_index"]


def test_se3_equivariance_without_gravity():
    _, pb = _batches(n_graphs=2, n_nodes=10, seed=11)
    mask = pb.node_mask.numpy()
    for attention in (False, True):
        pm = FastRF(2, 2, attention=attention, device="cpu",
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
