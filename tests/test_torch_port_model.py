"""The port's FastEGNN against the JAX FastEGNN on the same weights.

Weights cross through the reference state-dict layout: JAX params ->
``state_dict_from_jax_params`` -> port, and back through
``params_from_reference_state_dict``.  Inputs are 4 graphs x 40 nodes
(``helpers.random_raw_graph``), H=64, C=3, L=2, f32.

In bf16 the port is held against the JAX model with its fused Pallas edge
kernel (interpret mode): one forward and one MMD train step, and the
velocity / gravity heads' f32 bias on their own.

The layer variants the fused edge block does not cover (attention,
normalize + tanh, hidden 32) are also held against the JAX package's CSR
branch, on a batch that carries its CSR tables so that the JAX side runs
the Pallas segment-sum kernel (in interpret mode).

The options no CLI sets, ``residual=False`` with the charges as node
attributes (``OPTIONS``: the JAX ``use_node_attr``, the port's
``node_attr_dim=1``), are held in f32 and bf16, on the fused branch and on
the CSR branch (with attention, which the fused block does not cover).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optax

import fastegnn_tpu.graph as jgraph
from fastegnn_tpu.graph import GraphSpec as JSpec, batch_graphs as jbatch, pad_graph as jpad
from fastegnn_tpu.models import FastEGNN as JFastEGNN, fastegnn_core as jcore
from fastegnn_tpu.train import torch_adam as jadam
from fastegnn_tpu.train.loss import masked_mse as jmse
from fastegnn_tpu.train.step import make_loss_fn as jloss_fn
from fastegnn_tpu.utils.torch_import import params_from_reference_state_dict
from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph
from fastegnn_tpu_torch.models import fastegnn_core as pcore
from fastegnn_tpu_torch.models.fast_egnn import FastEGNN
from fastegnn_tpu_torch.ops.rotation import random_rotation
from fastegnn_tpu_torch.train.loss import masked_mse
from fastegnn_tpu_torch.train.optim import torch_adam
from fastegnn_tpu_torch.train.step import make_train_step
from fastegnn_tpu_torch.utils.weights import state_dict_from_jax_params

from helpers import random_raw_graph

GRAV = (0.0, -1.0, 0.0)
# the options no CLI sets, in the JAX model's terms (_models maps them)
OPTIONS = dict(residual=False, use_node_attr=True)


def _batches(n_graphs=4, n_nodes=40, seed=5, csr=False):
    rng = np.random.default_rng(seed)
    raws = [random_raw_graph(rng, n_nodes) for _ in range(n_graphs)]
    kw = dict(max_nodes=n_nodes, max_edges=n_nodes * (n_nodes - 1), n_graphs=n_graphs,
              edge_attr_dim=2, virtual_channels=3)
    js, ps = JSpec(**kw), GraphSpec(**kw)
    pb = batch_graphs([pad_graph(ps, **r) for r in raws], ps, device="cpu")
    if not csr:
        return jbatch([jpad(js, **r) for r in raws], js), pb
    # one graph per fused-kernel group: the batch then carries the CSR
    # tables only with csr_for_groups (tests/test_fast_egnn.py does the same)
    old = jgraph.EK5_MAX_NODES
    jgraph.EK5_MAX_NODES = n_nodes
    try:
        jb = jbatch([jpad(js, **r) for r in raws], js, csr_for_groups=True)
    finally:
        jgraph.EK5_MAX_NODES = old
    assert jb.csr_dst is not None
    return jb, pb


def _models(jb, hidden=64, gravity=GRAV, compute_dtype="float32", fuse_edge=False,
            use_node_attr=False, **variant):
    """The JAX model, its init and the port model with its weights; the
    JAX ``use_node_attr`` is the port's ``node_attr_dim=1``."""
    jm = JFastEGNN(hidden=hidden, virtual_channels=3, n_layers=2, gravity=gravity,
                   fuse_edge=fuse_edge, compute_dtype=compute_dtype,
                   use_node_attr=use_node_attr, **variant)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jb)["params"])
    pm = FastEGNN(2, 2, hidden=hidden, virtual_channels=3, n_layers=2, gravity=gravity,
                  compute_dtype=getattr(torch, compute_dtype), node_attr_dim=int(use_node_attr),
                  device="cpu", **variant)
    pm.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jm, params, pm


@pytest.fixture(scope="module")
def setup():
    jb, pb = _batches()
    jm, params, pm = _models(jb)
    return jb, pb, jm, params, pm


@pytest.fixture(scope="module")
def options_setup():
    jb, pb = _batches()
    jm, params, pm = _models(jb, **OPTIONS)
    assert pm.gcl_0.fused and not pm.gcl_0.cfg.residual
    return jb, pb, jm, params, pm


@pytest.mark.parametrize("gravity,attention,node_attr", [
    pytest.param(GRAV, False, False, id="gravity0-False"),
    pytest.param(None, True, False, id="None-True"),
    pytest.param(GRAV, False, True, id="node_attr")])
def test_weight_transfer_round_trips_bit_for_bit(gravity, attention, node_attr):
    # with the node attributes node_mlp.0 is 2H + C H + 1 wide, the
    # attribute column last on both sides
    jb, _ = _batches(n_graphs=2, n_nodes=6)
    _, params, pm = _models(jb, gravity=gravity, attention=attention, use_node_attr=node_attr)
    assert pm.gcl_1.node_mlp[0].in_features == 2 * 64 + 3 * 64 + int(node_attr)
    sd = {k: v.detach().numpy() for k, v in pm.state_dict().items()}
    back = params_from_reference_state_dict(
        sd, n_layers=2, hidden=64, virtual_channels=3,
        has_gravity=gravity is not None, attention=attention)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


# Coordinates within 1e-4: both packages sum the edge messages, pools and
# matmuls in different orders, which compounds across the two layers.
@pytest.mark.parametrize("jax_fused,options", [
    pytest.param(False, False, id="False"), pytest.param(True, False, id="True"),
    pytest.param(False, True, id="options"), pytest.param(True, True, id="options-fused")])
def test_forward_matches_jax(request, jax_fused, options):
    jb, pb, jm, params, pm = request.getfixturevalue("options_setup" if options else "setup")
    if jax_fused:   # the JAX fused Pallas kernel, in interpret mode on the CPU
        jm = jm.clone(fuse_edge=True)
    xj, vj = jm.apply({"params": params}, jb)
    with torch.no_grad():
        xp, vp = pm(pb)
    mask = np.asarray(jb.node_mask)
    np.testing.assert_allclose(xp.numpy()[mask], np.asarray(xj)[mask], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=1e-4, atol=1e-4)


def _check_mse_gradients(jb, pb, jm, params, pm):
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
    assert jax.tree.structure(gp) == jax.tree.structure(gj)
    for a, b in zip(jax.tree.leaves(gp), jax.tree.leaves(gj)):
        b = np.asarray(b)
        scale = float(np.abs(b).max()) + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4)


def test_param_gradients_of_mse_match_jax(setup):
    _check_mse_gradients(*setup)


def test_options_param_gradients_of_mse_match_jax(options_setup):
    _check_mse_gradients(*options_setup)


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


# The CSR-branch variants: (keyword arguments, hidden)
VARIANTS = {"attention": (dict(attention=True), 64),
            "normalize_tanh": (dict(normalize=True, tanh=True), 64),
            "hidden32": ({}, 32),
            "options": (dict(attention=True, **OPTIONS), 64)}


@pytest.fixture(scope="module")
def csr_batches():
    return _batches(n_graphs=3, n_nodes=24, seed=8, csr=True)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def csr_variant(request, csr_batches):
    """JAX forward and MSE parameter gradients on the CSR branch, and the
    port model with the same weights, for one variant."""
    jb, pb = csr_batches
    variant, hidden = VARIANTS[request.param]
    jm, params, pm = _models(jb, hidden=hidden, **variant)
    assert not pm.gcl_0.fused

    def jloss(p):
        x, vx = jm.apply({"params": p}, jb)
        return jmse(x, jb.coord_target, jb.node_mask), (x, vx)

    (_, (xj, vj)), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    return dict(jb=jb, pb=pb, pm=pm, hidden=hidden, attention=bool(variant.get("attention")),
                xj=np.asarray(xj), vj=np.asarray(vj), gj=gj)


# 1e-4, as for the fused path: the sums run in different orders on the two
# sides, compounding over the two layers
def test_csr_branch_forward_matches_jax(csr_variant):
    v = csr_variant
    with torch.no_grad():
        xp, vp = v["pm"](v["pb"])
    mask = np.asarray(v["jb"].node_mask)
    np.testing.assert_allclose(xp.numpy()[mask], v["xj"][mask], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vp.numpy(), v["vj"], rtol=1e-4, atol=1e-4)


def test_csr_branch_param_gradients_match_jax(csr_variant):
    v = csr_variant
    pm, pb = v["pm"], v["pb"]
    pm.zero_grad()
    x, _ = pm(pb)
    masked_mse(x, pb.coord_target, pb.node_mask).backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in pm.named_parameters()}
    gp = params_from_reference_state_dict(grads, n_layers=2, hidden=v["hidden"],
                                          has_gravity=True, attention=v["attention"])
    assert jax.tree.structure(gp) == jax.tree.structure(v["gj"])
    for a, b in zip(jax.tree.leaves(gp), jax.tree.leaves(v["gj"])):
        b = np.asarray(b)
        scale = float(np.abs(b).max()) + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4)


def test_csr_branch_bf16_forward_matches_jax(csr_batches):
    # bf16 MLP compute: both sides round the translations to bf16 before the
    # f32 segment-sum; 2e-2 covers the two packages' bf16 rounding points
    jb, pb = csr_batches
    kw = dict(hidden=64, virtual_channels=3, n_layers=2, gravity=GRAV, attention=True)
    jm = JFastEGNN(fuse_edge=False, compute_dtype=jnp.bfloat16, **kw)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jb)["params"])
    pm = FastEGNN(2, 2, compute_dtype=torch.bfloat16, device="cpu", **kw)
    pm.load_state_dict(state_dict_from_jax_params(params), strict=True)
    xj, vj = jm.apply({"params": params}, jb)
    with torch.no_grad():
        xp, vp = pm(pb)
    mask = np.asarray(jb.node_mask)
    np.testing.assert_allclose(xp.numpy()[mask], np.asarray(xj)[mask], rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=2e-2, atol=2e-2)


# bf16 against the JAX fused bf16 model (ROADMAP.md queue 3, F1).  Both
# round to bf16, at points that differ (the edge kernel's F2 points, XLA's
# excess precision between bf16 ops on the CPU), and that compounds over
# two layers.  Measured over seeds 7-9 (3 graphs of 30 / 24 / 30 and of
# 16 / 12 / 16 nodes): coordinates 6.8e-3 of the largest displacement,
# virtual coordinates 1.2e-6 of their largest, loss and MSE 5.4e-3
# relative, MMD 3.7e-4 absolute (its two terms are of size ~2), parameter
# gradients 1.3e-2 of max(their own largest, 1e-2 of the model's largest).
# The tolerances are 3-8x those.
BF16_MODEL_TOL = dict(coord=2e-2, virtual=1e-5, loss=2e-2, mmd=2e-3, grad=4e-2)


@pytest.fixture(scope="module")
def bf16_case():
    """The JAX fused bf16 model's forward, MMD loss, gradients and one Adam
    step on a batch inside reference defects 1-2 (one kernel call; every
    node has edges; W = 1)."""
    jb, pb = _batches(n_graphs=3, n_nodes=30, seed=7)
    assert jb.ek5 is not None
    kw = dict(hidden=64, virtual_channels=3, n_layers=2, gravity=GRAV)
    jm = JFastEGNN(fuse_edge=True, compute_dtype=jnp.bfloat16, **kw)
    params = jm.init(jax.random.key(0), jb)["params"]
    key = jax.random.key(1)
    loss_fn = jloss_fn(jm, 1.0, 0.01, 3, True)

    def lf(p):
        total, (mse, mmd) = loss_fn(p, jb, key)
        return total, (mse, mmd, jm.apply({"params": p}, jb))

    (total, (mse, mmd, (xj, vj))), gj = jax.jit(jax.value_and_grad(lf, has_aux=True))(params)
    tx = jadam(5e-4, 1e-12)
    updates, _ = tx.update(gj, tx.init(params), params)
    pm = FastEGNN(2, 2, compute_dtype=torch.bfloat16, device="cpu", **kw)
    pm.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)))
    # the JAX step draws exactly these scores from `key` (train/loss.py:73)
    scores = jax.random.uniform(key, (jb.n_graphs, jb.num_nodes // jb.n_graphs))
    return dict(jb=jb, pb=pb, pm=pm, xj=np.asarray(xj), vj=np.asarray(vj),
                metrics=dict(loss=float(total), mse=float(mse), mmd=float(mmd)),
                gj=jax.tree.map(np.asarray, gj),
                new=jax.tree.map(np.asarray, optax.apply_updates(params, updates)),
                draw=torch.tensor(np.asarray(scores)))


def test_bf16_fused_forward_matches_jax(bf16_case):
    c = bf16_case
    with torch.no_grad():
        xp, vp = c["pm"](c["pb"])
    mask = np.asarray(c["jb"].node_mask)
    x0 = np.asarray(c["jb"].coord)[mask]
    xj = c["xj"][mask]
    assert np.abs(xp.numpy()[mask] - xj).max() <= BF16_MODEL_TOL["coord"] * np.abs(xj - x0).max()
    assert np.abs(vp.numpy() - c["vj"]).max() <= BF16_MODEL_TOL["virtual"] * np.abs(c["vj"]).max()


@pytest.mark.parametrize("branch", ["fused", "csr"])
def test_bf16_forward_with_options_matches_jax(branch, csr_batches):
    """``OPTIONS`` in bf16: against the JAX fused bf16 model on the batch
    of ``bf16_case`` (the JAX node path adds the attribute term in bf16,
    fastegnn_tpu/models/fastegnn_core.py:343-347), at ``BF16_MODEL_TOL``;
    and with attention against the JAX CSR branch, at the 2e-2 of
    ``test_csr_branch_bf16_forward_matches_jax``."""
    fused = branch == "fused"
    jb, pb = _batches(n_graphs=3, n_nodes=30, seed=7) if fused else csr_batches
    jm, params, pm = _models(jb, compute_dtype="bfloat16", fuse_edge=fused,
                             attention=not fused, **OPTIONS)
    assert pm.gcl_0.fused == fused and pm.gcl_0.cfg.compute_dtype == torch.bfloat16
    xj, vj = (np.asarray(a) for a in jm.apply({"params": params}, jb))
    with torch.no_grad():
        xp, vp = (a.numpy() for a in pm(pb))
    mask = np.asarray(jb.node_mask)
    if fused:
        x0 = np.asarray(jb.coord)[mask]
        assert np.abs(xp[mask] - xj[mask]).max() <= BF16_MODEL_TOL["coord"] * np.abs(
            xj[mask] - x0).max()
        assert np.abs(vp - vj).max() <= BF16_MODEL_TOL["virtual"] * np.abs(vj).max()
    else:
        np.testing.assert_allclose(xp[mask], xj[mask], rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(vp, vj, rtol=2e-2, atol=2e-2)


def test_bf16_fused_train_step_matches_jax(bf16_case):
    c = bf16_case
    pm = c["pm"]
    step = make_train_step(pm, torch_adam(pm.parameters(), 5e-4, 1e-12), sigma=1.0,
                           weight=0.01, sample=3, per_graph_sampling=True)
    mp = step(c["pb"], draw=c["draw"])
    for k in ("loss", "mse"):
        np.testing.assert_allclose(float(mp[k]), c["metrics"][k], rtol=BF16_MODEL_TOL["loss"])
    np.testing.assert_allclose(float(mp["mmd"]), c["metrics"]["mmd"], rtol=0,
                               atol=BF16_MODEL_TOL["mmd"])
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in pm.named_parameters()}
    gp = params_from_reference_state_dict(grads, n_layers=2, has_gravity=True)
    gj = jax.tree.leaves(c["gj"])
    top = max(float(np.abs(b).max()) for b in gj)
    for a, b in zip(jax.tree.leaves(gp), gj):
        assert np.abs(a - b).max() <= BF16_MODEL_TOL["grad"] * max(np.abs(b).max(), 1e-2 * top)
    # Adam's first update is lr * g / (|g| + eps): where the gradients are
    # well above the rounding noise both packages move by the same lr * sign
    new = params_from_reference_state_dict(
        {k: v.detach().numpy() for k, v in pm.state_dict().items()}, n_layers=2,
        has_gravity=True)
    for a, b, g in zip(jax.tree.leaves(new), jax.tree.leaves(c["new"]), gj):
        keep = np.abs(g) >= 1e-2 * top
        np.testing.assert_allclose(a[keep], b[keep], rtol=0, atol=1e-6)


def test_bf16_velocity_and_gravity_heads_add_their_bias_in_f32():
    # The JAX heads add their output bias in f32 after the bf16 product
    # (fastegnn_tpu/models/fastegnn_core.py:296-305).  With heads whose
    # product is small beside an O(1) bias, the coordinate update is the
    # bias times v and g, so a bias rounded to bf16 shows: adding it inside
    # the bf16 product gave 2.0e-3 - 3.0e-3 of the update; in f32 the error
    # is 1.1e-6 - 2.7e-6 (generator seeds 0-2).  Coordinates are bf16 values, so the
    # JAX bf16 pool that rounds them (reference defect 5) changes nothing.
    H, C, B, n_max = 64, 3, 3, 20
    n = B * n_max
    rng = np.random.default_rng(0)
    jb, _ = _batches(n_graphs=B, n_nodes=n_max, seed=3)
    jm = JFastEGNN(hidden=H, virtual_channels=C, n_layers=1, gravity=GRAV, fuse_edge=False,
                   compute_dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jb)["params"])
    for head in ("coord_mlp_vel", "gravity_mlp"):
        lin1 = params["gcl_0"][head]["lin1"]
        lin1["kernel"] = lin1["kernel"] * 1e-3
        lin1["bias"] = rng.uniform(0.5, 1.0, size=1).astype(np.float32)
    pm = FastEGNN(2, 2, hidden=H, virtual_channels=C, n_layers=1, gravity=GRAV,
                  compute_dtype=torch.bfloat16, device="cpu")
    pm.load_state_dict(state_dict_from_jax_params(params))

    def f32(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    h, v, vx, vh, agg_e = f32(n, H), f32(n, 3), f32(B, C, 3), f32(B, C, H), f32(n, H)
    x = f32(n, 3).astype(jnp.bfloat16).astype(np.float32)
    agg_x = f32(n, 3, scale=0.1)
    gid = np.repeat(np.arange(B), n_max).astype(np.int32)
    mask = np.ones(n, bool)
    g = np.asarray(GRAV, np.float32)
    cfg = jcore.LayerCfg(hidden=H, virtual_channels=C, has_gravity=True,
                         compute_dtype=jnp.bfloat16)
    w = jcore.LayerWeights.from_param_dict(params["gcl_0"], True, False)
    take, pool = jcore.make_take_pool(jnp.asarray(gid), jnp.asarray(mask), B,
                                      use_onehot=True, compute_dtype=jnp.bfloat16)
    _, xj, _, _ = jcore.virtual_and_node_update(cfg, w, h, x, v, vx, vh, jnp.asarray(gid),
                                                agg_x, agg_e, take=take, pool=pool,
                                                gravity=jnp.asarray(g))
    t = torch.tensor
    with torch.no_grad():
        _, xp, _, _ = pcore.virtual_and_node_update(
            pm.gcl_0.cfg, pm.gcl_0, t(h), t(x), t(v), t(vx), t(vh), t(gid).long(), t(mask),
            t(agg_x), t(agg_e), gravity=t(g))
    xj = np.asarray(xj)
    assert np.abs(xp.numpy() - xj).max() <= 2e-5 * np.abs(xj - x).max()


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


@pytest.mark.parametrize("rest", [(3,), (3, 5)])
def test_per_graph_pool_is_the_jax_graph_mean_pool(rest):
    """The virtual-node pool, a masked sum over the batch's ``[B, n_max]``
    layout, against the JAX ``graph_mean_pool`` over ``graph_id``: padded
    rows (the dump id ``B``) add nothing and a graph without a real node
    pools to 0.  Measured gap 1.2e-7 (the two sum in another order); atol
    1e-6 on values of order 1."""
    from fastegnn_tpu.ops.segment import graph_mean_pool as jpool

    rng = np.random.default_rng(3)
    B, n_max = 4, 7
    mask = rng.random(B * n_max) < 0.7
    mask[2 * n_max:3 * n_max] = False                 # graph 2 has no real node
    gid = np.where(mask, np.repeat(np.arange(B), n_max), B)
    z = rng.normal(size=(B * n_max,) + rest).astype(np.float32)
    got = pcore.per_graph_pool(torch.tensor(z), torch.tensor(mask), B)
    want = np.asarray(jpool(jnp.asarray(z), jnp.asarray(gid), B, jnp.asarray(mask)))
    assert got.shape == (B,) + rest
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert not got[2].any()
