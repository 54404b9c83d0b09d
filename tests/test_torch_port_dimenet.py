"""The port's DimeNet / DimeNet++, their bases and their triplet tables
against the JAX package.

Parity inputs keep every real edge at d / cutoff >= 0.25 (``_spread``,
asserted in ``_batches``): the JAX package's f32 Bessel basis is garbage
nearer to 0 (reference defect 8, ROADMAP.md §3; pinned by
``test_the_jax_f32_basis_fails_near_zero_and_the_port_does_not``), so a
parity input with closer pairs would compare the port with the defect.
They are 2 graphs of 9 nodes at spacing >= 1 in a cube of side 2.5, with
a random 30% of the directed edges dropped (so some nodes have no incoming
edge), padded to 10 nodes, cutoff 4.  The models run at hidden 16, 2
blocks and the CLI's bases (7 spherical x 6 radial, 8 bilinear); the ++
model at int_emb 8, basis_emb 4, out_emb 16.  The output blocks' last
linear starts at zero (the reference's init), so the parity weights draw
it afresh, or the forward test would compare zeros.  Weights cross through
the reference state-dict layout: JAX params -> ``state_dict_from_dimenet_
params`` -> port, and back through ``params_from_dimenet_state_dict``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastegnn_tpu.data import nbody as jnbody
from fastegnn_tpu.graph import GraphSpec as JSpec, batch_graphs as jbatch, pad_graph as jpad
from fastegnn_tpu.models import dimenet as jdn
from fastegnn_tpu.train import torch_adam as jadam
from fastegnn_tpu.train.loss import masked_mse as jmse
from fastegnn_tpu.utils.torch_import import params_from_dimenet_state_dict
from fastegnn_tpu_torch.data import nbody as pnbody
from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, build_triplets, pad_graph
from fastegnn_tpu_torch.models import dimenet as pdn
from fastegnn_tpu_torch.ops.neighbors import cutoff_edges_np
from fastegnn_tpu_torch.ops.rotation import random_rotation
from fastegnn_tpu_torch.train.loss import masked_mse
from fastegnn_tpu_torch.train.optim import torch_adam
from fastegnn_tpu_torch.train.step import make_train_step
from fastegnn_tpu_torch.utils import weights as pweights

from helpers import random_raw_graph
from test_torch_port_nbody import check_one_train_step, leaf_gaps, make_trio

CUT = 4.0
KW = dict(hidden=16, num_blocks=2, cutoff=CUT, int_emb_size=8, basis_emb_size=4,
          out_emb_channels=16)
TRIPLET_FIELDS = ("idx_i", "idx_j", "idx_k", "idx_kj", "idx_ji")


def _spread(rng, n, side=2.5, spacing=1.0):
    """``n`` positions in a cube, each at least ``spacing`` from the others."""
    loc = []
    while len(loc) < n:
        p = rng.uniform(0, side, size=3)
        if all(np.linalg.norm(p - q) >= spacing for q in loc):
            loc.append(p)
    return np.asarray(loc, np.float32)


def _raw(rng, n, drop=0.3):
    r = random_raw_graph(rng, n)
    r["coord"] = loc = _spread(rng, n)
    r["coord_target"] = loc + r["vel"]
    dst, src = cutoff_edges_np(loc, 0.0)
    keep = rng.random(dst.shape[0]) >= drop
    dst, src = dst[keep], src[keep]
    d0 = np.linalg.norm(loc[dst] - loc[src], axis=1, keepdims=True).astype(np.float32)
    r.update(dst=dst, src=src, edge_attr=np.concatenate([d0, d0], 1))
    return r


def _pair(raws, max_nodes, max_edges):
    kw = dict(max_nodes=max_nodes, max_edges=max_edges, n_graphs=len(raws), edge_attr_dim=2)
    js, ps = JSpec(**kw), GraphSpec(**kw)
    return (jbatch([jpad(js, **r) for r in raws], js),
            batch_graphs([pad_graph(ps, **r) for r in raws], ps, device="cpu"))


def _jax_triplets(jb):
    return jdn.build_triplets(np.asarray(jb.dst), np.asarray(jb.src), np.asarray(jb.edge_mask),
                              jb.num_nodes)


def _batches(seed=5):
    """The JAX batch and triplets and the port batch carrying its own."""
    rng = np.random.default_rng(seed)
    jb, pb = _pair([_raw(rng, 9) for _ in range(2)], 10, 90)
    ne = pb.n_real_edges
    d = (pb.coord[pb.src[:ne].long()] - pb.coord[pb.dst[:ne].long()]).norm(dim=-1)
    assert float(d.min()) / CUT >= 0.25, "reference defect 8: keep d / cutoff >= 0.25"
    pb.triplets = build_triplets(pb)
    return jb, _jax_triplets(jb), pb


def _jax_params(jm, jb, jt, seed=1):
    """JAX init, with the zero-initialised ``lin_out`` drawn afresh."""
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0), jb, jt)["params"])
    rng = np.random.default_rng(seed)
    for name, block in params.items():
        if name.startswith("output_"):
            k = block["lin_out"]["kernel"]
            block["lin_out"]["kernel"] = (0.3 * rng.normal(size=k.shape)).astype(np.float32)
    return params


def _to_jax(sd, plusplus):
    return params_from_dimenet_state_dict(sd, num_blocks=2, plusplus=plusplus)


def _sd_numpy(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


# --- bases ------------------------------------------------------------------


def test_jn_zeros_equal_the_jax_zeros_exactly():
    np.testing.assert_array_equal(pdn.jn_zeros(7, 6), jdn._jn_zeros(7, 6))


def test_bessel_basis_matches_scipy_in_f64():
    from scipy import special

    d = np.geomspace(1e-3, 1.0, 4001)
    got = pdn.bessel_basis(torch.tensor(d, dtype=torch.float32), 7, 6).numpy()
    zeros = jdn._jn_zeros(7, 6)
    d32 = d.astype(np.float32).astype(np.float64)
    want = np.stack([np.sqrt(2.0) / abs(special.spherical_jn(l + 1, zeros[l, m]))
                     * special.spherical_jn(l, zeros[l, m] * d32)
                     for l in range(7) for m in range(6)], -1)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_bessel_basis_matches_the_jax_basis_from_a_quarter_of_the_cutoff():
    bessel, _ = jdn._basis_cache(7, 6)
    d = np.linspace(0.25, 1.0, 2001, dtype=np.float32)
    want = np.asarray(bessel(jnp.asarray(d)))
    got = pdn.bessel_basis(torch.tensor(d), 7, 6).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_the_jax_f32_basis_fails_near_zero_and_the_port_does_not():
    # reference defect 8: sympy's closed form of j_l cancels near 0 in f32
    from scipy import special

    bessel, _ = jdn._basis_cache(7, 6)
    d = np.float32(0.01)
    zeros = jdn._jn_zeros(7, 6)
    want = np.array([np.sqrt(2.0) / abs(special.spherical_jn(l + 1, zeros[l, m]))
                     * special.spherical_jn(l, zeros[l, m] * float(d))
                     for l in range(7) for m in range(6)])
    jax_err = np.abs(np.asarray(bessel(jnp.asarray([d])))[0] - want).max()
    port_err = np.abs(pdn.bessel_basis(torch.tensor([d]), 7, 6).numpy()[0] - want).max()
    assert jax_err > 1.0
    assert port_err <= 1e-6 * np.abs(want).max()


def test_angular_basis_and_envelope_match_jax():
    _, sph = jdn._basis_cache(7, 6)
    theta = np.linspace(0.0, np.pi, 501, dtype=np.float32)
    want = np.asarray(sph(jnp.asarray(theta)))
    got = pdn.spherical_harmonics_m0(torch.tensor(theta), 7).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    x = np.linspace(0.05, 1.2, 300, dtype=np.float32)
    want = np.asarray(jdn.envelope(jnp.asarray(x)))
    got = pdn.envelope(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert not got[x >= 1.0].any()


def test_spherical_jn_is_exact_on_both_sides_of_the_hand_over():
    # the series below SERIES_BELOW, the closed form from it: both within
    # 1e-14 of scipy there, for every order
    from scipy import special

    x = pdn.SERIES_BELOW + np.array([-1e-9, 0.0, 1e-9])
    for l in range(7):
        got = pdn.spherical_jn(l, torch.tensor(x, dtype=torch.float64)).numpy()
        assert np.abs(got - special.spherical_jn(l, x)).max() <= 1e-14


# --- triplets ---------------------------------------------------------------


def _hand(dst, src, n, max_nodes=None, max_edges=None):
    loc = np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32)
    e = len(dst)
    return dict(node_feat=np.ones((n, 2), np.float32), coord=loc, vel=loc, dst=np.array(dst),
                src=np.array(src), edge_attr=np.ones((e, 2), np.float32), coord_target=loc)


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    return make_trio(tmp_path_factory)


@pytest.mark.parametrize("case", ["small", "no_incoming", "padded", "asymmetric", "nbody"])
def test_triplets_equal_the_jax_tables_real_prefix(case, trio):
    if case == "nbody":   # the CLI's N-body batch, 2 graphs at --cutoff_rate 0.5
        root, name = trio
        opts = dict(partition="train", virtual_channels=3, cutoff_rate=0.5)
        jb = jnbody.NBodyDataset(root, name, **opts).collate([0, 1])
        pb = pnbody.NBodyDataset(root, name, device="cpu", **opts).collate([0, 1])
    else:
        raws, nodes, edges = {
            # edges j -> i: 0->1, 1->2, 2->1 (tests/test_dimenet.py)
            "small": ([_hand([0, 1, 2], [1, 2, 1], 3)], 3, 3),
            # node 3 has no edge with src 3, node 0 none with dst 0
            "no_incoming": ([_hand([1, 2, 3, 3, 1], [0, 1, 2, 1, 3], 4)], 4, 5),
            # two graphs of different sizes: padded nodes and edges
            "padded": ([_hand([0, 1, 2, 2, 0], [1, 0, 0, 1, 2], 3),
                        _hand([0, 1, 1, 2, 3, 3], [1, 0, 3, 3, 2, 0], 5)], 6, 8),
            "asymmetric": ([_raw(np.random.default_rng(s), 8) for s in (1, 2, 3)], 8, 56),
        }[case]
        jb, pb = _pair(raws, nodes, edges)
    jt = _jax_triplets(jb)
    pt = build_triplets(pb)
    real = np.asarray(jt.mask)
    assert real.all() and pt.num_triplets == real.sum() > 0
    for f in TRIPLET_FIELDS:
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(jt, f)),
                                      err_msg=f)
    ne, ji, kj = pb.n_real_edges, pt.idx_ji.numpy(), pt.idx_kj.numpy()
    np.testing.assert_array_equal(pt.rowptr.numpy(), np.searchsorted(ji, np.arange(ne + 1)))
    np.testing.assert_array_equal(pt.kj_perm.numpy(), np.argsort(kj, kind="stable"))
    np.testing.assert_array_equal(pt.kj_rowptr.numpy(),
                                  np.searchsorted(np.sort(kj), np.arange(ne + 1)))
    assert all(getattr(pt, f).dtype == torch.int32 for f in TRIPLET_FIELDS)


def test_triplet_dataset_attaches_and_keeps_the_tables(trio):
    root, name = trio
    ds = pdn.TripletDataset(pnbody.NBodyDataset(root, name, partition="valid", device="cpu",
                                                virtual_channels=3, cutoff_rate=0.5))
    assert len(ds) == 2 and ds.num_batches(2) == 1 and ds.spec.max_nodes == 12
    ds.enable_collate_cache()   # as train() does for its eval splits
    first = next(ds.iter_batches(2))
    again = ds.collate([0, 1])
    assert again is first and again.triplets is first.triplets
    fresh = build_triplets(first)
    for f in TRIPLET_FIELDS:
        assert torch.equal(getattr(first.triplets, f), getattr(fresh, f))
    moved = first.to("cpu")
    assert moved.triplets is not first.triplets
    assert torch.equal(moved.triplets.kj_perm, first.triplets.kj_perm)


# --- blocks -----------------------------------------------------------------


def _held(jf, jparams, jx, pf, port_grads):
    """Forward within 1e-5 of the largest value; the gradients of a random
    weighting of the output (parameters and the input) within 1e-4 of their
    floored scale."""
    out = np.asarray(jax.jit(jf)(jparams, jx))
    cot = np.random.default_rng(0).normal(size=out.shape).astype(np.float32)
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(jf(p, x) * cot), argnums=(0, 1)))(jparams, jx)
    x = torch.tensor(np.asarray(jx), requires_grad=True)
    got = pf(x)
    (got * torch.tensor(cot)).sum().backward()
    assert np.abs(got.detach().numpy() - out).max() <= 1e-5 * np.abs(out).max()
    gaps, _ = leaf_gaps([x.grad.numpy(), port_grads()], [gx, gp])
    assert max(gaps) <= 1e-4, gaps


def _from_port(flat, params, mapper):
    """A JAX tree shaped like ``params`` from the port tensors ``flat``, keyed
    as ``mapper`` (a JAX block -> port state-dict function) names them: each
    JAX leaf's port key is found by mapping a tree that is zero but there."""
    def fill(tree, path):
        if isinstance(tree, dict):
            return {k: fill(v, path + (k,)) for k, v in tree.items()}
        return path

    paths = fill(params, ())
    keyed = {}
    for path in jax.tree.leaves(paths, is_leaf=lambda x: isinstance(x, tuple)):
        probe = jax.tree.map(np.zeros_like, params)
        node = probe
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = np.ones_like(node[path[-1]])
        sd = {}
        mapper(sd, "m", probe)
        (key,) = [k for k, v in sd.items() if v.numpy().any()]
        g = flat[key[2:]].numpy()
        keyed[path] = g.T if path[-1] == "kernel" else g
    return jax.tree.map(lambda p: keyed[p], paths, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("kind", ["interaction", "interaction++", "output", "output++"])
@pytest.mark.parametrize("chunk", [1 << 19, 7])
def test_blocks_match_jax(kind, chunk, monkeypatch):
    monkeypatch.setattr(pdn, "TRIPLET_CHUNK", chunk)
    jb, jt, pb = _batches(seed=8)
    ne, H = pb.n_real_edges, 16
    rng = np.random.default_rng(4)
    x = rng.normal(size=(jb.num_edges, H)).astype(np.float32)
    rbf = rng.normal(size=(jb.num_edges, 6)).astype(np.float32)
    sbf = rng.normal(size=(pb.triplets.num_triplets, 42)).astype(np.float32)
    emask = np.asarray(jb.edge_mask)
    mask = np.asarray(jb.node_mask)
    if kind.startswith("interaction"):
        plus = kind.endswith("++")
        jm = (jdn.InteractionPPBlock(H, 8, 4, 7, 6) if plus
              else jdn.InteractionBlock(H, 8, 7, 6))
        pm = (pdn.InteractionPPBlock(H, 8, 4, 7, 6) if plus
              else pdn.InteractionBlock(H, 8, 7, 6))
        mapper = pweights.dimenet_interaction_block
        params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0), x, rbf, sbf,
                                                           jt)["params"])

        def jf(p, xx):
            return jm.apply({"params": p}, xx, rbf, sbf, jt)[emask]

        def pf(xx):
            return pm(xx[:ne], torch.tensor(rbf[:ne]), torch.tensor(sbf), pb.triplets)
    else:
        out_emb = 32 if kind.endswith("++") else None
        jm = (jdn.OutputPPBlock(H, out_emb, 3) if out_emb else jdn.OutputBlock(H, 3))
        pm = pdn.OutputBlock(H, 3, 6, out_emb_channels=out_emb)
        mapper = pweights.dimenet_output_block
        args = (jb.src, jb.num_nodes, jb.edge_mask)
        params = jax.tree.map(np.asarray, jax.jit(lambda k, *a: jm.init(k, *a, *args))(
            jax.random.key(0), x, rbf)["params"])
        params["lin_out"]["kernel"] = rng.normal(
            size=params["lin_out"]["kernel"].shape).astype(np.float32)

        def jf(p, xx):
            return jm.apply({"params": p}, xx, rbf, *args)[mask]

        def pf(xx):
            return pm(xx[:ne], torch.tensor(rbf[:ne]), pb)[torch.tensor(mask)]
    sd = {}
    mapper(sd, "m", params)
    pm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    _held(jf, params, x, pf, lambda: _from_port(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in pm.named_parameters()}, params, mapper))


# --- the models ---------------------------------------------------------------


@pytest.fixture(scope="module", params=[False, True], ids=["DimeNet", "DimeNet++"])
def case(request):
    plus = request.param
    jb, jt, pb = _batches()
    jm = jdn.DimeNet(plusplus=plus, **KW)
    params = _jax_params(jm, jb, jt)
    pm = pdn.DimeNet(2, 2, plusplus=plus, device="cpu", **KW)
    pm.load_state_dict(pweights.state_dict_from_dimenet_params(params), strict=True)

    def jloss(p):
        out = jm.apply({"params": p}, jb, jt)
        return jmse(out, jb.coord_target, jb.node_mask), out

    (loss, out), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    return dict(plus=plus, jm=jm, jb=jb, jt=jt, pb=pb, pm=pm, params=params,
                out=np.asarray(out), loss=float(loss), gj=gj)


def test_weights_round_trip_bit_for_bit(case):
    plus = case["plus"]
    pm = pdn.DimeNet(2, 2, plusplus=plus, device="cpu",
                     generator=torch.Generator().manual_seed(0), **KW)
    sd = _sd_numpy(pm)
    back = pweights.state_dict_from_dimenet_params(_to_jax(sd, plus))
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    again = _to_jax(_sd_numpy(case["pm"]), plus)
    assert jax.tree.structure(again) == jax.tree.structure(case["params"])
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(case["params"])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("plus", [False, True])
def test_keys_and_initialisation_follow_the_reference(plus):
    pm = pdn.DimeNet(2, 2, hidden=64, plusplus=plus, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    keys = set(pm.state_dict())
    assert {"rbf.freq", "emb.emb.weight", "emb.emb.bias", "emb.lin_rbf.weight", "emb.lin.weight",
            "output_blocks.4.lin_rbf.weight", "output_blocks.0.lins.2.bias",
            "output_blocks.0.lin.weight", "interaction_blocks.3.lin.bias",
            "interaction_blocks.0.layers_before_skip.0.lin1.weight",
            "interaction_blocks.0.layers_after_skip.0.lin2.bias"} <= keys
    after = {k.split(".")[3] for k in keys if ".layers_after_skip." in k}
    # the ++ block's after-skip stack is sized by num_before_skip (1)
    assert after == ({"0"} if plus else {"0", "1"})
    assert ("interaction_blocks.0.W" in keys) != plus
    assert ("output_blocks.0.lin_up.weight" in keys) == plus
    assert not any(k.endswith("lin.bias") and k.startswith("output_blocks") for k in keys)
    torch.testing.assert_close(pm.rbf.freq.detach(), torch.arange(1, 7.0) * np.pi)
    for block in pm.output_blocks:
        assert not block.lin.weight.any()
    w = pm.emb.emb.weight.detach()
    assert float(w.abs().max()) <= 3 ** 0.5 and not pm.emb.emb.bias.any()
    lin = pm.interaction_blocks[0].lin_ji.weight.detach()
    assert float(lin.var(unbiased=False)) == pytest.approx(2.0 / 128, rel=1e-4)
    assert not pm.interaction_blocks[0].lin_ji.bias.any()
    if not plus:
        w = pm.interaction_blocks[0].W.detach()
        assert float(w.std()) == pytest.approx(2.0 / 64, rel=0.05)


# measured: 5.4e-7 (DimeNet), 5.8e-7 (++) of the largest value
def test_forward_matches_jax(case):
    with torch.no_grad():
        got = case["pm"](case["pb"]).numpy()
    mask = np.asarray(case["jb"].node_mask)
    want = case["out"][mask]
    assert np.abs(got[mask] - want).max() <= 1e-5 * np.abs(want).max()


# measured: 1.1e-5 (DimeNet), 1.9e-6 (++) of each leaf's floored scale
def test_param_gradients_of_mse_match_jax(case):
    pm, pb = case["pm"], case["pb"]
    pm.zero_grad()
    loss = masked_mse(pm(pb), pb.coord_target, pb.node_mask)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(case["loss"], rel=1e-5)
    grads = {k: p.grad.numpy() for k, p in pm.named_parameters()}
    gp = _to_jax(grads, case["plus"])
    assert jax.tree.structure(gp) == jax.tree.structure(case["gj"])
    gaps, _ = leaf_gaps(gp, case["gj"])
    assert max(gaps) <= 1e-4, gaps


def test_one_train_step_matches_jax(case):
    jm, jb, jt, params = case["jm"], case["jb"], case["jt"], case["params"]

    def jloss(p):
        return jmse(jm.apply({"params": p}, jb, jt), jb.coord_target, jb.node_mask)

    mse, gj = jax.jit(jax.value_and_grad(jloss))(params)
    tx = jadam(5e-4, 1e-12)
    updates, _ = tx.update(gj, tx.init(params), params)
    pm = pdn.DimeNet(2, 2, plusplus=case["plus"], device="cpu", **KW)
    pm.load_state_dict(pweights.state_dict_from_dimenet_params(params), strict=True)
    out = make_train_step(pm, torch_adam(pm.parameters(), 5e-4, 1e-12), use_mmd=False)(
        case["pb"])
    grads = {k: p.grad.numpy() for k, p in pm.named_parameters()}
    r = dict(jax=dict(loss=float(mse), mse=float(mse), mmd=0.0),
             port={k: float(v) for k, v in out.items()}, gj=gj,
             gp=_to_jax(grads, case["plus"]), new_j=optax.apply_updates(params, updates),
             new_p=_to_jax(_sd_numpy(pm), case["plus"]))
    check_one_train_step(r)


def test_rotation_invariance(case):
    # the output is built from distances and angles (tests/test_dimenet.py:73-96)
    pm, pb = case["pm"], case["pb"]
    R = random_rotation(np.random.default_rng(1)).astype(np.float32)
    moved = pb.to("cpu")
    moved.coord = pb.coord @ torch.tensor(R) + torch.tensor([0.5, -1.0, 2.0])
    with torch.no_grad():
        a, b = pm(pb).numpy(), pm(moved).numpy()
    assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()


def test_forward_needs_the_triplet_table(case):
    bare = case["pb"].to("cpu")
    bare.triplets = None
    with pytest.raises(ValueError, match="TripletDataset"):
        case["pm"](bare)
