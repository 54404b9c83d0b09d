"""The port's TFN / SE(3)-Transformer layers and ``segment_softmax`` against
the JAX package on the same weights and inputs.

Weights cross from JAX params to the port through
``utils/weights.py::state_dict_from_gconv_params``'s module walk, and
gradients back through :func:`to_jax` here.  Inputs are 2 graphs of 8
nodes and one padded node (``helpers.random_raw_graph``) with a random 30%
of the directed edges dropped, so that the edge set is not symmetric, and
every node keeping at least one edge at src: the JAX norm layer's gradient
is NaN at a zero feature row (ROADMAP.md §3, reference defect 9), which a
node without an edge at src gets.  Widths 2-4, two or three degrees, f32.
Forward within 1e-5 of the largest value, gradients within 1e-5 of each
leaf's floored scale (``test_torch_port_nbody.py::leaf_gaps``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastegnn_tpu.graph import GraphSpec as JSpec, batch_graphs as jbatch, pad_graph as jpad
from fastegnn_tpu.models.tfn import layers as jlayers
from fastegnn_tpu.models.tfn.models import _edge_geometry as jgeometry
from fastegnn_tpu.ops.segment import segment_softmax as jsoftmax
from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph
from fastegnn_tpu_torch.models.tfn import layers as players
from fastegnn_tpu_torch.models.tfn.models import edge_geometry
from fastegnn_tpu_torch.ops import spmm
from fastegnn_tpu_torch.ops.segment import segment_softmax
from fastegnn_tpu_torch.utils.weights import state_dict_from_gconv_params

from helpers import random_raw_graph
from test_torch_port_nbody import leaf_gaps

FWD_TOL = GRAD_TOL = 1e-5


def raws(n_graphs=2, n_nodes=8, seed=5):
    """Raw graphs with a random 70% of their directed edges, each node
    keeping one edge at src at least."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        r = random_raw_graph(rng, n_nodes)
        keep = rng.random(r["dst"].shape[0]) < 0.7
        for n in range(n_nodes):
            if not keep[r["src"] == n].any():
                keep[np.flatnonzero(r["src"] == n)[0]] = True
        out.append({**r, "dst": r["dst"][keep], "src": r["src"][keep],
                    "edge_attr": r["edge_attr"][keep]})
    return out


def batches(rs, flip=False, pad_nodes=1):
    """The JAX and the port batch of raw graphs ``rs``; with ``flip`` the
    port batch has every edge's src and dst swapped."""
    n = rs[0]["coord"].shape[0]
    kw = dict(max_nodes=n + pad_nodes, max_edges=n * (n - 1), n_graphs=len(rs),
              edge_attr_dim=2)
    js, ps = JSpec(**kw), GraphSpec(**kw)
    prs = [{**r, "dst": r["src"], "src": r["dst"]} for r in rs] if flip else rs
    return (jbatch([jpad(js, **r) for r in rs], js),
            batch_graphs([pad_graph(ps, **r) for r in prs], ps, device="cpu"))


def to_jax(sd):
    """A port ``state_dict``-shaped dict of numpy arrays -> the JAX tree of
    the modules that carry the JAX names: ``lin*`` and ``fc*`` linears
    (kernel ``[in, out]``), ``bn*`` LayerNorms (``scale``), and every other
    entry a parameter as it is (the inverse of the weights module walk)."""
    tree = {}
    for key, v in sd.items():
        *path, field = key.split(".")
        v = np.asarray(v)
        if path and path[-1].startswith(("lin", "fc")):
            leaf = {"weight": "kernel", "bias": "bias"}[field]
            v = v.T if field == "weight" else v
        elif path and path[-1].startswith("bn"):
            leaf = {"weight": "scale", "bias": "bias"}[field]
        else:
            path, leaf = path + [field], None
        node = tree
        for p in path[:-1] if leaf is None else path:
            node = node.setdefault(p, {})
        node[path[-1] if leaf is None else leaf] = v
    return tree


def port_grads(module):
    return to_jax({k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
                   for k, p in module.named_parameters()})


def check_grads(got, want, tol=GRAD_TOL):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    gaps, _ = leaf_gaps(got, want)
    assert max(gaps) <= tol, gaps
    return max(gaps)


def check_forward(got, want, rows=None):
    """Each entry of ``got`` within FWD_TOL of the largest |want| over all."""
    pick = (lambda a: a) if rows is None else (lambda a: a[rows])
    top = max(float(np.abs(pick(np.asarray(w))).max()) for w in want.values())
    assert got.keys() == want.keys()
    for d in want:
        np.testing.assert_allclose(pick(got[d].detach().numpy()), pick(np.asarray(want[d])),
                                   rtol=0, atol=FWD_TOL * top, err_msg=f"degree {d}")


def features(fiber, n, seed):
    rng = np.random.default_rng(seed)
    return {d: rng.normal(size=(n, m, 2 * d + 1)).astype(np.float32) for m, d in fiber}


@pytest.fixture(scope="module")
def graph():
    jb, pb = batches(raws())
    return jb, pb, jgeometry(jb, 2), edge_geometry(pb, 2)


# --- segment_softmax ----------------------------------------------------------


def test_segment_softmax_matches_jax_with_empty_and_masked_segments():
    # 40 rows over segments 0-5 of 9: 6-8 are empty, every row of 5 is
    # masked; masked rows carry large logits, which must not count
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 6, 40).astype(np.int32)
    logits = (rng.normal(size=(40, 2)) * 3).astype(np.float32)
    mask = (rng.random(40) < 0.8) & (ids != 5)
    logits[~mask] += 50.0
    w = rng.normal(size=(40, 2)).astype(np.float32)

    def jloss(x):
        a = jsoftmax(x, jnp.asarray(ids), 9, mask=jnp.asarray(mask))
        return jnp.sum(a * w), a

    (_, want), gj = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logits))
    rows = np.flatnonzero(mask)
    sub = torch.tensor(ids[rows])
    perm = torch.argsort(sub, stable=True).int()
    rowptr = torch.searchsorted(sub[perm.long()], torch.arange(10, dtype=torch.int32),
                                out_int32=True)
    x = torch.tensor(logits[rows], requires_grad=True)
    got = segment_softmax(x, sub, perm, rowptr, 9)
    (got * torch.tensor(w[rows])).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want)[rows], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(want)[~mask], 0.0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gj)[rows], rtol=0, atol=1e-6)
    sums = torch.zeros(9, 2).index_add_(0, sub.long(), got.detach())
    np.testing.assert_allclose(sums[:5].numpy(), 1.0, rtol=1e-6)


def test_segment_softmax_sums_on_the_kernel(monkeypatch):
    # the denominator's sum forward and its gather's backward go through
    # segment_sum_csr (the kernel on a card), in the perm form
    calls = []
    plain = spmm.segment_sum_csr

    def counted(data, rowptr, perm=None):
        calls.append(perm is not None)
        return plain(data, rowptr, perm)

    monkeypatch.setattr(spmm, "segment_sum_csr", counted)
    ids = torch.tensor([0, 2, 0, 1, 2, 2], dtype=torch.int32)
    perm = torch.argsort(ids, stable=True).int()
    rowptr = torch.tensor([0, 2, 3, 6], dtype=torch.int32)
    x = torch.randn(6, 1, generator=torch.Generator().manual_seed(0), requires_grad=True)
    segment_softmax(x, ids, perm, rowptr, 3).sum().backward()
    assert calls == [True, True]


# --- the fiber ----------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(num_degrees=3, num_channels=4),
                                dict(structure=[(2, 0), (3, 1), (1, 2)]),
                                dict(dictionary={2: 1, 0: 5})])
def test_fiber_matches_jax(kw):
    a, b = players.Fiber(**kw), jlayers.Fiber(**kw)
    assert a.structure == b.structure and a.structure_dict == b.structure_dict
    assert (a.multiplicities, a.degrees, a.n_features) == (b.multiplicities, b.degrees,
                                                           b.n_features)


# --- the layers ---------------------------------------------------------------

F_IN, F_MID = ((2, 0), (3, 1)), ((2, 0), (2, 1), (1, 2))


@pytest.mark.parametrize("edge_dim", [0, 2])
def test_gconv_se3_partial_matches_jax(graph, edge_dim):
    jb, pb, (r_j, basis_j), (r, basis) = graph
    h = features(F_IN, pb.num_nodes, 8)
    hj = {d: jnp.asarray(v) for d, v in h.items()}
    jconv = jlayers.GConvSE3Partial(F_IN, F_MID, edge_dim=edge_dim)
    params = jax.tree.map(np.asarray, jax.jit(jconv.init)(jax.random.key(1), hj, jb, r_j,
                                                           basis_j)["params"])
    ne, emask = pb.n_real_edges, np.asarray(jb.edge_mask)
    assert emask[:ne].all() and not emask[ne:].any()

    def jloss(p, hj):
        out = jconv.apply({"params": p}, hj, jb, r_j, basis_j)
        return sum(jnp.sum(jnp.where(jb.edge_mask[:, None, None], v, 0.0) ** 2)
                   for v in out.values()), out

    (_, want), (gp_j, gh_j) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, hj)
    pconv = players.GConvSE3Partial(F_IN, F_MID, edge_dim=edge_dim)
    pconv.load_state_dict(state_dict_from_gconv_params(params), strict=True)
    hp = {d: torch.tensor(v, requires_grad=True) for d, v in h.items()}
    got = pconv(hp, pb, r, basis)
    assert all(tuple(got[d].shape) == (ne, m, 2 * d + 1) for m, d in F_MID)
    check_forward(got, {d: np.asarray(v)[:ne] for d, v in want.items()})
    sum((v ** 2).sum() for v in got.values()).backward()
    check_grads(port_grads(pconv), gp_j)
    check_grads({d: hp[d].grad.numpy() for d in hp}, gh_j)


# a LayerNorm over 2 channels maps them to about +-1 whatever they are, so
# its input gradient is eps-sized and made of cancelling terms in both
# packages; the norm layers are held at 3-4 channels
F_NORM = ((4, 0), (3, 1), (3, 2))


@pytest.mark.parametrize("num_layers", [0, 1])
def test_gnorm_se3_matches_jax(num_layers):
    h = features(F_NORM, 12, 9)
    hj = {d: jnp.asarray(v) for d, v in h.items()}
    jnorm = jlayers.GNormSE3(F_NORM, num_layers=num_layers)
    params = jax.tree.map(np.asarray, jnorm.init(jax.random.key(2), hj)["params"])
    w = features(F_NORM, 12, 10)

    def jloss(p, hj):
        out = jnorm.apply({"params": p}, hj)
        return sum(jnp.sum(out[d] * w[d]) for d in out), out

    (_, want), (gp_j, gh_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(params, hj)
    pnorm = players.GNormSE3(F_NORM, num_layers=num_layers)
    pnorm.load_state_dict(state_dict_from_gconv_params(params), strict=True)
    assert all(m.eps == 1e-5 for m in pnorm.modules() if isinstance(m, torch.nn.LayerNorm))
    if num_layers:
        assert pnorm.lin_1_0.bias is not None   # the last linear only has one
    grads = {}
    for dtype in (torch.float64, torch.float32):
        pnorm.to(dtype).zero_grad()
        hp = {d: torch.tensor(v, dtype=dtype, requires_grad=True) for d, v in h.items()}
        got = pnorm(hp)
        sum((got[d] * torch.tensor(w[d], dtype=dtype)).sum() for d in got).backward()
        grads[dtype] = {d: hp[d].grad.double().numpy() for d in hp}
    check_forward(got, want)
    check_grads(port_grads(pnorm), gp_j)
    # the input gradients through the LayerNorms: the JAX ones are within
    # 1.4e-5 of an f64 evaluation (flax's one-pass variance), the port's
    # within 6.3e-7 (measured); so the port is held within 1e-5 of f64 and
    # within 1e-4 of JAX
    check_grads(grads[torch.float32], grads[torch.float64])
    check_grads(grads[torch.float32], {d: np.asarray(g, np.float64) for d, g in gh_j.items()},
                tol=1e-4)


def test_gnorm_gradient_is_finite_at_a_zero_feature_row():
    # reference defect 9: jnp.linalg.norm's gradient at a zero vector is
    # NaN; torch's is 0, so the port's layer stays finite there
    h = features(F_MID, 4, 11)
    for v in h.values():
        v[1] = 0.0
    jnorm = jlayers.GNormSE3(F_MID, num_layers=1)
    hj = {d: jnp.asarray(v) for d, v in h.items()}
    params = jnorm.init(jax.random.key(3), hj)["params"]
    gj = jax.grad(lambda hj: sum(jnp.sum(v) for v in jnorm.apply({"params": params}, hj)
                                 .values()))(hj)
    assert np.isnan(np.asarray(gj[1])[1]).all()
    pnorm = players.GNormSE3(F_MID, num_layers=1)
    pnorm.load_state_dict(state_dict_from_gconv_params(jax.tree.map(np.asarray, params)))
    hp = {d: torch.tensor(v, requires_grad=True) for d, v in h.items()}
    sum(v.sum() for v in pnorm(hp).values()).backward()
    assert all(bool(torch.isfinite(hp[d].grad).all()) for d in hp)
    assert all(bool(torch.isfinite(p.grad).all()) for p in pnorm.parameters())


def test_g1x1_se3_matches_jax():
    h = features(F_MID, 12, 12)
    hj = {d: jnp.asarray(v) for d, v in h.items()}
    f_out = ((3, 0), (1, 1), (2, 2))
    jlin = jlayers.G1x1SE3(F_MID, f_out)
    params = jax.tree.map(np.asarray, jlin.init(jax.random.key(4), hj)["params"])

    def jloss(p, hj):
        out = jlin.apply({"params": p}, hj)
        return sum(jnp.sum(v ** 2) for v in out.values()), out

    (_, want), (gp_j, gh_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(params, hj)
    plin = players.G1x1SE3(F_MID, f_out)
    plin.load_state_dict(state_dict_from_gconv_params(params), strict=True)
    hp = {d: torch.tensor(v, requires_grad=True) for d, v in h.items()}
    got = plin(hp)
    check_forward(got, want)
    sum((v ** 2).sum() for v in got.values()).backward()
    check_grads(port_grads(plin), gp_j)
    check_grads({d: hp[d].grad.numpy() for d in hp}, gh_j)
    # the port's own draw: normal / sqrt(m_in), from an explicit generator
    players.G1x1SE3.draw_parameters_(plin, torch.Generator().manual_seed(0))
    assert float(plin.w_0.detach().abs().max()) < 5 / 2 ** 0.5


@pytest.mark.parametrize("n_heads", [1, 2])
def test_gmab_se3_matches_jax(graph, n_heads):
    jb, pb, _, _ = graph
    f_value, f_key = ((4, 0), (2, 1)), ((2, 0), (2, 1))
    E, N, ne = jb.dst.shape[0], pb.num_nodes, pb.n_real_edges
    v, k, q = features(f_value, E, 13), features(f_key, E, 14), features(f_key, N, 15)
    w = features(f_value, N, 16)
    jattn = jlayers.GMABSE3(f_value, f_key, n_heads=n_heads)

    def jloss(ins):
        out = jattn.apply({}, *ins, jb)
        return sum(jnp.sum(out[d] * w[d]) for d in out), out

    ins = tuple({d: jnp.asarray(a) for d, a in x.items()} for x in (v, k, q))
    (_, want), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(ins)
    pins = [{d: torch.tensor(a[:ne] if a.shape[0] == E else a, requires_grad=True)
             for d, a in x.items()} for x in (v, k, q)]
    got = players.GMABSE3(f_value, f_key, n_heads=n_heads)(*pins, pb)
    check_forward(got, want)
    sum((got[d] * torch.tensor(w[d])).sum() for d in got).backward()
    for x, gx in zip(pins, gj):
        check_grads({d: x[d].grad.numpy() for d in x},
                    {d: np.asarray(g)[:x[d].shape[0]] for d, g in gx.items()})


@pytest.mark.parametrize("div,n_heads", [(1, 1), (2, 2)])
def test_gse3_res_matches_jax(graph, div, n_heads):
    jb, pb, (r_j, basis_j), (r, basis) = graph
    f_in, f_out = ((2, 0), (2, 1)), ((4, 0), (4, 1), (4, 2))
    h = features(f_in, pb.num_nodes, 17)
    hj = {d: jnp.asarray(a) for d, a in h.items()}
    jres = jlayers.GSE3Res(f_in, f_out, div=div, n_heads=n_heads)
    params = jax.tree.map(np.asarray, jax.jit(jres.init)(jax.random.key(5), hj, jb, r_j,
                                                          basis_j)["params"])
    assert set(params) == {"v", "k", "q"}
    mask = np.asarray(jb.node_mask)

    def jloss(p, hj):
        out = jres.apply({"params": p}, hj, jb, r_j, basis_j)
        return sum(jnp.sum(jnp.where(jb.node_mask[:, None, None], v, 0.0) ** 2)
                   for v in out.values()), out

    (_, want), (gp_j, gh_j) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, hj)
    pres = players.GSE3Res(f_in, f_out, div=div, n_heads=n_heads)
    pres.load_state_dict(state_dict_from_gconv_params(params), strict=True)
    hp = {d: torch.tensor(a, requires_grad=True) for d, a in h.items()}
    got = pres(hp, pb, r, basis)
    check_forward(got, want, rows=mask)
    sum((v[torch.tensor(mask)] ** 2).sum() for v in got.values()).backward()
    check_grads(port_grads(pres), gp_j)
    check_grads({d: hp[d].grad.numpy()[mask] for d in hp},
                {d: np.asarray(gh_j[d])[mask] for d in hp})


# --- the chunked profile contraction ------------------------------------------


@pytest.mark.parametrize("edges_per_chunk", [7, 1000])
def test_chunked_profile_contraction_equals_the_unchunked_one(graph, monkeypatch,
                                                              edges_per_chunk):
    # a (1 -> 1) pair at 4 -> 3 channels: 36 profile floats per edge, wider
    # than the radial MLP's 32, so chunked; against the same pair with the
    # profile kept ([E, m_out, m_in, nfreq], the einsum path)
    _, pb, _, (r, basis) = graph
    torch.manual_seed(0)
    conv = players.PairwiseConv(1, 4, 1, 3)
    assert conv.chunked
    monkeypatch.setattr(players, "PROFILE_CHUNK", 36 * edges_per_chunk)
    ne = pb.n_real_edges
    assert ne > 2 * 7
    h0 = torch.randn(ne, 4, 3, generator=torch.Generator().manual_seed(1))
    w = torch.randn(ne, 3, 3, generator=torch.Generator().manual_seed(2))
    results = []
    for chunked in (True, False):
        conv.chunked = chunked
        conv.zero_grad()
        h_e = h0.clone().requires_grad_()
        out = conv(r, basis, h_e)
        (out * w).sum().backward()
        results.append((out.detach(), h_e.grad, {k: p.grad.clone()
                                                 for k, p in conv.named_parameters()}))
    (o1, g1, p1), (o0, g0, p0) = results
    torch.testing.assert_close(o1, o0, rtol=0, atol=1e-6 * float(o0.abs().max()))
    torch.testing.assert_close(g1, g0, rtol=0, atol=1e-6 * float(g0.abs().max()))
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], rtol=0, atol=1e-6 * float(p0[k].abs().max()),
                                   msg=k)


def test_only_profiles_wider_than_the_hidden_layer_are_chunked():
    # FastTFN's pairs (one channel) keep their profile; at nf = 32 every
    # pair of a middle layer, and the (1 -> 1) pair into or out of it, is
    # chunked
    assert not any(players.PairwiseConv(di, 1, do, 1).chunked for di in (0, 1) for do in (0, 1))
    assert all(players.PairwiseConv(di, 32, do, 32).chunked for di in (0, 1) for do in (0, 1))
    assert players.PairwiseConv(1, 1, 1, 32).chunked and not players.PairwiseConv(0, 1, 1, 32).chunked
    assert players.PairwiseConv(1, 32, 1, 1).chunked and not players.PairwiseConv(0, 32, 1, 1).chunked
