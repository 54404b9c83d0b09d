"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they need an NVIDIA GPU with nvcc and skip elsewhere.  On
a machine with the card, from the repository root (``--noconftest`` because
the suite's conftest imports JAX, which the card's machine need not have):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph
from fastegnn_tpu_torch.models.fast_egnn import FastEGNN
from fastegnn_tpu_torch.ops import edge_kernel as ek, spmm
from fastegnn_tpu_torch.ops.neighbors import cutoff_edges_np

pytestmark = pytest.mark.cuda
H = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _graph(device, n=150, n_graphs=2, seed=0):
    rng = np.random.default_rng(seed)
    spec = GraphSpec(max_nodes=n, max_edges=n * (n - 1) // 4 + 8, n_graphs=n_graphs,
                     edge_attr_dim=2)
    graphs = []
    for _ in range(n_graphs):
        loc = rng.normal(size=(n, 3)).astype(np.float32)
        vel = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
        dst, src = cutoff_edges_np(loc, 0.75)
        d0 = np.linalg.norm(loc[dst] - loc[src], axis=1, keepdims=True).astype(np.float32)
        graphs.append(pad_graph(
            spec, node_feat=rng.normal(size=(n, 2)).astype(np.float32), coord=loc, vel=vel,
            dst=dst, src=src, edge_attr=np.concatenate([d0, d0], 1), coord_target=loc + vel))
    return batch_graphs(graphs, spec, device=device)


def _weights(device, seed=1):
    g = torch.Generator().manual_seed(seed)
    shapes = [(2 * H + 3, H), (H,), (H, H), (H,), (H, H), (H,), (H, 1)]
    return [(torch.randn(s, generator=g) * 0.1).to(device) for s in shapes]


@pytest.mark.parametrize("bf16", [False, True])
def test_kernels_match_plain_versions(cuda, bf16):
    g = _graph(cuda)
    W1, b1, W2, b2, Wg1, bg1, wg2 = _weights(cuda)
    h = torch.randn(g.num_nodes, H, device=cuda)
    ud, us = ek.build_tables(h, W1, b1, bf16)
    wpack = ek.pack_weights(W1, W2, b2, Wg1, bg1, wg2, bf16)
    args = (ud, us, g.coord, g.rowptr, g.src, g.edge_attr, wpack, bf16)
    n_fwd = ek.FWD_LAUNCHES
    got = ek.edge_block_fwd(*args)
    torch.cuda.synchronize()
    assert ek.FWD_LAUNCHES == n_fwd + 1
    want = ek.edge_block_fwd_plain(*args)
    tol = 2e-2 if bf16 else 1e-5
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= tol * b.abs().max()
    dms = ek._rnd(torch.randn(g.num_nodes, H, device=cuda), bf16)
    dts = ek._rnd(torch.randn(g.num_nodes, 3, device=cuda), bf16)
    bargs = (ud, us, g.coord, g.rowptr, g.src, g.dst, g.edge_attr, wpack, dms, dts, bf16)
    got = ek.edge_block_bwd(*bargs)
    torch.cuda.synchronize()
    want = ek.edge_block_bwd_plain(*bargs)
    for a, b in zip(got, want):   # atomics reorder the f32 sums
        assert (a - b).abs().max() <= (2e-2 if bf16 else 5e-5) * b.abs().max()


@pytest.mark.parametrize("form,bf16", [("dst", False), ("dst", True), ("src", False),
                                       ("src", True)])
def test_segment_sum_matches_plain_version(cuda, form, bf16):
    g = _graph(cuda)
    data = torch.randn(g.n_real_edges, H + 3, device=cuda)
    if bf16:
        data = data.bfloat16()
    rowptr, perm = (g.rowptr, None) if form == "dst" else (g.src_rowptr, g.src_perm)
    before = spmm.SEGSUM_LAUNCHES
    got = spmm.segment_sum_csr(data, rowptr, perm)
    torch.cuda.synchronize()
    assert spmm.SEGSUM_LAUNCHES == before + 1
    want = spmm.segment_sum_csr_plain(data, rowptr, perm)
    assert got.dtype == torch.float32 and got.shape == (g.num_nodes, H + 3)
    # both sum in f32, possibly in another order
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_segment_sum_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    g = _graph(cuda, n=40)
    data = torch.randn(g.n_real_edges, 5, device=cuda)
    before = spmm.SEGSUM_LAUNCHES
    with pytest.raises(ValueError, match="int32"):
        spmm.segment_sum_csr(data, g.rowptr.long())
    with pytest.raises(ValueError, match="f32 or bf16"):
        spmm.segment_sum_csr(data.half(), g.rowptr)
    with pytest.raises(ValueError, match="contiguous"):
        spmm.segment_sum_csr(data.t().contiguous().t(), g.rowptr)
    with pytest.raises(ValueError, match="cpu"):
        spmm.segment_sum_csr(data, g.rowptr.cpu())
    assert spmm.SEGSUM_LAUNCHES == before


def test_model_on_card_matches_cpu(cuda):
    _model_on_card_matches_cpu(cuda, attention=False, launches=(2, 2, 0))


def test_attention_model_on_card_matches_cpu(cuda):
    # the CSR edge branch: three segment-sum launches per layer, no edge block
    _model_on_card_matches_cpu(cuda, attention=True, launches=(0, 0, 6))


def _model_on_card_matches_cpu(cuda, attention, launches):
    g = _graph(cuda, n=60, seed=3)
    gen = torch.Generator().manual_seed(0)
    kw = dict(hidden=64, n_layers=2, gravity=(0.0, -1.0, 0.0), attention=attention)
    model = FastEGNN(2, 2, device=cuda, generator=gen, **kw)
    cpu = FastEGNN(2, 2, device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    before = (ek.FWD_LAUNCHES, ek.BWD_LAUNCHES, spmm.SEGSUM_LAUNCHES)
    x, vx = model(g)
    x.square().sum().backward()
    torch.cuda.synchronize()
    after = (ek.FWD_LAUNCHES, ek.BWD_LAUNCHES, spmm.SEGSUM_LAUNCHES)
    assert tuple(a - b for a, b in zip(after, before)) == launches
    xc, vxc = cpu(g.to("cpu"))
    xc.square().sum().backward()
    torch.testing.assert_close(x.detach().cpu(), xc.detach(), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(vx.detach().cpu(), vxc.detach(), atol=1e-4, rtol=1e-4)
    # each gradient against its own largest entry, floored at 1e-4 of the
    # model's largest gradient (some are rounding noise, ~1e-12)
    pairs = [(n, p.grad.cpu(), q.grad) for (n, p), q in
             zip(model.named_parameters(), cpu.parameters()) if q.grad is not None]
    top = max(float(q.abs().max()) for _, _, q in pairs)
    for name, a, b in pairs:
        scale = max(float(b.abs().max()), 1e-4 * top)
        assert float((a - b).abs().max()) <= 1e-4 * scale, name
