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


def _ragged_csr(rng, n, long_row, long_deg, empty):
    """Degrees of ``n`` rows: one row of ``long_deg`` edges, the rows in
    ``empty`` without edges, the others 0..8; and the CSR row pointer."""
    deg = rng.integers(0, 9, size=n)
    deg[long_row] = long_deg
    deg[list(empty)] = 0
    return deg, np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)


# the blockings of csrc/edge_block.cu: the f32 backward walks ranges of
# F32_ROWS dst rows in tiles of F32_TE edges (BWD_ROWS, TE), the bf16 kernels
# blocks of 4 rows in tiles of 64 edges (TC_ROWS, TC_TE)
F32_ROWS, F32_TE, TC_ROWS, TC_TE = 8, 48, 4, 64


def _ragged_edge_block_inputs(cuda, bf16, fe, n=70, long_deg=150,
                              empty=(*range(16, 32), 40, 41, 69), fan_src=None):
    """Inputs of the edge kernels at the edges of both blockings.  By default
    a hub row of 150 edges spans several tiles of either and shares its last
    tile with the next rows; rows 16..31 (a whole range or block of either)
    and a few more have no edges; ranges end in a partly filled tile; the
    last bf16 block has 2 rows; a padded tail past rowptr[N] (edge
    attributes 9) must not be read.  With ``fan_src``, that node is the src
    of every row's first edge.  Returns the generator for more draws and
    ``(ud, us, x, rowptr, src, dst, ea, wpack)``."""
    rng = np.random.default_rng(fe)
    pad = 9
    deg, rowptr = _ragged_csr(rng, n, 5, long_deg, list(empty))
    e = int(rowptr[-1])
    dst = np.concatenate([np.repeat(np.arange(n), deg), np.full(pad, n)]).astype(np.int32)
    src = np.concatenate([rng.integers(0, n, e), np.zeros(pad)]).astype(np.int32)
    if fan_src is not None:
        src[rowptr[:-1][deg > 0]] = fan_src
    ea = np.concatenate([rng.normal(size=(e, fe)), np.full((pad, fe), 9.0)]).astype(np.float32)
    t = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    x = t(rng.normal(size=(n, 3)).astype(np.float32))
    W1, b1, W2, b2, Wg1, bg1, wg2 = _weights(cuda)
    W1 = torch.cat([W1[:2 * H + 1], W1[2 * H + 1:2 * H + 1 + fe]])
    h = t(rng.normal(size=(n, H)).astype(np.float32))
    ud, us = ek.build_tables(h, W1, b1, bf16)
    wpack = ek.pack_weights(W1, W2, b2, Wg1, bg1, wg2, bf16)
    return rng, (ud, us, x, t(rowptr), t(src), t(dst), t(ea), wpack)


def _check_blockings(rowptr):
    """The default geometry of ``_ragged_edge_block_inputs`` against both
    blockings."""
    rowptr = rowptr.cpu().numpy()
    r, t = F32_ROWS, F32_TE
    # the f32 backward: the hub's range spans several tiles and ends in a
    # partly filled one, the third range is empty, later ones and the last
    # (6 rows) end in partly filled tiles
    n = len(rowptr) - 1
    assert rowptr[r] - rowptr[0] > 3 * t and (rowptr[r] - rowptr[0]) % t
    assert rowptr[3 * r] == rowptr[2 * r]
    assert (rowptr[5 * r] - rowptr[4 * r]) % t and (rowptr[n] - rowptr[n - n % r]) % t
    # the bf16 kernels: the hub's block spans more than two tiles; an empty
    # block; the last block has 2 rows
    b, tc = TC_ROWS, TC_TE
    assert (rowptr[2 * b] - rowptr[b]) % tc and rowptr[2 * b] - rowptr[b] > 2 * tc
    assert rowptr[20] == rowptr[16] and n % b == 2
    assert (rowptr[36] - rowptr[32]) % tc and rowptr[36] > rowptr[32]


def _bwd_args(cuda, bf16, fe, **geometry):
    rng, (ud, us, x, rowptr, src, dst, ea, wpack) = _ragged_edge_block_inputs(
        cuda, bf16, fe, **geometry)
    n = x.shape[0]
    dms = ek._rnd(torch.tensor(rng.normal(size=(n, H)).astype(np.float32), device=cuda), bf16)
    dts = ek._rnd(torch.tensor(rng.normal(size=(n, 3)).astype(np.float32), device=cuda), bf16)
    return (ud, us, x, rowptr, src, dst, ea, wpack, dms, dts, bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_edge_block_bwd_src_node_feeding_many_blocks(cuda, bf16):
    # 6000 rows: more ranges than the f32 backward's persistent grid has
    # blocks (2 per SM), so blocks walk several ranges; node 7 is the src of
    # every row's first edge, so its dUs and dx rows take atomics from every
    # block
    args = _bwd_args(cuda, bf16, 2, n=6000, long_deg=300, empty=range(100, 140), fan_src=7)
    got = ek.edge_block_bwd(*args)
    torch.cuda.synchronize()
    want = ek.edge_block_bwd_plain(*args)
    for name, a, b in zip(("dUd", "dUs", "dx", "dw"), got, want):
        assert bool(torch.isfinite(a).all()), name
        assert (a - b).abs().max() <= (2e-2 if bf16 else 5e-5) * b.abs().max(), name
    for a, b in ((got[1][7], want[1][7]), (got[2][7], want[2][7])):
        assert (a - b).abs().max() <= (2e-2 if bf16 else 5e-5) * b.abs().max()
    assert (got[0][100:140] == 0).all()


def test_f32_edge_block_bwd_dud_is_deterministic(cuda):
    # dUd rows are each stored once by the block that owns them, in a fixed
    # order: two calls agree bit for bit (the atomics' sums need not)
    args = _bwd_args(cuda, False, 3, n=3000, long_deg=400, empty=range(50, 80))
    first = ek.edge_block_bwd(*args)
    second = ek.edge_block_bwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("fe", [0, 1, 3])
def test_edge_block_bwd_at_tile_boundaries(cuda, bf16, fe):
    args = _bwd_args(cuda, bf16, fe)
    _check_blockings(args[3])
    before = ek.BWD_LAUNCHES
    got = ek.edge_block_bwd(*args)
    torch.cuda.synchronize()
    assert ek.BWD_LAUNCHES == before + 1
    want = ek.edge_block_bwd_plain(*args)
    for name, a, b in zip(("dUd", "dUs", "dx", "dw"), got, want):
        assert bool(torch.isfinite(a).all()), name
        assert (a - b).abs().max() <= (2e-2 if bf16 else 5e-5) * b.abs().max(), name
    assert (got[0][16:32] == 0).all() and (got[0][[40, 41, 69]] == 0).all()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("fe", [0, 1, 3])
def test_edge_block_fwd_at_tile_boundaries(cuda, bf16, fe):
    # the geometry above; the forward's outputs come from torch.empty, so
    # every row, empty or not, must be written by the kernel; no atomics, so
    # two calls agree bit for bit
    _, (ud, us, x, rowptr, src, _, ea, wpack) = _ragged_edge_block_inputs(cuda, bf16, fe)
    _check_blockings(rowptr)
    args = (ud, us, x, rowptr, src, ea, wpack, bf16)
    before = ek.FWD_LAUNCHES
    got = ek.edge_block_fwd(*args)
    again = ek.edge_block_fwd(*args)
    torch.cuda.synchronize()
    assert ek.FWD_LAUNCHES == before + 2
    want = ek.edge_block_fwd_plain(*args)
    empty = [*range(16, 32), 40, 41, 69]
    for name, a, b, c in zip(("m_sum", "t_sum"), got, want, again):
        assert bool(torch.isfinite(a).all()), name
        assert (a - b).abs().max() <= (2e-2 if bf16 else 1e-5) * b.abs().max(), name
        assert (a[empty] == 0).all(), name
        assert torch.equal(a, c), name


@pytest.mark.parametrize("form", ["dst", "src"])
@pytest.mark.parametrize("f,bf16", [(1, False), (67, False), (131, False), (1, True),
                                    (67, True), (131, True)])
def test_segment_sum_long_rows_and_wide_features(cuda, form, f, bf16):
    # a 300-edge row, empty rows, F of 1, 67 (the variant path) and 131 (two
    # passes), odd bf16 rows; the sums are deterministic
    rng = np.random.default_rng(f)
    n = 50
    deg, rowptr = _ragged_csr(rng, n, 7, 300, [*range(10, 15), 49])
    e = int(rowptr[-1])
    data = torch.tensor(rng.normal(size=(e + 5, f)).astype(np.float32), device=cuda)
    data[e:] = 1e6   # rows past rowptr[N] are never read
    if bf16:
        data = data.bfloat16()
    perm = None
    if form == "src":   # rows read through the stable argsort of a src array
        src = rng.permutation(np.repeat(np.arange(n), deg))
        perm = torch.tensor(np.argsort(src, kind="stable").astype(np.int32), device=cuda)
    rp = torch.tensor(rowptr, device=cuda)
    got = spmm.segment_sum_csr(data, rp, perm)
    again = spmm.segment_sum_csr(data, rp, perm)
    torch.cuda.synchronize()
    want = spmm.segment_sum_csr_plain(data, rp, perm)
    assert got.dtype == torch.float32 and got.shape == (n, f)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(got, again)
    assert (got[10:15] == 0).all() and (got[49] == 0).all()


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


def _cli_run(cuda, tmp_path, *more):
    """A tiny Water-3D CLI run on the card: the CLI's parser and
    ``run_training``, on in-memory datasets (a GPU machine need not
    have h5py).  5 samples per split, batch 2: 2 train steps and 2 + 2
    eval batches per epoch."""
    from fastegnn_tpu_torch.cli.common import run_training
    from fastegnn_tpu_torch.cli.simulation import build_parser
    from fastegnn_tpu_torch.data.simulation import SimulationDataset, synthetic_trajectories

    trajectories = synthetic_trajectories(1, 60, 40, seed=0)
    sets = [SimulationDataset.from_trajectories(trajectories[s], s, device=cuda,
                                                max_samples=5, radius=0.15, seed=43)
            for s in ("train", "valid", "test")]
    args = build_parser().parse_args([
        "--data_directory", str(tmp_path), "--virtual_channel", "3", "--batch_size", "2",
        "--num_layer", "2", "--max_epochs", "2", "--test_interval", "1",
        "--ckpt_directory", str(tmp_path / "ck"), "--log_directory", str(tmp_path / "logs"),
        *more])
    return run_training(args, *sets, per_graph_sampling=True, gravity=(0.0, -1.0, 0.0))


def test_cli_run_on_the_card_launches_the_f32_edge_kernels(cuda, tmp_path):
    before = (ek.FWD_LAUNCHES, ek.BWD_LAUNCHES, spmm.SEGSUM_LAUNCHES)
    run = _cli_run(cuda, tmp_path)
    torch.cuda.synchronize()
    after = (ek.FWD_LAUNCHES, ek.BWD_LAUNCHES, spmm.SEGSUM_LAUNCHES)
    # 2 layers x (2 train steps + 4 eval batches) forward, 2 x 2 backward, per epoch
    assert tuple(a - b for a, b in zip(after, before)) == (2 * 2 * 6, 2 * 2 * 2, 0)
    assert run.step == 4 and np.isfinite(run.log["loss_train"] + run.log["loss"]).all()
    assert run.log["telemetry"][-1]["peak_device_gib"] > 0


def test_checkpoint_written_on_the_card_restores_on_the_cpu(cuda, tmp_path):
    from fastegnn_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    run = _cli_run(cuda, tmp_path)
    path = str(tmp_path / "last")
    save_checkpoint(path, {"model": run.model.state_dict(),
                           "optimizer": run.optimizer.state_dict(), "step": run.step,
                           "epoch": 2})
    ck = restore_checkpoint(path, map_location="cpu")
    cpu = FastEGNN(2, 2, hidden=64, n_layers=2, gravity=(0.0, -1.0, 0.0), device="cpu")
    cpu.load_state_dict(ck["model"])
    for k, v in run.model.state_dict().items():
        assert ck["model"][k].device.type == "cpu" and torch.equal(ck["model"][k], v.cpu()), k
    opt = torch.optim.Adam(cpu.parameters())
    opt.load_state_dict(ck["optimizer"])
    best = restore_checkpoint(str(tmp_path / "ck" / "best"), map_location="cpu")
    cpu.load_state_dict(best["model"])
    assert best["step"] in (2, 4) and best["epoch"] in (1, 2)
