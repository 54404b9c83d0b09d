"""The port's fused edge block (plain versions and autograd) against the JAX
op ``fused_edge_block_v5`` (Pallas interpret mode on the CPU) and the
unfused oracle ``helpers._ref_edge_block``, on ``helpers._setup`` geometry.

On the CPU the wrappers run the plain versions; the CUDA kernels are held
against those same plain versions on the card (``tests/test_torch_port_cuda.py``
and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastegnn_tpu.ops.edge_kernel_v5 import fused_edge_block_v5, make_v5_meta
from fastegnn_tpu_torch.ops import edge_kernel as ek

from helpers import _ref_edge_block, _setup

H = 64


def _torch_case(seed=0):
    h, x, dst, src, ea, w = _setup(seed=seed)
    n = h.shape[0]
    rowptr = np.searchsorted(dst, np.arange(n + 1)).astype(np.int32)
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    graph = (t(rowptr), t(src), t(dst), t(ea))
    return (h, x, dst, src, ea, w), t(h), t(x), [t(a) for a in w], graph


def _port(th, tx, tw, graph, cd=torch.float32):
    rowptr, src, dst, ea = graph
    return ek.fused_edge_block(th, tx, rowptr, src, dst, ea, *tw, compute_dtype=cd)


def _jax_meta(h, dst, src, ea):
    return make_v5_meta(dst, src, ea, np.ones(dst.size, bool), h.shape[0],
                        chunk=256, W=2, G=2)


def test_forward_matches_jax_and_oracle():
    (h, x, dst, src, ea, w), th, tx, tw, graph = _torch_case()
    ms, ts = (np.asarray(a) for a in fused_edge_block_v5(h, x, _jax_meta(h, dst, src, ea), *w))
    ms_r, ts_r = (np.asarray(a) for a in _ref_edge_block(
        h, x, jnp.asarray(dst), jnp.asarray(src), jnp.asarray(ea), *w))
    pm, pt = (a.numpy() for a in _port(th, tx, tw, graph))
    for want_m, want_t in ((ms, ts), (ms_r, ts_r)):
        np.testing.assert_allclose(pm, want_m, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(pt, want_t, rtol=2e-5, atol=2e-5)


def test_gradients_of_all_nine_inputs_match_jax():
    (h, x, dst, src, ea, w), th, tx, tw, graph = _torch_case()
    meta = _jax_meta(h, dst, src, ea)
    rng = np.random.default_rng(1)
    cot_m = rng.normal(size=(h.shape[0], H)).astype(np.float32)
    cot_t = rng.normal(size=(h.shape[0], 3)).astype(np.float32)

    def loss_k(h, x, *w):
        ms, ts = fused_edge_block_v5(h, x, meta, *w)
        return jnp.sum(ms * cot_m) + jnp.sum(ts * cot_t)

    gk = jax.grad(loss_k, argnums=tuple(range(9)))(h, x, *w)
    ins = [a.clone().requires_grad_(True) for a in [th, tx, *tw]]
    pm, pt = _port(ins[0], ins[1], ins[2:], graph)
    ((pm * torch.tensor(cot_m)).sum() + (pt * torch.tensor(cot_t)).sum()).backward()
    for a, b in zip(ins, gk):
        b = np.asarray(b)
        scale = float(np.abs(b).max()) + 1e-9
        np.testing.assert_allclose(a.grad.numpy() / scale, b / scale, atol=3e-5)


def test_bwd_plain_matches_autograd_of_fwd_plain():
    _, th, tx, tw, (rowptr, src, dst, ea) = _torch_case(seed=3)
    W1, b1, W2, b2, Wg1, bg1, wg2 = tw
    ud, us = ek.build_tables(th, W1, b1, False)
    wpack = ek.pack_weights(W1, W2, b2, Wg1, bg1, wg2, False)
    gen = torch.Generator().manual_seed(0)
    dms = torch.randn(th.shape[0], H, generator=gen)
    dts = torch.randn(th.shape[0], 3, generator=gen)
    leaves = [a.clone().requires_grad_(True) for a in (ud, us, tx, wpack)]
    m, t = ek.edge_block_fwd_plain(leaves[0], leaves[1], leaves[2], rowptr, src, ea,
                                   leaves[3], False)
    ((m * dms).sum() + (t * dts).sum()).backward()
    dud, dus, dx, dw = ek.edge_block_bwd_plain(ud, us, tx, rowptr, src, dst, ea, wpack,
                                               dms, dts, False)
    for got, leaf in zip((dud, dus, dx), leaves[:3]):
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), rtol=1e-5, atol=1e-5)
    fe = ea.shape[1]
    rows = [*range(ek.ROW_W1E + fe), ek.ROW_W1R, ek.ROW_WG2, ek.ROW_B2, ek.ROW_BG1]
    want = leaves[3].grad.numpy()[rows]
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(dw.numpy()[rows] / scale, want / scale, atol=1e-6)


def test_bf16_mode_close_to_f32_reference():
    (h, x, dst, src, ea, w), th, tx, tw, graph = _torch_case()
    ms_r, ts_r = (np.asarray(a) for a in _ref_edge_block(
        h, x, jnp.asarray(dst), jnp.asarray(src), jnp.asarray(ea), *w))
    ins = [a.clone().requires_grad_(True) for a in [th, tx]]
    pm, pt = _port(ins[0], ins[1], tw, graph, torch.bfloat16)
    assert np.abs(pm.detach().numpy() - ms_r).max() < 2e-2 * np.abs(ms_r).max()
    assert np.abs(pt.detach().numpy() - ts_r).max() < 2e-2 * np.abs(ts_r).max()
    (pm.sum() * 0.01 + pt.sum() * 0.01).backward()
    g32 = jax.grad(lambda h, x: sum(jnp.sum(o * 0.01) for o in _ref_edge_block(
        h, x, jnp.asarray(dst), jnp.asarray(src), jnp.asarray(ea), *w)), argnums=(0, 1))(h, x)
    for a, b in zip(ins, g32):
        b = np.asarray(b)
        assert np.isfinite(a.grad.numpy()).all()
        assert np.abs(a.grad.numpy() - b).max() < 3e-2 * np.abs(b).max()


def test_bf16_chain_product_operands_are_bf16_values():
    # the bf16 backward kernel runs the six 64x64 products (and the dUd /
    # dW1 sums) on the tensor cores with bf16 operands; that is exact only
    # while every operand the plain version multiplies is already a bf16 value
    _, th, tx, tw, (rowptr, src, dst, ea) = _torch_case(seed=2)
    W1, b1, W2, b2, Wg1, bg1, wg2 = tw
    ud, us = ek.build_tables(th, W1, b1, True)
    wpack = ek.pack_weights(W1, W2, b2, Wg1, bg1, wg2, True)
    gen = torch.Generator().manual_seed(0)
    n = th.shape[0]
    dms = ek._rnd(torch.randn(n, H, generator=gen), True)
    dts = ek._rnd(torch.randn(n, 3, generator=gen), True)
    d, s = dst.long(), src.long()
    c = ek.chain_bwd(ud, us, tx, d, s, ea, wpack, dms[d], dts[d], True)
    operands = dict(a1=c["a1"], m=c["m"], d_zg_c=c["d_zg_c"], d_z2_c=c["d_z2_c"],
                    W2=wpack[ek.ROW_W2:ek.ROW_W2 + H], Wg1=wpack[ek.ROW_WG1:ek.ROW_WG1 + H],
                    # and those of the dUd / dW1 radial and edge-attr sums
                    d_z1_c=c["d_z1_c"], ea_r=c["ea_r"], radial=ek._rnd(c["radial"], True))
    for name, t in operands.items():
        assert t.dtype == torch.float32 and t.abs().max() > 0, name
        assert torch.equal(t, t.bfloat16().float()), name
    # the unrounded deltas feed db2, dbg1 and d_radial: not bf16 values
    assert not torch.equal(c["d_z2"], c["d_z2_c"])
    assert not torch.equal(c["d_zg"], c["d_zg_c"])
    assert not torch.equal(c["d_z1"], c["d_z1_c"])


def test_isolated_rows_are_zero_and_padding_is_never_read():
    # rows past the last dst get no edges; the edge arrays carry a padded
    # tail (src 0, sentinel dst) beyond rowptr[N] that must not contribute
    h, x, dst, src, ea, w = _setup(isolate_tail=True)
    n = h.shape[0]
    pad = 37
    dst_p = np.concatenate([dst, np.full(pad, n, np.int32)])
    src_p = np.concatenate([src, np.zeros(pad, np.int32)])
    ea_p = np.concatenate([ea, np.full((pad, ea.shape[1]), 9.0, np.float32)])
    rowptr = np.searchsorted(dst_p, np.arange(n + 1)).astype(np.int32)
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    th = t(h).requires_grad_(True)
    pm, pt = ek.fused_edge_block(th, t(x), t(rowptr), t(src_p), t(dst_p), t(ea_p),
                                 *[t(a) for a in w])
    lo = (n - 1) // 128 * 128
    assert (pm[lo:] == 0).all() and (pt[lo:] == 0).all()
    ms_r, _ = _ref_edge_block(h, x, jnp.asarray(dst), jnp.asarray(src), jnp.asarray(ea), *w)
    np.testing.assert_allclose(pm.detach().numpy(), np.asarray(ms_r), rtol=2e-5, atol=2e-5)
    pm.sum().backward()
    assert np.isfinite(th.grad.numpy()).all()


def test_wrappers_reject_devices_without_a_kernel():
    # a tensor that is neither on the CPU (plain version) nor on CUDA
    # (kernel) raises instead of falling back
    _, th, tx, tw, (rowptr, src, dst, ea) = _torch_case()
    ud, us = ek.build_tables(th, tw[0], tw[1], False)
    wpack = ek.pack_weights(tw[0], *tw[2:], False)
    meta = [a.to("meta") for a in (ud, us, tx, rowptr, src, ea, wpack)]
    with pytest.raises(ValueError):
        ek.edge_block_fwd(*meta, False)
    with pytest.raises(ValueError, match="hidden"):
        ek.fused_edge_block(th[:, :32], tx, rowptr, src, dst, ea, *tw)
