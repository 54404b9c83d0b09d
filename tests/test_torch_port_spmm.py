"""The port's segment-sum surface (``fastegnn_tpu_torch/ops/spmm.py``)
against ``fastegnn_tpu.ops.spmm``, whose Pallas kernel runs in interpret
mode on the CPU.  On CPU tensors the port runs the kernel's plain version.

Tolerances: f32 atol 1e-4 / rtol 1e-5, as in ``tests/test_spmm.py``; both
sides sum in f32, in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastegnn_tpu.ops import spmm as jspmm
from fastegnn_tpu_torch.ops import spmm

TOL = dict(atol=1e-4, rtol=1e-5)


def _sorted_ids(rng, e, n):
    return np.sort(rng.integers(0, n, e)).astype(np.int32)


def _rowptr(sorted_ids, n):
    return np.searchsorted(sorted_ids, np.arange(n + 1), side="left").astype(np.int32)


@pytest.mark.parametrize("E,N,H", [(1000, 64, 8), (4096, 300, 64), (513, 40, 3)])
def test_sorted_segment_sum_matches_jax(E, N, H):
    rng = np.random.default_rng(0)
    dst = _sorted_ids(rng, E, N)
    data = rng.normal(size=(E, H)).astype(np.float32)
    want = jspmm.sorted_segment_sum(jnp.asarray(data), jnp.asarray(dst), N, rows=32, chunk=256)
    got = spmm.sorted_segment_sum(torch.tensor(data), torch.tensor(dst), N)
    assert got.dtype == torch.float32 and got.shape == (N, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the precomputed-rowptr form gives the same sums
    csr = spmm.sorted_segment_sum_csr(torch.tensor(data), torch.tensor(dst),
                                      torch.tensor(_rowptr(dst, N)), N)
    np.testing.assert_array_equal(csr.numpy(), got.numpy())


def test_out_of_range_ids_dropped():
    rng = np.random.default_rng(1)
    E, N, H = 600, 50, 4
    dst = _sorted_ids(rng, E, N)
    dst[-100:] = N + 7     # padded sentinel tail, still sorted
    dst[:20] = -1          # negative head
    data = rng.normal(size=(E, H)).astype(np.float32)
    want = np.zeros((N, H), np.float32)
    for e in range(20, E - 100):
        want[dst[e]] += data[e]
    got = spmm.sorted_segment_sum(torch.tensor(data), torch.tensor(dst), N)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    jtail = jspmm.sorted_segment_sum(jnp.asarray(data[20:]), jnp.asarray(dst[20:]), N,
                                     rows=16, chunk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(jtail), **TOL)


def test_empty_rows_zero():
    dst = np.array([5, 5, 9], np.int32)
    data = torch.ones((3, 2))
    got = spmm.sorted_segment_sum(data, torch.tensor(dst), 12).numpy()
    assert got[5].tolist() == [2.0, 2.0] and got[9].tolist() == [1.0, 1.0]
    assert np.abs(got).sum() == 3 * 2
    want = jspmm.sorted_segment_sum(jnp.ones((3, 2)), jnp.asarray(dst), 12, rows=8, chunk=128)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_bf16_data_sums_in_f32_like_the_csr_kernel():
    rng = np.random.default_rng(2)
    E, N, H = 2048, 100, 67
    dst = _sorted_ids(rng, E, N)
    data = rng.normal(size=(E, H)).astype(np.float32)
    meta = jspmm.make_csr_meta(dst, N, rows=32, chunk=256)
    want = jspmm.sorted_segment_sum_csr(jnp.asarray(data, jnp.bfloat16), jnp.asarray(dst),
                                        meta, N)
    assert want.dtype == jnp.float32
    got = spmm.sorted_segment_sum_csr(torch.tensor(data).bfloat16(), torch.tensor(dst),
                                      torch.tensor(_rowptr(dst, N)), N)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def edges():
    """300 dst-sorted edges over 40 nodes, 7 features, and both CSR forms."""
    rng = np.random.default_rng(3)
    E, N, F = 300, 40, 7
    dst = _sorted_ids(rng, E, N)
    src = rng.integers(0, N, E).astype(np.int32)
    perm = np.argsort(src, kind="stable").astype(np.int32)
    return dict(
        N=N, dst=dst, src=src, perm=perm, src_sorted=src[perm],
        rowptr=_rowptr(dst, N), src_rowptr=_rowptr(src[perm], N),
        data=rng.normal(size=(E, F)).astype(np.float32),
        h=rng.normal(size=(N, F)).astype(np.float32),
        w_edge=rng.normal(size=(E, F)).astype(np.float32),
        w_node=rng.normal(size=(N, F)).astype(np.float32))


def _port_grad(fn, x, w):
    x = torch.tensor(x, requires_grad=True)
    (fn(x) * torch.tensor(w)).sum().backward()
    return x.grad.numpy()


def test_segment_sum_gradient_matches_jax(edges):
    k = edges
    meta = jspmm.make_csr_meta(k["dst"], k["N"], rows=16, chunk=128)
    want = jax.grad(lambda d: (jspmm.sorted_segment_sum_csr(
        d, jnp.asarray(k["dst"]), meta, k["N"]) * k["w_node"]).sum())(jnp.asarray(k["data"]))
    got = _port_grad(lambda d: spmm.sorted_segment_sum_csr(
        d, torch.tensor(k["dst"]), torch.tensor(k["rowptr"]), k["N"]), k["data"], k["w_node"])
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_gather_dst_gradient_matches_jax(edges):
    k = edges
    dst = k["dst"].copy()
    dst[-30:] = k["N"]     # sentinel tail: clipped in the forward, no gradient
    rowptr = _rowptr(dst, k["N"])
    meta = jspmm.make_csr_meta(dst, k["N"], rows=16, chunk=128)
    fj = lambda h: jspmm.gather_dst(h, jnp.asarray(dst), meta)  # noqa: E731
    fp = lambda h: spmm.gather_dst(h, torch.tensor(dst), torch.tensor(rowptr))  # noqa: E731
    np.testing.assert_array_equal(fp(torch.tensor(k["h"])).numpy(),
                                  np.asarray(fj(jnp.asarray(k["h"]))))
    want = jax.grad(lambda h: (fj(h) * k["w_edge"]).sum())(jnp.asarray(k["h"]))
    got = _port_grad(fp, k["h"], k["w_edge"])
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_gather_src_gradient_matches_jax(edges):
    k = edges
    meta = jspmm.make_csr_meta(k["src_sorted"], k["N"], rows=16, chunk=128)
    fj = lambda h: jspmm.gather_src(h, jnp.asarray(k["src"]), jnp.asarray(k["perm"]),  # noqa: E731
                                    jnp.asarray(k["src_sorted"]), meta)
    fp = lambda h: spmm.gather_src(h, torch.tensor(k["src"]), torch.tensor(k["perm"]),  # noqa: E731
                                   torch.tensor(k["src_rowptr"]))
    np.testing.assert_array_equal(fp(torch.tensor(k["h"])).numpy(),
                                  np.asarray(fj(jnp.asarray(k["h"]))))
    want = jax.grad(lambda h: (fj(h) * k["w_edge"]).sum())(jnp.asarray(k["h"]))
    got = _port_grad(fp, k["h"], k["w_edge"])
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_wrapper_routes(edges):
    k = edges
    data, rowptr = torch.tensor(k["data"]), torch.tensor(k["rowptr"])
    before = spmm.SEGSUM_LAUNCHES
    got = spmm.segment_sum_csr(data, rowptr)
    assert spmm.SEGSUM_LAUNCHES == before   # CPU tensors run the plain version
    torch.testing.assert_close(got, spmm.segment_sum_csr_plain(data, rowptr))
    with pytest.raises(ValueError, match="unsupported device"):
        spmm.segment_sum_csr(data.to("meta"), rowptr.to("meta"))
    assert spmm.SEGSUM_LAUNCHES == before
