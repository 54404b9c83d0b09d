"""Sorted-CSR segment-sum: CUDA kernel, plain version, autograd ops
(counterpart of ``fastegnn_tpu/ops/spmm.py``).

Replaces the Pallas TPU kernel ``fastegnn_tpu/ops/spmm.py::
_segment_sum_kernel``.  :func:`segment_sum_csr` sums the rows of ``data``
over each row range of a CSR row pointer, optionally reading them through a
permutation; the kernel (``csrc/segment_sum.cu``; design and bound in its
header) takes f32 or bf16 data and always accumulates and returns f32.

The public ops keep the JAX package's names:

- :func:`sorted_segment_sum_csr` with a precomputed ``rowptr`` (the
  production path) and :func:`sorted_segment_sum`, which builds ``rowptr``
  on the device; both are differentiable in ``data`` (the backward is a
  masked row gather);
- :func:`gather_dst` / :func:`gather_src`: ``h[dst]`` / ``h[src]`` whose
  backward is the kernel, over the dst CSR or over the src-sorted CSR
  reading rows through ``src_perm``.  The gathers themselves are
  ``index_select``, as the JAX package's ``jnp.take`` lies outside Pallas.

The JAX package's ``CSRMeta`` block tables are not ported: the batch's
``rowptr`` / ``src_rowptr`` (``graph.py``) take their place.

On a CPU tensor :func:`segment_sum_csr` runs :func:`segment_sum_csr_plain`;
on a CUDA tensor it launches the kernel or raises.  ``SEGSUM_LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

SEGSUM_LAUNCHES = 0


def segment_sum_csr_plain(data: torch.Tensor, rowptr: torch.Tensor,
                          perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``[N, F]`` f32 with
    ``out[r] = sum(data[perm[p] if perm else p] for p in rowptr[r]:rowptr[r+1])``."""
    n = rowptr.shape[0] - 1
    lo, hi = int(rowptr[0]), int(rowptr[-1])
    rows = data[perm[lo:hi].long()] if perm is not None else data[lo:hi]
    ids = torch.repeat_interleave(torch.arange(n, device=data.device),
                                  (rowptr[1:] - rowptr[:-1]).long(), output_size=hi - lo)
    out = torch.zeros((n, data.shape[1]), dtype=torch.float32, device=data.device)
    return out.index_add_(0, ids, rows.float())


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    from fastegnn_tpu_torch.ops import _cuda_build

    lib = _cuda_build.load("segment_sum")
    if lib.fastegnn_segment_sum.argtypes is None:
        lib.fastegnn_segment_sum.argtypes = [_I, _P, _P, _P, _P, _I, _I, _P]
        lib.fastegnn_segment_sum.restype = _I
    return lib


def segment_sum_csr(data: torch.Tensor, rowptr: torch.Tensor,
                    perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row sums over a CSR row pointer: ``[N, F]`` f32 for ``data``
    ``[E, F]`` (f32 or bf16), ``rowptr`` ``[N + 1]`` int32 and optional
    ``perm`` int32 (rows are read as ``data[perm[p]]``).

    CPU tensors run :func:`segment_sum_csr_plain`; CUDA tensors launch the
    kernel (``csrc/segment_sum.cu``) or raise.  The kernel trusts the
    indices: ``rowptr`` must be non-decreasing and every row it reads must
    lie in ``data``."""
    global SEGSUM_LAUNCHES
    if data.device.type == "cpu":
        return segment_sum_csr_plain(data, rowptr, perm)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if data.dim() != 2 or data.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"data must be a 2-D f32 or bf16 tensor, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if data.shape[1] == 0:
        raise ValueError("data must have at least one feature")
    for name, t in (("data", data), ("rowptr", rowptr), ("perm", perm)):
        if t is None:
            continue
        if t.device != data.device:
            raise ValueError(f"{name} is on {t.device}, expected {data.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "data" and (t.dtype != torch.int32 or t.dim() != 1):
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    if rowptr.shape[0] < 1:
        raise ValueError("rowptr needs at least one entry")
    n, f = rowptr.shape[0] - 1, data.shape[1]
    out = torch.empty((n, f), dtype=torch.float32, device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = _lib().fastegnn_segment_sum(
        int(data.dtype == torch.bfloat16), data.data_ptr(), rowptr.data_ptr(),
        None if perm is None else perm.data_ptr(), out.data_ptr(), n, f, stream)
    if err != 0:
        raise RuntimeError(f"CUDA segment-sum kernel launch failed: cudaError {err}")
    SEGSUM_LAUNCHES += 1
    return out


def _take(h: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``h[ids]`` with ids clipped to ``[0, N)`` (``jnp.take(mode="clip")``)."""
    return h.index_select(0, ids.long().clamp(0, max(h.shape[0] - 1, 0)))


def _masked_gather(g: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``g[ids]`` with the rows of out-of-range ids zeroed (the JAX
    backward's clipped take times its validity mask)."""
    valid = (ids >= 0) & (ids < g.shape[0])
    rows = _take(g, ids)
    return rows * valid[:, None].to(rows.dtype)


class _SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, dst, rowptr):
        ctx.save_for_backward(dst)
        ctx.dtype = data.dtype
        return segment_sum_csr(data.contiguous(), rowptr)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        return _masked_gather(g, dst).to(ctx.dtype), None, None


def sorted_segment_sum_csr(data: torch.Tensor, dst: torch.Tensor, rowptr: torch.Tensor,
                           num_segments: int) -> torch.Tensor:
    """``[num_segments, F]`` f32 segment-sum of dst-sorted ``data`` [E, F]
    (f32 or bf16) with the precomputed ``rowptr`` ``[num_segments + 1]``
    int32 of ``dst``.  Differentiable in ``data``: the backward is the
    gather ``g[dst]``, zero where ``dst`` is out of range."""
    if rowptr.shape[0] != num_segments + 1:
        raise ValueError(f"rowptr has {rowptr.shape[0]} entries for "
                         f"{num_segments} segments")
    return _SortedSegmentSum.apply(data, dst, rowptr)


def sorted_segment_sum(data: torch.Tensor, dst: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Segment-sum over non-decreasing ``dst`` [E] int32, building the row
    pointer on the device (``torch.searchsorted``, no host sync).  Ids
    outside ``[0, num_segments)`` sort to the ends and fall outside every
    row range, so they are dropped.  Returns ``[num_segments, F]`` f32."""
    bounds = torch.arange(num_segments + 1, dtype=dst.dtype, device=dst.device)
    rowptr = torch.searchsorted(dst, bounds, out_int32=True)
    return sorted_segment_sum_csr(data, dst, rowptr, num_segments)


class _GatherDst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, dst, rowptr):
        ctx.save_for_backward(rowptr)
        ctx.dtype = h.dtype
        return _take(h, dst)

    @staticmethod
    def backward(ctx, g):
        (rowptr,) = ctx.saved_tensors
        return segment_sum_csr(g.contiguous(), rowptr).to(ctx.dtype), None, None


class _GatherSrc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, src, src_perm, src_rowptr):
        ctx.save_for_backward(src_perm, src_rowptr)
        ctx.dtype = h.dtype
        return _take(h, src)

    @staticmethod
    def backward(ctx, g):
        src_perm, src_rowptr = ctx.saved_tensors
        dh = segment_sum_csr(g.contiguous(), src_rowptr, src_perm)
        return dh.to(ctx.dtype), None, None, None


def gather_dst(h: torch.Tensor, dst: torch.Tensor, rowptr: torch.Tensor) -> torch.Tensor:
    """``h[dst]`` (ids clipped to ``[0, N)``) for dst-sorted ``dst`` [E];
    the backward sums the rows per node with the kernel over ``rowptr``
    ``[N + 1]``, so edges past ``rowptr[N]`` get no gradient."""
    return _GatherDst.apply(h, dst, rowptr)


def gather_src(h: torch.Tensor, src: torch.Tensor, src_perm: torch.Tensor,
               src_rowptr: torch.Tensor) -> torch.Tensor:
    """``h[src]`` (ids clipped to ``[0, N)``); the backward sums the rows per
    node with the kernel over the src-sorted CSR: ``src_perm`` [E] int32 is
    the stable argsort of ``src`` and ``src_rowptr`` ``[N + 1]`` its row
    pointer."""
    return _GatherSrc.apply(h, src, src_perm, src_rowptr)
