"""Masked segment reductions (counterpart of ``fastegnn_tpu/ops/segment.py``).

Sums go through ``index_add_``.  As in XLA's segment ops, ids outside
``[0, num_segments)`` are dropped: they are routed to one extra bucket that
is cut off, so no host synchronisation is needed.  Means divide by masked
counts clamped to >= 1, so empty segments give 0.

:func:`segment_softmax` is the exception: it runs over the real edges of a
batch, whose sums go through the segment-sum kernel (``ops/spmm.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from fastegnn_tpu_torch.ops.spmm import gather_through, segment_sum_through


def _mask_rows(data: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return data
    shape = mask.shape + (1,) * (data.dim() - mask.dim())
    return data * mask.reshape(shape).to(data.dtype)


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum of ``data`` rows into ``num_segments`` buckets; masked rows and
    out-of-range ids add nothing."""
    ids = segment_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids,
                      torch.full_like(ids, num_segments))
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, ids, _mask_rows(data, mask))
    return out[:num_segments]


def segment_count(
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    ones = (mask.to(torch.float32) if mask is not None
            else torch.ones(segment_ids.shape, device=segment_ids.device))
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment mean with the count clamped to >= 1."""
    total = segment_sum(data, segment_ids, num_segments, mask)
    count = segment_count(segment_ids, num_segments, mask).clamp_min(1.0)
    return total / count.reshape(count.shape + (1,) * (total.dim() - 1)).to(total.dtype)


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    perm: torch.Tensor,
    rowptr: torch.Tensor,
    num_segments: int,
) -> torch.Tensor:
    """Numerically stable softmax of f32 ``logits`` [E, ...] over the rows of
    each segment (DGL's ``edge_softmax``; the JAX function over rows that
    are all real, so no mask).  ``perm`` int32 is the stable argsort of
    ``segment_ids`` [E] and ``rowptr`` [num_segments + 1] its row pointer,
    as ``ops/spmm.py::segment_sum_through`` takes them (``graph.src_perm``
    and ``graph.src_rowptr`` for the real edges at src).

    Each row is shifted by its segment's max (``scatter_reduce``, outside
    autograd: the softmax does not depend on the shift; a segment without
    rows keeps max 0, the JAX ``isfinite`` rule), exponentiated, and divided
    by its segment's sum, clamped at ``finfo.tiny``.  The sum and the
    backward of its gather back to the rows run on the segment-sum kernel."""
    shape = logits.shape
    x = logits.reshape(shape[0], -1)
    ids = segment_ids.long()
    with torch.no_grad():
        top = x.new_zeros((num_segments, x.shape[1])).scatter_reduce_(
            0, ids[:, None].expand_as(x), x, "amax", include_self=False)
    expd = torch.exp(x - top.index_select(0, ids))
    denom = segment_sum_through(expd, segment_ids, perm, rowptr, num_segments)
    denom = denom.clamp_min(torch.finfo(x.dtype).tiny)
    return (expd / gather_through(denom, segment_ids, perm, rowptr)).reshape(shape)


def graph_sum_pool(
    data: torch.Tensor,
    graph_id: torch.Tensor,
    n_graphs: int,
    node_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-graph sum over nodes -> ``[B, ...]``.  Padded nodes carry the
    dump id ``n_graphs``: its segment is computed, then dropped."""
    return segment_sum(data, graph_id, n_graphs + 1, node_mask)[:n_graphs]


def graph_mean_pool(
    data: torch.Tensor,
    graph_id: torch.Tensor,
    n_graphs: int,
    node_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-graph mean over real nodes -> ``[B, ...]``.  Padded nodes carry
    the dump id ``n_graphs`` and are dropped."""
    return segment_mean(data, graph_id, n_graphs, node_mask)
