"""Masked segment reductions (counterpart of ``fastegnn_tpu/ops/segment.py``).

Sums go through ``index_add_``.  As in XLA's segment ops, ids outside
``[0, num_segments)`` are dropped: they are routed to one extra bucket that
is cut off, so no host synchronisation is needed.  Means divide by masked
counts clamped to >= 1, so empty segments give 0.
"""

from __future__ import annotations

from typing import Optional

import torch


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


def graph_mean_pool(
    data: torch.Tensor,
    graph_id: torch.Tensor,
    n_graphs: int,
    node_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-graph mean over real nodes -> ``[B, ...]``.  Padded nodes carry
    the dump id ``n_graphs`` and are dropped."""
    return segment_mean(data, graph_id, n_graphs, node_mask)
