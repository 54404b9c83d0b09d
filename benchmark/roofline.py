"""Peaks of one NVIDIA H100 SXM and the least time of the port's own
kernels, from their shapes.

Frozen copies of ``chip_smoke.py``'s ``PEAK_*``, ``bound`` and
``segsum_bound`` (the edge block's operations and bytes; the segment-sum's
bytes against one f32 add per input value), so that a change to the
program cannot change the yardstick.
"""

from __future__ import annotations

# published H100 SXM peaks (NVIDIA data sheet, dense), at the 700 W limit
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
HIDDEN = 64


def edge_bound_s(kind: str, bf16: bool, n: int, e: int, fe: int) -> float:
    """Least seconds of one edge-block launch (``kind`` ``"fwd"`` or
    ``"bwd"``) over ``n`` node rows and ``e`` real edges with ``fe`` edge
    attributes: each input byte read once and each output byte written
    once over the memory rate, against the chain products' operations over
    the compute type's peak."""
    H = HIDDEN
    tab = 2 if bf16 else 4
    ins = 2 * n * H * tab + n * 12 + (n + 1) * 4 + e * 4 + e * fe * 4 + 136 * H * 4
    if kind == "fwd":
        nbytes = ins + n * H * 4 + n * 12
        ops = e * (2 * 2 * H * H + 2 * H * fe)
    else:
        nbytes = ins + e * 4 + n * H * 4 + n * 12 + 2 * n * H * 4 + 2 * n * 12 + 136 * H * 4
        ops = e * (6 * 2 * H * H + 2 * 2 * H * fe)
    return max(nbytes / PEAK_BYTES, ops / PEAK_OPS["bfloat16" if bf16 else "float32"])


def segsum_bound_s(e: int, n: int, f: int, elt: int, perm: bool) -> float:
    """Least seconds of one segment-sum launch: the ``e x f`` data rows of
    ``elt`` bytes, the row pointer (and the permutation) read once and the
    f32 output written once, against one f32 add per input value."""
    nbytes = e * f * elt + (n + 1) * 4 + n * f * 4 + (e * 4 if perm else 0)
    return max(nbytes / PEAK_BYTES, e * f / PEAK_OPS["float32"])
