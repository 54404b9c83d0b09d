"""``edge_bwd_kernel`` (f32) against its roofline; see ``_edge.py``."""

from benchmark.metrics._edge import roofline


def read(ctx):
    return roofline(ctx, "bwd", "edge_bwd_kernel")
