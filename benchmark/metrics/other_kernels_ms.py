"""Device ms per step in kernels other than the port's own (the edge
block's and the segment-sum's), summed over the profiled window's kernel
events by name and divided by its steps: what the model's PyTorch ops
cost on the card."""

OWN = ("edge_fwd_kernel", "edge_bwd_kernel", "edge_fwd_tc_kernel", "edge_bwd_tc_kernel",
       "segment_sum_kernel")


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["steps"]:
        return None
    us = sum(dur for name, _, dur in tr["trace"].kernels if not any(o in name for o in OWN))
    return us / 1e3 / tr["steps"]
