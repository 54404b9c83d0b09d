"""The fused edge block's share of its roofline over the profiled window:
the mean least time of one launch, from each profiled step's batch shape
(``roofline.edge_bound_s``; ``n_layers`` launches a step each way), over
the mean profiled time of one launch of the kernel, in %.  None where the
window holds no launch of it."""

from benchmark.roofline import edge_bound_s


def roofline(ctx, kind: str, kernel: str):
    tr = ctx["trace"]
    ek = ctx["cfg"].get("edge_kernels")
    if tr is None or not ek:
        return None
    durs = [dur for name, _, dur in tr["trace"].kernels if kernel in name]
    if not durs:
        return None
    bounds = [edge_bound_s(kind, ek["bf16"], n_rows, e, ek["fe"])
              for _, _, e, n_rows in tr["shapes"]]
    return 100.0 * (sum(bounds) / len(bounds)) / (sum(durs) / len(durs) / 1e6)
