"""The segment-sum kernel against its roofline over the profiled window:
the least time of one step's launches, summed over the configuration's
``segsum_forms`` (each ``[width, bytes per value, through a permutation,
launches per step]`` over the batch's real edges and node rows;
``roofline.segsum_bound_s``), over the profiled time of every
``segment_sum_kernel`` launch, per step, in %.  None where the window
holds none."""

from benchmark.roofline import segsum_bound_s


def read(ctx):
    tr = ctx["trace"]
    forms = ctx["cfg"].get("segsum_forms")
    if tr is None or not forms or not tr["steps"]:
        return None
    us = sum(dur for name, _, dur in tr["trace"].kernels if "segment_sum_kernel" in name)
    if us <= 0:
        return None
    bound = sum(count * segsum_bound_s(e, n_rows, f, elt, perm)
                for _, _, e, n_rows in tr["shapes"] for f, elt, perm, count in forms)
    return 100.0 * bound / (us / 1e6)
