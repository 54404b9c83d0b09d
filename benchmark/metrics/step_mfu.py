"""The whole step's share of the card's peak: the model FLOPs of forward
and backward for the window's batches (the configuration's counter,
``counters/<config>.py::step_flops``, from real nodes and edges, no
recomputation) over the window's seconds times the peak of the
configuration's dtype (``roofline.PEAK_OPS``), in %."""

from benchmark.roofline import PEAK_OPS


def read(ctx):
    w = ctx["window"]
    if not w["steps"]:
        return None
    flops = sum(ctx["counter"].step_flops(ctx["cfg"], *shape) for shape in w["shapes"])
    return 100.0 * flops / (w["seconds"] * PEAK_OPS[ctx["cfg"]["dtype"]])
