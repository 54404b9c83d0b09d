"""Host ms inside each ``step(batch, key)`` call of the window, on the
benchmark's clock, with no synchronisation: the mean over the window's
steps.  Where the host dispatches slower than the card runs, this sets
the pace."""


def read(ctx):
    s = ctx["window"]["dispatch_s"]
    return 1e3 * sum(s) / len(s) if s else None
