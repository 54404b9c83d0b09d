"""1 minus the union of the device operations' intervals (kernels, copies,
fills) over the profiled window's wall time, in %: how far the host and
the feed hold the card back."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["trace"].window_us <= 0:
        return None
    return 100.0 * (1.0 - tr["trace"].busy_us / tr["trace"].window_us)
