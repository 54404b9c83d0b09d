"""Host ms per collate of the batches the window consumed: the mean of
``GraphDataset.collate_seconds`` (the port's own record, one entry per
collate, appended by the prefetch thread that ran it) over the collates
that finished inside the window.  None where the window collated nothing
(batches kept on the card)."""


def read(ctx):
    s = ctx["window"]["collate_s"]
    return 1e3 * sum(s) / len(s) if s else None
