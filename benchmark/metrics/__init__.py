"""Readers of the per-layer metrics: ``metrics/<name>.py::read(ctx)``."""
