"""The benchmark of ``fastegnn_tpu_torch``, the PyTorch / CUDA port.

``python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on one card and prints one JSON line.
Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own under this folder, found by the name that
``BENCHMARK.json`` gives it (``manifest.py``).
"""
