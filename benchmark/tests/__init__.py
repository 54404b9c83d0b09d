"""CPU tests of the benchmark (``python -m pytest benchmark/tests``); those
marked ``cuda`` run on the card and skip elsewhere."""
