"""Fixtures of the benchmark's tests: the tiny configurations and, for the
tests marked ``cuda``, the card (decided here, never at import)."""

from __future__ import annotations

import pytest
import torch

from benchmark.tests import tiny


@pytest.fixture(scope="session")
def tiny_dir(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
