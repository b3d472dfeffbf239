"""Fixtures of the benchmark's own tests (``python -m pytest
portbench/tests``). CPU tests drive the harness at tiny sizes of the cells'
configurations; tests marked ``cuda`` need the card and skip without one,
decided inside the ``cuda_device`` fixture."""

from __future__ import annotations

import pytest

from pb_helpers import shrunk_registry


@pytest.fixture
def small_registry():
    return shrunk_registry()


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
