import logging
import os
import sys

import pytest
import torch

# the checkout's root, so that `portbench` and the port import
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


@pytest.fixture(autouse=True, scope="session")
def _quiet():
    logging.disable(logging.INFO)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    yield
    logging.disable(logging.NOTSET)


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    from portbench.tests.common import tiny_copy
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
