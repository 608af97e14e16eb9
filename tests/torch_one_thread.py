"""Shared by the tests of the PyTorch port (``tests/test_torch_*.py``),
which import the fixture below so that pytest applies it to their module."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the machine's cores among several test
    processes: keep this module's torch work on one thread so that it does
    not starve the timing tests running beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """The same for the float64 host code of a module (NumPy's matrix
    products run in OpenBLAS, whose idle threads spin): one BLAS thread."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1, user_api="blas"):
        yield
