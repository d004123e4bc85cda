"""Fixtures and helpers shared by the PyTorch port's test modules
(tests/test_torch_*.py).

Import the fixture into a test module to apply it there:

    from torch_port_fixtures import single_threaded_cpu  # noqa: F401
"""

import pytest
import threadpoolctl
import torch

# the leaves a teacher-forced top scan is differentiated by, in the order
# of `teacher_leaves`
TEACHER_LEAVES = ('W_a', 'v_a', 'b_UW', 'b_v', 'kernel', 'recurrent_kernel',
                  'bias', 'xs', 'att', 'u', 'h0', 'c0')


def teacher_leaves(top, xs, att, u, h0, c0):
    """The top layer's parameters and the scan's inputs as a flat list
    (arrays or tensors, of either package)."""
    c = top['cell']
    return [top['W_a'], top['v_a'], top['b_UW'], top['b_v'], c['kernel'],
            c['recurrent_kernel'], c['bias'], xs, att, u, h0, c0]


@pytest.fixture(autouse=True, scope='module')
def single_threaded_cpu():
    """One intra-op thread for torch and for numpy's BLAS per process.

    The suite runs several test processes at once; each pool otherwise
    spawns a thread per core, and numpy's QR in ``init_params`` (run by
    every model load) then slows from ~1 s to ~250 s at the flagship's
    width when six processes contend (measured on an 8-core host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)
