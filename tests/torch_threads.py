"""Share the CPU's cores among pytest-xdist's workers in the port's tests.

PyTorch runs each CPU op on as many OpenMP threads as the machine has
cores, and idle OpenMP threads spin before they sleep. Under ``pytest -n
6`` on an 8-core machine six workers each ran 8 such threads: the tests
of the port took 712 s of wall time (63 min of CPU) for what takes 283 s
(20 min) with one thread a worker, and the two-process JAX workers of
tests/test_multihost.py, starved, missed their gloo connect timeout.
Imported by every tests/test_torch_*.py module; outside xdist it changes
nothing.
"""

import os

import torch

WORKERS = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))
if WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))
