"""One intra-op thread per test process for the PyTorch tests.

Tier-1 runs the tests in six worker processes on the host's cores, and
torch's default of one intra-op thread per core in every process
oversubscribes them: a test file of the port then takes about 2.5 times
the CPU time it takes with one thread, and no less wall time. The
results do not depend on the thread count (the port's reductions over a
tensor give the same sums at 1, 3 and 8 threads). Every
tests/test_torch_*.py module imports this before it runs a test; the
setting is the same in all of them, whichever module a worker imports
first.
"""

import torch

torch.set_num_threads(1)
