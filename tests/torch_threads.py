"""torch's CPU kernels in one thread for the port's tests.

Every `tests/test_torch_*.py` imports this module. The suite runs in
several pytest workers at once, each with an XLA thread pool of its own
for the reference; torch's default of one intra-op thread per core on
top of that oversubscribes the host many times over, and the small
tensors these tests use gain nothing from threads (the port's files ran
several times faster in one thread). The port's results do not depend
on the thread count."""

import torch

torch.set_num_threads(1)
