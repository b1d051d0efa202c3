"""One intra-op thread for torch in each test process.

The suite runs as several processes at once (pytest-xdist), and torch's
default of one intra-op thread per core in every process oversubscribes the
cores: on an 8-core machine six of the port's test files run side by side
took 398 s with the default and 74 s with one thread each, while one file
alone takes the same time either way. Every `tests/test_torch_*.py` imports
this module; the setting holds for the whole process, and a comparison of
two port results within one process is unchanged by it.
"""

import torch

torch.set_num_threads(1)
