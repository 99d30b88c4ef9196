"""One intra-op thread for a test module's CPU work.

The port's CPU tests run many small ops (smoke widths, several logical
ranks a step).  With one intra-op thread a core, PyTorch's thread pool
spins at every op's barrier; on a host whose cores are shared (the test
run's other workers, other machines' work) that made a smoke
manual-DP step 80-130 times slower than on one thread (5.6 s against
0.066 s).  The numbers tested do not depend on it beyond summation
order, which every bound here already allows, and every comparison
within the port is made under the same setting.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Run the module on one intra-op thread; restore the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
