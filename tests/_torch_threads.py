"""A module-scoped fixture that runs a test file's torch work on one
intra-op thread: ``from _torch_threads import one_intra_op_thread``
(autouse) in the tests/test_torch_*.py files that run on the CPU, but
test_torch_client.py (one of its 1e-6 comparisons of the serial and the
cohort update reads 1.01e-6 on one thread: it keeps the default).

The tier-1 command runs the tests in 6 xdist workers on a few cores,
and the spawned gloo ranks already take one thread each
(launch/distributed.spawn_local). With torch's default pool of one
thread a core in every worker, an op that enters a parallel region
waits for pool threads the other workers hold: a LeNet5 round's
convolution, a (4, 64) softmax or a ``repeat_interleave`` of 64 columns
then takes tens of milliseconds instead of microseconds (a serial
FedProx trainer case took 63.6 s beside five busy processes, 1.5 s on
one thread). The thread count is restored after the file, so a file
without the fixture runs as before.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
