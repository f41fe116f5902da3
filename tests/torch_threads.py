"""The port's CPU tests run torch on 2 threads a process.

``_torch_threads`` is a module-scoped autouse fixture: a test module
imports it, and it holds torch at 2 threads from before the module's first
fixture to after its last test. Under the tier-1 command's 6 xdist workers
on a shared host, a module fixture that ran torch at its default of one
thread per core made the workers' threads outnumber the cores many times
over, and a step that takes seconds alone took minutes. A test that wants
fewer threads sets them itself (its function-scoped fixture does).
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(threads)
