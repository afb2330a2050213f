"""The benchmark's own tests: the harness on the CPU at tiny sizes, and
(marked ``card``) the control at the cells' sizes on the GPU."""

import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")


# the port's host plane and plain versions: one torch thread a worker
torch.set_num_threads(1)
