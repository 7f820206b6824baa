"""What the port's CPU tests share: torch on one intra-op thread.

The reduced models here are too small to split over threads, and the suite
runs several pytest workers at once, each with its own intra-op pool that
spins while it waits: a guarded step sequence of the reduced muonbp-960m
took 58.6 s of wall (280 s of CPU) on the default threads beside another
busy worker, and 14.1 s (15.3 s of CPU) on one. The checks, shapes and
tolerances are the same on any thread count. Every ``tests/test_torch_*.py``
that runs torch on the CPU imports this module first; ``gloo`` ranks set
the same in their own processes.
"""

import torch

torch.set_num_threads(1)
