"""Intra-op threads of torch in the port's CPU test processes.

The repository's test command runs six pytest-xdist workers.  At torch's
default (one intra-op thread per core) every worker's operators spread
over the whole machine, and the workers oversubscribe it: six of the
heaviest port test files, run together as six workers on an 8-core CPU
machine, took 411 s at the default and 164 s at two threads each.  Every
port test file that computes with torch imports this module, which caps
its process at ``THREADS``; the rank and subprocess launches of the
tests set ``OMP_NUM_THREADS=1`` instead.
"""

import torch

THREADS = 2

torch.set_num_threads(THREADS)
