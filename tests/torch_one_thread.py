"""One PyTorch thread in every process that runs the port's tests, as a
spawned rank runs (tpurt_torch/dist/launch.py).  Every tests/test_torch_*.py
imports this module, so the rule holds from collection on, before any test
runs, with or without xdist, and in a run of a single file.

Two reasons.  The plain versions' parallel elementwise ops crawl while the
other test workers load the cores (171 s against 2 s for a 256x256 render
under the suite's six workers on eight cores).  And with several threads
pack_scene's backward (index_put_ with accumulation) changes its last bits
between runs on the CPU, which the bit-equal checks of the port's tests and
tools would catch (tests/test_torch_dist_check.py)."""
import torch

torch.set_num_threads(1)
