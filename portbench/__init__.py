"""Benchmark of the PyTorch/CUDA port of Barnes-Hut t-SNE (``src/repro_torch``).

Run one cell with ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``; the cells are listed in ``BENCHMARK.json``
at the root of the checkout.  Everything that defines the yardstick
(data recipe, traffic, reference, limits, metric readers, peaks) lives in
this directory; the program under test is only ever imported from ``src``.
"""
