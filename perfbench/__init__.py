"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell needs is data found by name:

- ``configs/<config>.json``: the model as it is run, its source and cuts;
- ``traffic/<traffic>.json``: the entry, shapes, plan and optimizer;
- ``plans/<plan>.json``: a parallelization plan in the port's format;
- ``limits/<cell>.json``: the limits of the comparison that decides
  ``correct``, with the readings they were set from;
- ``entries/<entry>.py``: the timed path (``train``, ``sweep``);
- ``metrics/<metric>.py``: one reader per per-layer metric.

Nothing here imports JAX or the JAX package, and ``reference/`` imports
nothing of the port.
"""
