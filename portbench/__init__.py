"""The benchmark of the PyTorch and CUDA port (``neurallaplacecontrol_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line. Everything that
belongs to one configuration, traffic mix or metric is a file of its own
under this directory, found by its name:

- ``configs/<config>.json``: the model and planner as run, with its source;
- ``traffic/<traffic>.json``: the parameters of a traffic mix, read by the
  driver that its ``kind`` names (``drivers/<kind>.py``);
- ``e2e/<metric>.py`` and ``metrics/<metric>.py``: one reader per metric;
- ``limits/<cell>.json``: the limits of the numbers that decide ``correct``;
- ``reference/``: the plain PyTorch reference, which imports nothing of the
  port.
"""
