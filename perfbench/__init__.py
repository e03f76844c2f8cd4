"""The benchmark of ``comdb2_tpu_torch`` on an NVIDIA card.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix or
per-layer metric is a file of its own, found by the name
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the deployment (history shape, guarantees);
- ``traffic/<traffic>.json``: the mix's parameters, and the ``kind`` of
  caller that drives the program, ``traffic/<kind>.py``;
- ``metrics/<metric>.py``: the reader of one metric.

``gen/`` makes the inputs from the seed, ``reference/`` is the plain
reference that decides ``correct``, ``lib/`` the general harness.
Nothing here imports JAX or the JAX package.
"""
