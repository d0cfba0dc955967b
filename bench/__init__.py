"""The benchmark of ``repro_torch`` on one NVIDIA H100.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell (``harness.run``) and prints one JSON
line.  Everything a cell is made of is found by name: the cell in
``workloads/<cell>.json``, its configuration in ``configs/``, its
traffic mix in ``traffic/<mix>.json`` (driven by the generator
``traffic/<kind>.py``), its data by ``data/<kind>.py``, the user's
program that the port compiles in ``programs/<program>.py``, its plain
reference (with the program's operation count) in
``reference/<program>.py`` and each metric's reader in
``metrics/<metric>.py``.  ``yardstick`` holds the peaks, the byte count
and the bound.  Nothing here imports JAX or the JAX package, and
``reference/`` imports nothing of ``repro_torch``.
"""
