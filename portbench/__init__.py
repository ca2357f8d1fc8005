"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA card it
is started on and prints one JSON line.  Everything a cell is made of is
found by name: its configuration in ``configs/``, its traffic in
``traffic/``, each metric's reader in ``metrics/`` and each model
family's plain reference in ``references/``.
"""
