"""The benchmark of ``dgnn_tpu_torch`` on one NVIDIA H100.

``python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Everything that
belongs to one configuration, traffic mix or per-layer metric sits in a
file of its own (``configs/``, ``traffic/``, ``metrics/``, ``limits/``,
``reference/``), found by the name the cell or metric gives.
"""
