"""The benchmark of ``josefine_tpu_torch`` on an NVIDIA card.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell needs is found by name: its configuration
(``configs/``), its traffic mix (``traffic/``), the driver its
configuration names (``drivers/``) and a reader per metric
(``metrics/``). The plain references that decide ``correct`` are in
``reference/``; they import nothing of the program.
"""
