"""pillarbench: the benchmark of ``tpu_pillars_torch`` on an NVIDIA H100.

``python3 -m pillarbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. See ``pillarbench/README.md``.
"""
