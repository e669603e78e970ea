"""The benchmark of ``ergo_uvo_tpu_torch`` on one NVIDIA H100.

``python3 uvo_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line.  Nothing here
imports JAX or the JAX package; ``reference/`` imports nothing of the port.
"""
