"""The benchmark of ``rvos_tpu_torch`` (the PyTorch and CUDA port).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Cells, configurations, traffic mixes and per-layer metrics
are found by name under this directory; see ``run.py``.
"""
