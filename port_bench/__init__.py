"""Benchmark of the PyTorch / CUDA port (``audio_sheet_retrieval_tpu_torch``).

``python port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix, driver or metric is a file of its
own under this folder, found by the name ``BENCHMARK.json`` gives it.
"""
