"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see README.md.
"""
