"""The benchmark of the PyTorch and CUDA port (``mrisr_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line.  Cells, configurations, traffic mixes, loops and per-layer
metric readers are found by name under this directory; the plain
references under ``reference/`` import nothing of the port.
"""
