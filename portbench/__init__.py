"""The benchmark of the PyTorch and CUDA port (``repro_torch``): a harness
driven by ``BENCHMARK.json`` and the data files beside it.  Run one cell
with ``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``."""
