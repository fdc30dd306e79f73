"""portbench: the benchmark of frizbee_tpu_torch, the PyTorch and CUDA port
(``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``; the cells are listed in ``BENCHMARK.json``)."""
