"""The benchmark of fiode_tpu_torch on one NVIDIA H100: one run of one
cell of ``BENCHMARK.json`` is ``python3 perfbench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>``."""
