"""The benchmark of groove_tpu_torch on one NVIDIA H100.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the repository root names the cells; everything that
belongs to one configuration, traffic mix, entry or metric is a file of
its own here, found by name (see README.md).
"""
