"""The benchmark of pic1dp_tpu_torch on NVIDIA GPUs.

`python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once and prints one JSON line last.  Every
configuration, traffic mix, cell and metric is a file found by its name
(benchmark/spec.py); the yardstick (roofline counts, trace reduction, the
plain reference and the comparison that decides `correct`) lives here and
imports neither JAX nor the JAX package.
"""
