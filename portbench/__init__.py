"""The benchmark of quadruped_tpu_torch on NVIDIA GPUs.

`python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json on the card and prints one
JSON result line. The harness is driven by data: a cell names a
configuration (`configs/<name>.json`) and a traffic mix
(`traffic/<name>.json`), the mix names its driver (`drivers/<kind>.py`) and
its plain reference (`reference/`), each per-layer metric has its reader
(`metrics/<name>.py`) and each cell its correctness limits
(`limits/<cell>.json`). Nothing here imports JAX or the JAX package.
"""
