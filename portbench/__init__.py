"""The benchmark of `crlot_tpu_torch` on NVIDIA H100 cards.

One command runs one cell of `BENCHMARK.json` once:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (`configs/<name>.json`: the deployment's
sizes), a traffic mix (`traffic/<name>.json`: the entry, the spectral
function, how inputs are made from the seed, the loop) and the cards it
needs; each per-layer metric is a reader of its own (`metrics/<name>.py`);
each cell's correctness limits sit in `limits/<cell>.json`. The harness
finds all of them by the names in `BENCHMARK.json`, so a cell, a mix, a
configuration or a metric is added by adding files and entries.

The yardstick lives here and not in the program: input generation
(`signals.py`), the published peaks (`peaks.py`), the work counts of the
kernels' products (`work.py`), the trace arithmetic (`trace.py`), and the
float64 reference with its comparison (`reference/`). The harness imports
the program, `crlot_tpu_torch`, and never `jax` or the JAX package.
"""
