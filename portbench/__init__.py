"""The benchmark of `crlot_tpu_torch` on NVIDIA H100 cards.

One command runs one cell of `BENCHMARK.json` once:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (`configs/<name>.json`: the deployment's
sizes), a traffic mix (`traffic/<name>.json`: the entry, the spectral
function, how inputs are made from the seed, the loop) and the cards it
needs; the mix's `entry` names a module (`entries/<entry>.py`) that holds
what the cell runs and is checked against; each per-layer metric is a
reader of its own (`metrics/<name>.py`); each cell's correctness limits
sit in `limits/<cell>.json`. The harness finds all of them by the names
in `BENCHMARK.json` and the mix, each module by its path (`spec.entry`,
`spec.metric_reader`), so a cell, a mix, a configuration, an entry or a
metric is added by adding files and entries.

An entry module gives, for a `spec.Cell`:

* `input_shape(cell) -> (rows, samples)`: one input's shape.
* `inputs(cell, seed, device) -> list`: the ring of inputs the loop
  draws from, made from `seed` alone; where they live (on `device` or
  on the host) is the entry's to say.
* `Loop(cell, ring, device, mesh)`: the timed path. `step(i) -> (out,
  done)` issues call i and returns its output and a tag, >= 0, of the
  input it completed (a clip's place in the ring, a stream's chunk), or
  < 0 where it completed none; the window keeps a seeded sample of the
  `(out, done)` pairs. `pieces(kept)` turns one into `[(output,
  make_ref)]`, where `make_ref(ref)` gives the reference's answer for
  that output from the object `reference` returns. `free()` drops the
  program's state before the check. `samples_per_step`: the samples
  (rows x samples) a step completes.
* `reference(cell, device, precision)`: that object, for `precision`
  "float64" (the reference) and "tf32" (the control). It may count
  `bins` and `gated_bins`, which the check reports as the gated share.

Pieces hand `reference/stft64.compare` real tensors of one shape (a
spectrogram as `torch.view_as_real` of it, say). A reference takes
nothing the program made: it works its tables out from the cell's files
and reads the program's inputs and outputs only to judge them. The mesh
a loop gets is `card._mesh`'s, from the mix's `mesh`, or None.

The yardstick lives here and not in the program: input generation
(`signals.py`), the published peaks (`peaks.py`), the work counts of the
kernels' products (`work.py`), the trace arithmetic (`trace.py`), and the
float64 reference with its comparison (`reference/`). The harness imports
the program, `crlot_tpu_torch`, and never `jax` or the JAX package.
"""
