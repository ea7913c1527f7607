"""The benchmark of zopfli_tpu_torch on NVIDIA GPUs.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of the root `BENCHMARK.json` once and
prints one JSON line.  Every cell, configuration, traffic mix, input
kind, entry, output format, control encoder and metric is a file of its
own, found by the name the manifest gives it (`manifest.py`):
configurations in `configs/`, traffic mixes in `traffic/` (data read by
the one generator, `gen.py`), input kinds in `inputs/`, entries in
`entries/`, formats and control encoders in `reference/formats/` and
`reference/encoders/`, metric readers in `metrics/`.  `reference/` is
the plain checker that decides `correct`.
Nothing here imports jax, zopfli_tpu or the repository's older bench
scripts.
"""
