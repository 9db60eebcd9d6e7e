"""The benchmark of the port (`gan2shape_torch`): GPU seconds per instance
over the method's 6300-iteration schedule, cut in depth, on one H100.

    python3 -m benchmark.run --workload face128-seq --seed 7 --seconds 40 --trace 0

The cells, configurations, traffic mixes and metrics are named in the
repository's BENCHMARK.json; each has files of its own under this folder
(`configs/`, `traffic/`, `limits/`, `metrics/`), found by name (`spec.py`).
"""
