"""`span_cover_pct.step2` in the cells that report `seq.instance_s`: the same
reader."""

from benchmark.spec import load_reader

read = load_reader("span_cover_pct.step2")
