"""`bias_act_roofline` in the cells that report `seq.instance_s`: the same
reader."""

from benchmark.spec import load_reader

read = load_reader("bias_act_roofline")
