"""`device_ms.step2.forward` in the cells that report `seq.instance_s`: the same
reader."""

from benchmark.spec import load_reader

read = load_reader("device_ms.step2.forward")
