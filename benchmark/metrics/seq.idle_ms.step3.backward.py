"""`idle_ms.step3.backward` in the cells that train one image after another, where it moves
`seq.instance_s`: the same reader."""

from benchmark.spec import load_reader

read = load_reader("idle_ms.step3.backward")
