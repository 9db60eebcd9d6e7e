"""`render_ms.step3` in the cells that train one image after another, where it moves
`seq.instance_s`: the same reader."""

from benchmark.spec import load_reader

read = load_reader("render_ms.step3")
