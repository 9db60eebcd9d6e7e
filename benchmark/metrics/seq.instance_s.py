"""`instance_s` in the cells that train one image after another: the same
reader, under a bound of its own, since the host-bound steps spread more
from run to run than the stacked cells' device-bound ones."""

from benchmark.spec import load_reader

read = load_reader("instance_s")
