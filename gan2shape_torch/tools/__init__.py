"""Command-line tools of the port (run with `python -m`): the checks, the
benchmarks and studies, and the GAN side's data, training and sampling."""
