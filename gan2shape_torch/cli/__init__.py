"""The port's entry points: `python -m gan2shape_torch.cli.train` and
`python -m gan2shape_torch.cli.evaluate`."""
