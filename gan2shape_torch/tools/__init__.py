"""Command-line checks of the port (run with `python -m`)."""
