"""Command-line tools of the torch port (run with `python -m`)."""
