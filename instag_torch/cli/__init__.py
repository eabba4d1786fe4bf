"""Command-line entry points of the port (``python -m instag_torch.cli.<name>``)."""
