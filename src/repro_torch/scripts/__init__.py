"""Command-line drills and reports of the port (``python -m repro_torch.scripts.<name>``)."""
