"""Command-line interface of the port (``python -m gqmap_tpu_torch.cli.main``)."""
