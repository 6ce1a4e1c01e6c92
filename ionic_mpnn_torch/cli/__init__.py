"""Command-line pipelines (``python -m ionic_mpnn_torch.cli.<name>``)."""
