"""Launch layer: ``serve`` (``python -m repro_torch.launch.serve``), the LM
serving driver."""
