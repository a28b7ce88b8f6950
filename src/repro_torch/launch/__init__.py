"""Launchers (port of repro.launch): ``python -m repro_torch.launch.serve``."""
