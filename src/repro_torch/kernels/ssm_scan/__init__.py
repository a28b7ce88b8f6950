"""Selective scan, Mamba S6 (port of repro.kernels.ssm_scan)."""
