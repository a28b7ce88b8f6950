"""Serving meshes (port of ``repro/launch/mesh.py``).

``make_serving_mesh(model=N)`` is the ``(1, N)`` data x model mesh the
paged engine serves over: the first N CUDA devices, or an explicit
``devices=`` list, which may repeat a device (``["cpu", "cpu"]``, or
``["cuda:0", "cuda:0"]`` on a one-card machine) the way XLA's forced
host device count simulates devices.  The reference's TPU-pod meshes
(``make_production_mesh``, ``make_host_mesh``) have no caller in the
port and are not ported.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..models.sharding import ServingMesh, normalize_device


def make_serving_mesh(model: int = 1,
                      devices: Optional[Sequence] = None) -> ServingMesh:
    """Pure tensor-parallel ``(1, model)`` mesh over the first ``model``
    of ``devices`` (default: the CUDA devices).  Serving keeps the data
    axis at 1, as the reference does: the slot batch is small and
    host-scheduled, and the weights and KV pool are where the memory
    and the work live.  Raises when there are fewer than ``model``."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i}" for i in range(n)]
    devices = list(devices)
    if model < 1 or model > len(devices):
        raise ValueError(
            f"make_serving_mesh(model={model}): have {len(devices)} "
            "device(s)")
    return ServingMesh(tuple(normalize_device(d) for d in devices[:model]))


def dp_axes(mesh) -> tuple:
    """The FSDP/batch axes of a mesh (everything except "model")."""
    return tuple(a for a in mesh.axis_names if a != "model")
