"""Model registry — maps model names to invokable callables.

The analogue of pointing a Tensor-Filter at a ``.tflite`` path: models
register under a name and TensorFilter / SingleShot resolve them.
Built-ins: "identity" plus lazy loaders for the 10 assigned architecture
configs (reduced "smoke" variants, so a textual pipeline can reference
``model=smollm-360m:smoke`` without multi-GiB allocation).  A loaded
model lives on a device: ``get_model(name, device)`` builds and caches
one per (name, device), ``cuda`` unless the caller names another.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

_MODELS: Dict[str, Callable] = {}
_LOADED: Dict[Tuple[str, str], Callable] = {}
_LOCK = threading.Lock()


def register_model(name: str, fn: Callable) -> None:
    with _LOCK:
        _MODELS[name] = fn


def get_model(name: str, device=None) -> Callable:
    """The callable registered as ``name``, or the lazily built
    ``"<arch>:smoke"`` forward on ``device`` (default ``cuda``; raises
    without a GPU unless a device is named)."""
    with _LOCK:
        if name in _MODELS:
            return _MODELS[name]
    if name.endswith(":smoke"):
        from .models.common import resolve_device
        key = (name, str(resolve_device(device)))
        with _LOCK:
            fn = _LOADED.get(key)
        if fn is None:
            fn = _try_lazy_load(name, key[1])
        if fn is not None:
            with _LOCK:
                return _LOADED.setdefault(key, fn)
    raise ValueError(f"unknown model {name!r}; registered: {sorted(_MODELS)}")


def _try_lazy_load(name: str, device: str) -> Optional[Callable]:
    """Resolve "<arch>:smoke" to the forward of the reduced config on
    ``device``: ``forward(tokens, *extra) -> (logits, aux)`` under
    ``torch.inference_mode()`` (``extra``: the frames or patches).  The
    random weights are ``init(seed=0)``'s on the CPU, moved to
    ``device``: the same numbers on every device (a CUDA generator draws
    others)."""
    arch = name[: -len(":smoke")]
    from .configs import get_config
    try:
        cfg = get_config(arch, smoke=True)
    except KeyError:
        return None
    import torch
    from . import bridge
    from .models import build_model

    model = build_model(cfg, device=device)
    params = bridge.to_torch(build_model(cfg, device="cpu").init(seed=0),
                             device)

    def forward(tokens, *extra):
        with torch.inference_mode():
            return model.apply(params, tokens, *extra)

    return forward


register_model("identity", lambda *xs: xs if len(xs) > 1 else xs[0])
