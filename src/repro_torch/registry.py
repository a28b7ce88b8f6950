"""Model registry — maps model names to invokable callables.

The analogue of pointing a Tensor-Filter at a ``.tflite`` path: models
register under a name and TensorFilter resolves them.  Built-in:
"identity".  The ``"<arch>:smoke"`` lazy loaders of the JAX package need
the full-sequence forward, which the port does not have yet.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict

_MODELS: Dict[str, Callable] = {}
_LOCK = threading.Lock()


def register_model(name: str, fn: Callable) -> None:
    with _LOCK:
        _MODELS[name] = fn


def get_model(name: str) -> Callable:
    with _LOCK:
        if name in _MODELS:
            return _MODELS[name]
    if name.endswith(":smoke"):
        raise NotImplementedError(
            f"{name!r}: the ':smoke' model loaders need the full-sequence "
            "forward, not yet ported (ROADMAP A14)")
    raise ValueError(f"unknown model {name!r}; registered: {sorted(_MODELS)}")


register_model("identity", lambda *xs: xs if len(xs) > 1 else xs[0])
