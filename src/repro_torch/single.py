"""SingleShot — the paper's pipeline-less "Single API" (Tizen C/.NET,
Android), over the port's ``TensorFilter`` (port of ``repro/single.py``).

Run one model with a unified interface, no pipeline required::

    single = SingleShot(model="identity")
    out = single.invoke(np.ones((4,)))

    single = SingleShot(model="smollm-360m:smoke", framework="torch")
    logits, aux = single.invoke(tokens)      # numpy in, numpy out

    mesh = make_serving_mesh(model=2, devices=["cpu", "cpu"])
    single = SingleShot(model="smollm-360m:smoke",
                        framework="torch-sharded", mesh=mesh)

Backends as ``TensorFilter``'s: ``python`` (any callable), ``torch``
(numpy inputs uploaded to ``device``, ``cuda`` unless named; numpy
outputs) and ``torch-sharded`` (the same over ``mesh=``: a registry
model's weights sharded over the ranks; any other callable computes
what the reference's ``jit(fn, in_shardings, out_shardings)`` does, fn
of the whole inputs, on the mesh's first device).
"""
from __future__ import annotations

from typing import Any, Optional

from .core.elements.filter import TensorFilter

FRAMEWORKS = ("python", "torch", "torch-sharded")


class SingleShot:
    def __init__(self, model: Optional[str] = None, fn=None,
                 framework: str = "python", device=None, mesh=None,
                 in_shardings=None, out_shardings=None):
        if framework not in FRAMEWORKS:
            raise ValueError(f"unknown SingleShot framework {framework!r}; "
                             f"the port has {FRAMEWORKS}")
        self._filter = TensorFilter("single", fn=fn, model=model,
                                    framework=framework, device=device,
                                    mesh=mesh, in_shardings=in_shardings,
                                    out_shardings=out_shardings)

    def invoke(self, *inputs: Any) -> Any:
        out = self._filter.invoke(inputs)
        return out[0] if len(out) == 1 else out

    @property
    def mean_latency_s(self) -> float:
        return self._filter.mean_latency_s

    @property
    def n_invocations(self) -> int:
        return self._filter.n_invocations
