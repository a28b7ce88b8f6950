"""gst-launch-style textual pipeline syntax.

Supported grammar (a practical subset of gst-launch-1.0):

    pipeline  := chain (WS chain)*
    chain     := endpoint ( '!' endpoint )*
    endpoint  := element | padref
    element   := TYPE (prop '=' value)*
    padref    := NAME '.' [PADNAME]          # reference an existing element

Examples::

    videotestsrc num_buffers=10 ! tensor_converter ! tensor_filter
        framework=python model=identity ! tensor_sink name=out

    tee name=t num_src_pads=2  t.src_0 ! queue ! fakesink name=a
        t.src_1 ! queue ! fakesink name=b

    sensorsrc num_buffers=8 ! mux.sink_0  sensorsrc num_buffers=8 seed=3 !
        mux.sink_1  tensor_mux name=mux num_sinks=2 ! tensor_sink name=out

Chains may reference elements defined later (two-pass link resolution),
matching gst-launch ergonomics.
"""
from __future__ import annotations

import re
import shlex
from typing import Dict, List, Optional, Tuple

from .pipeline import Pipeline
from .registry import make_element

_PADREF = re.compile(r"^([A-Za-z_][\w\-]*)\.([\w\-]*)$")
_PROP = re.compile(r"^([\w\-]+)=(.*)$")
_TYPE = re.compile(r"^[A-Za-z_][\w\-]*$")


class _Endpoint:
    def __init__(self, element_name: str, pad: Optional[str] = None):
        self.element_name = element_name
        self.pad = pad  # None = default/auto


def parse_pipeline(description: str, name: str = "pipeline",
                   models: Optional[Dict[str, object]] = None) -> Pipeline:
    """Parse a textual description into a ready-to-start Pipeline.

    ``models`` optionally maps model names to callables, registered into
    the model registry before tensor_filters resolve.
    """
    if models:
        from ..registry import register_model
        for mname, fn in models.items():
            register_model(mname, fn)

    tokens = shlex.split(description.replace("!", " ! "))
    pipe = Pipeline(name)
    auto_idx = 0

    # pass 1: create elements, record link requests
    links: List[Tuple[_Endpoint, _Endpoint]] = []
    prev: Optional[_Endpoint] = None
    pending_link = False
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if tok == "!":
            if prev is None:
                raise ValueError("'!' with no upstream element")
            pending_link = True
            i += 1
            continue
        m = _PADREF.match(tok)
        if m:  # padref may reference an element defined later (pass-2 resolve)
            ep = _Endpoint(m.group(1), m.group(2) or None)
        elif _TYPE.match(tok) and not _PROP.match(tok):
            # element instantiation: gather props
            type_name = tok
            props: Dict[str, str] = {}
            j = i + 1
            while j < len(tokens):
                pm = _PROP.match(tokens[j])
                if not pm or tokens[j] == "!":
                    break
                props[pm.group(1).replace("-", "_")] = pm.group(2)
                j += 1
            i = j - 1
            el_name = props.pop("name", None)
            if el_name is None:
                el_name = f"{type_name}{auto_idx}"
                auto_idx += 1
            pipe.add(make_element(type_name, el_name, **props))
            ep = _Endpoint(el_name, None)
        else:
            raise ValueError(f"cannot parse token {tok!r}")
        if pending_link:
            links.append((prev, ep))
            pending_link = False
        prev = ep
        i += 1

    if pending_link:
        raise ValueError("dangling '!' at end of description")

    # pass 2: resolve links
    for up, down in links:
        src_el = pipe.elements[up.element_name]
        dst_el = pipe.elements[down.element_name]
        src_el.link(dst_el, srcpad=up.pad or None, sinkpad=down.pad or None)
    return pipe
