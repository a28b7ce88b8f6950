"""Element registry — maps gst-launch element type names to factories.

Plugin-style: anything can register new element types at run-time
(``register_element``), mirroring GStreamer's plugin registry.
"""
from __future__ import annotations

from typing import Callable, Dict

from .element import Element
from . import elements as E

_ELEMENTS: Dict[str, Callable[..., Element]] = {}


def register_element(type_name: str, factory: Callable[..., Element]) -> None:
    _ELEMENTS[type_name] = factory


def make_element(type_name: str, name: str, **props) -> Element:
    if type_name not in _ELEMENTS:
        raise ValueError(f"unknown element type {type_name!r}; "
                         f"known: {sorted(_ELEMENTS)}")
    return _ELEMENTS[type_name](name=name, **props)


def _register_builtins() -> None:
    register_element("queue", lambda name, **p: E.Queue(
        name, max_size=int(p.get("max_size", 16)), leaky=p.get("leaky", "no"),
        workers=int(p.get("workers", 1))))
    register_element("appsrc", lambda name, **p: E.AppSrc(name))
    register_element("videotestsrc", lambda name, **p: E.VideoTestSrc(
        name, width=int(p.get("width", 224)), height=int(p.get("height", 224)),
        channels=int(p.get("channels", 3)),
        num_buffers=int(p.get("num_buffers", -1)),
        rate=float(p["rate"]) if "rate" in p else None,
        seed=int(p.get("seed", 0))))
    register_element("sensorsrc", lambda name, **p: E.SensorSrc(
        name, channels=int(p.get("channels", 3)),
        num_buffers=int(p.get("num_buffers", -1)),
        rate=float(p["rate"]) if "rate" in p else None,
        seed=int(p.get("seed", 0))))
    register_element("tensor_src_iio", lambda name, **p: E.TensorSrcIIO(
        name, channels=int(p.get("channels", 3)),
        num_buffers=int(p.get("num_buffers", -1)),
        rate=float(p["rate"]) if "rate" in p else None,
        seed=int(p.get("seed", 0))))
    register_element("appsink", lambda name, **p: E.AppSink(
        name, max_size=int(p.get("max_size", 0)),
        drop=str(p.get("drop", "false")).lower() == "true"))
    register_element("tensor_sink", lambda name, **p: E.TensorSink(
        name, keep=str(p.get("keep", "false")).lower() == "true"))
    register_element("fakesink", lambda name, **p: E.FakeSink(name))
    register_element("tensor_converter", lambda name, **p: E.TensorConverter(
        name, mode=p.get("mode", "video"),
        to_float=str(p.get("to_float", "false")).lower() == "true",
        text_size=int(p.get("text_size", 256))))
    register_element("tensor_decoder", lambda name, **p: E.TensorDecoder(
        name, mode=p.get("mode", "argmax_label"),
        width=int(p.get("width", 0)), height=int(p.get("height", 0))))
    register_element("tensor_filter", lambda name, **p: E.TensorFilter(
        name, model=p.get("model"), framework=p.get("framework", "python"),
        max_batch=int(p.get("max_batch", 8)),
        pass_meta=str(p.get("pass_meta", "false")).lower() == "true"))
    register_element("tensor_batcher", lambda name, **p: E.TensorBatcher(
        name, max_batch=int(p.get("max_batch", 8)),
        max_wait_ms=float(p["max_wait_ms"]) if "max_wait_ms" in p else None))
    register_element("tensor_unbatcher", lambda name, **p: E.TensorUnbatcher(name))
    register_element("tee", lambda name, **p: E.Tee(
        name, num_src_pads=int(p.get("num_src_pads", 0))))
    register_element("tensor_mux", lambda name, **p: E.TensorMux(
        name, num_sinks=int(p["num_sinks"]), sync=p.get("sync", "slowest")))
    register_element("tensor_demux", lambda name, **p: E.TensorDemux(
        name, num_src_pads=int(p["num_src_pads"]),
        tensorpick=[int(x) for x in str(p["tensorpick"]).split(".")]
        if "tensorpick" in p else None))
    register_element("tensor_merge", lambda name, **p: E.TensorMerge(
        name, num_sinks=int(p["num_sinks"]), mode=p.get("mode", "concat:0"),
        sync=p.get("sync", "slowest")))
    register_element("tensor_split", lambda name, **p: E.TensorSplit(
        name, tensorseg=[int(x) for x in str(p["tensorseg"]).split(".")],
        gst_dim=int(p.get("dim", 0))))
    register_element("input_selector", lambda name, **p: E.InputSelector(
        name, num_sinks=int(p["num_sinks"]), active=int(p.get("active", 0))))
    register_element("output_selector", lambda name, **p: E.OutputSelector(
        name, num_srcs=int(p["num_srcs"]), active=int(p.get("active", 0))))
    register_element("valve", lambda name, **p: E.Valve(
        name, drop=str(p.get("drop", "false")).lower() == "true"))
    register_element("tensor_aggregator", lambda name, **p: E.TensorAggregator(
        name, frames_in=int(p.get("frames_in", 2)),
        frames_flush=int(p["frames_flush"]) if "frames_flush" in p else None,
        concat_axis=int(p.get("concat_axis", 0)),
        stack=str(p.get("stack", "false")).lower() == "true"))
    register_element("tensor_rate", lambda name, **p: E.TensorRate(
        name, framerate=float(p["framerate"]),
        throttle=str(p.get("throttle", "true")).lower() == "true"))
    register_element("tensor_transform", lambda name, **p: E.TensorTransform(
        name, option=p["option"], backend=p.get("backend", "numpy")))
    register_element("tensor_if", lambda name, **p: E.TensorIf(
        name, reduction=p.get("reduction", "mean"),
        compare=p.get("compare", "gt"), value=float(p.get("value", 0.0)),
        behavior=p.get("behavior", "route")))
    register_element("tensor_reposink", lambda name, **p: E.TensorRepoSink(
        name, slot=p["slot"]))
    register_element("tensor_query_serversrc", lambda name, **p:
        E.TensorQueryServerSrc(
            name, host=p.get("host", "127.0.0.1"), port=int(p.get("port", 0)),
            pad_to=int(p.get("pad_to", 64)),
            backlog=int(p.get("backlog", 16))))
    register_element("tensor_query_serversink", lambda name, **p:
        E.TensorQueryServerSink(name))
    register_element("tensor_reposrc", lambda name, **p: E.TensorRepoSrc(
        name, slot=p["slot"],
        seed_shape=tuple(int(x) for x in str(p["seed_shape"]).split(":"))
        if "seed_shape" in p else None,
        seed_dtype=p.get("seed_dtype", "float32")))


_register_builtins()
