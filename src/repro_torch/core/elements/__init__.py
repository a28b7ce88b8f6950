from .queue import Queue
from .sources import AppSrc, VideoTestSrc, SensorSrc, TensorSrcIIO
from .sinks import AppSink, TensorSink, FakeSink
from .converter import TensorConverter, TensorDecoder
from .filter import TensorFilter
from .routing import (Tee, TensorMux, TensorDemux, TensorMerge, TensorSplit,
                      InputSelector, OutputSelector, Valve)
from .aggregator import TensorAggregator, TensorRate
from .batcher import TensorBatcher, TensorUnbatcher
from .transform import TensorTransform
from .flow import TensorIf, TensorRepoSink, TensorRepoSrc, TensorRepo
from .query import (QueryConnection, TensorQueryServerSink,
                    TensorQueryServerSrc)

__all__ = [
    "Queue", "AppSrc", "VideoTestSrc", "SensorSrc", "TensorSrcIIO",
    "AppSink", "TensorSink", "FakeSink",
    "TensorConverter", "TensorDecoder", "TensorFilter",
    "Tee", "TensorMux", "TensorDemux", "TensorMerge", "TensorSplit",
    "InputSelector", "OutputSelector", "Valve",
    "TensorAggregator", "TensorRate", "TensorTransform",
    "TensorBatcher", "TensorUnbatcher",
    "TensorIf", "TensorRepoSink", "TensorRepoSrc", "TensorRepo",
    "QueryConnection", "TensorQueryServerSrc", "TensorQueryServerSink",
]
