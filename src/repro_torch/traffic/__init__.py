"""Traffic-analysis substrate of the port: traces, the feature registry,
extraction in torch ops, model training and the Profiler that measures
cost(x) and perf(x). The serving pipeline is `repro_torch.traffic.pipeline`
and the multi-tenant one `repro_torch.traffic.multi_tenant`, as in the
reference."""
from .extraction import extract_features
from .features import FEATURE_NAMES, FEATURES, MINI_FEATURE_NAMES, OPS
from .models import macro_f1, train_traffic_model
from .profiler import ProfileResult, TrafficProfiler
from .backends import ProfilerBackend, backend_suite
from .synth import TrafficDataset, make_dataset

__all__ = [
    "TrafficDataset",
    "make_dataset",
    "FEATURES",
    "FEATURE_NAMES",
    "MINI_FEATURE_NAMES",
    "OPS",
    "extract_features",
    "TrafficProfiler",
    "ProfileResult",
    "ProfilerBackend",
    "backend_suite",
    "train_traffic_model",
    "macro_f1",
]
