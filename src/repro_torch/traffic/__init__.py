"""Traffic-analysis substrate of the port: traces, the feature registry,
extraction in torch ops and model training. The serving pipeline is
`repro_torch.traffic.pipeline`, as in the reference."""
from .extraction import extract_features
from .features import FEATURE_NAMES, FEATURES, MINI_FEATURE_NAMES, OPS
from .models import macro_f1, train_traffic_model
from .synth import TrafficDataset, make_dataset

__all__ = [
    "TrafficDataset",
    "make_dataset",
    "FEATURES",
    "FEATURE_NAMES",
    "MINI_FEATURE_NAMES",
    "OPS",
    "extract_features",
    "train_traffic_model",
    "macro_f1",
]
