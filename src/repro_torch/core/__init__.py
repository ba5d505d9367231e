"""CATO core: multi-objective Bayesian optimization of serving pipelines.

The port's own copies of the numpy-only `repro.core` modules: the
Optimizer (multi-objective BO with MI-based dimensionality reduction and
πBO prior injection), the memoized evaluator, the priors, Pareto utilities,
the random-forest surrogate, the search-space encoding and the dense forest
trainer. The traffic-analysis Profiler lives in
`repro_torch.traffic.profiler`; the baseline searches and feature
selectors in `repro_torch.core.baselines` and the LM serving-config tuner
in `repro_torch.core.tuner`, imported from there as in the reference.
"""
from .search_space import FeatureRep, SearchSpace
from .optimizer import CatoOptimizer, CatoResult, Observation
from .evaluator import MeasurementBackend, MemoizedEvaluator
from .priors import CatoPriors, build_priors
from .pareto import (
    hvi_ratio, hypervolume_2d, knee_index, pareto_front, pareto_mask,
)
from .surrogate import RFSurrogate
from .forest import (
    DenseForest,
    forest_apply_np,
    forest_predict_class,
    train_forest,
    train_tree,
)

__all__ = [
    "FeatureRep",
    "SearchSpace",
    "CatoOptimizer",
    "CatoResult",
    "Observation",
    "MeasurementBackend",
    "MemoizedEvaluator",
    "CatoPriors",
    "build_priors",
    "hvi_ratio",
    "hypervolume_2d",
    "knee_index",
    "pareto_front",
    "pareto_mask",
    "RFSurrogate",
    "DenseForest",
    "forest_apply_np",
    "forest_predict_class",
    "train_forest",
    "train_tree",
]
