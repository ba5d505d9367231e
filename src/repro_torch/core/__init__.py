"""The port's copies of the numpy-only `repro.core` modules it needs: the
search-space encoding and the dense forest trainer."""
from .forest import DenseForest, forest_apply_np, forest_predict_class, train_forest
from .search_space import FeatureRep, SearchSpace

__all__ = [
    "DenseForest",
    "FeatureRep",
    "SearchSpace",
    "forest_apply_np",
    "forest_predict_class",
    "train_forest",
]
