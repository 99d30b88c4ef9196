"""repro_torch.models — the port of ``repro.models``: configs, the dense
attention + MLP blocks and the block-pattern language model."""

from . import config, layers, model, inputs
from .config import (ModelConfig, ShapeConfig, ALL_SHAPES, TRAIN_4K,
                     PREFILL_32K, DECODE_32K, LONG_500K, applicable_shapes,
                     shape_by_name)
from .model import Model, init, init_cache, param_count, params_from_reference

__all__ = [
    "config", "layers", "model", "inputs", "ModelConfig", "ShapeConfig",
    "ALL_SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
    "applicable_shapes", "shape_by_name", "Model", "init", "init_cache",
    "param_count", "params_from_reference",
]
