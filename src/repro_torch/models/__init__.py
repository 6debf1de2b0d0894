"""The LM stack's models, every family (port of ``repro.models``)."""

from repro_torch.models.config import (ALL_SHAPES, InputShape, ModelConfig,
                                       shapes_for, skipped_shapes_for)
from repro_torch.models.model import ModelApi, build_model

__all__ = ["ALL_SHAPES", "InputShape", "ModelApi", "ModelConfig",
           "build_model", "shapes_for", "skipped_shapes_for"]
