"""The LM stack's models, every family (port of ``repro.models``)."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import ModelApi, build_model

__all__ = ["ModelApi", "ModelConfig", "build_model"]
