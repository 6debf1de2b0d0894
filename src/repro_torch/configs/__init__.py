"""Architecture registry: the port's copy of ``repro.configs``.

``get(name)`` returns the exact published ModelConfig (or the l-NN
service's ``KnnServiceConfig`` for ``"knn-service"``), by module name or
alias, as the reference's does; ``registry()`` lists the architectures.
The configs are data: every architecture is listed, and ``build_model``
says which families the port runs.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.knn_service import CONFIG, KnnServiceConfig

_ARCHS = (
    "qwen2_5_14b",
    "qwen1_5_4b",
    "qwen2_0_5b",
    "yi_6b",
    "phi3_5_moe_42b",
    "granite_moe_3b",
    "jamba_1_5_large",
    "pixtral_12b",
    "seamless_m4t_v2",
    "xlstm_125m",
)

_ALIASES = {
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen1.5-4b": "qwen1_5_4b",
    "qwen2-0.5b": "qwen2_0_5b",
    "yi-6b": "yi_6b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "pixtral-12b": "pixtral_12b",
    "seamless-m4t-large-v2": "seamless_m4t_v2",
    "xlstm-125m": "xlstm_125m",
    "knn-service": "knn_service",
}


def get(name: str):
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def registry():
    return tuple(_ARCHS)


__all__ = ["CONFIG", "KnnServiceConfig", "get", "registry"]
