"""Architecture registry (``repro.config.registry``): arch id ->
``ModelConfig``.

Each ported architecture registers itself from
``repro_torch/configs/<id>.py``. ``get_arch(name)`` returns the
full-size config; ``get_smoke_arch(name)`` the reduced same-family
config the CPU tests use.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.config.base import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {}
_SMOKE: Dict[str, ModelConfig] = {}


def register(full: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    if full.name in _REGISTRY:
        raise ValueError(f"duplicate arch {full.name!r}")
    _REGISTRY[full.name] = full
    _SMOKE[full.name] = smoke
    return full


def _ensure_loaded() -> None:
    import repro_torch.configs  # noqa: F401  (registers every config)


def get_arch(name: str) -> ModelConfig:
    """The full-size config of a registered architecture."""
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_smoke_arch(name: str) -> ModelConfig:
    """The reduced same-family config the CPU tests use."""
    _ensure_loaded()
    return _SMOKE[name]


def list_archs() -> List[str]:
    """The names of the registered architectures, sorted."""
    _ensure_loaded()
    return sorted(_REGISTRY)
