"""Configuration dataclasses of the proxy, its optimizer and the cascade.

Copies of ``repro.config.base``'s ``ProxyConfig``, ``CascadeConfig`` and
``OptimizerConfig`` (and its ``replace``), kept here so the port imports
nothing of the JAX package. Field names and defaults are the same, so a
config of one package reads as a config of the other.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"     # cosine | linear | constant
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


@dataclass(frozen=True)
class ProxyConfig:
    """ScaleDoc's lightweight query-aware encoder (paper §3, §5)."""
    embed_dim: int = 4096        # D: LLM embedding dim (NvEmbed = 4096)
    hidden_dim: int = 512        # MLP hidden
    latent_dim: int = 128        # l: shared latent space
    proj_dim: int = 64           # projector head (discarded at inference)
    num_layers: int = 3          # "3-layer perceptron" per paper §5
    temperature: float = 0.07    # tau
    lambda_supcon: float = 0.2   # lambda balancing L_supcon vs L_polar
    phase1_steps: int = 60
    phase2_steps: int = 60
    batch_size: int = 128        # docs per contrastive mini-batch
    lr: float = 1e-3
    train_fraction: float = 0.10   # paper: 10% sampled for training
    rebalance: bool = True         # fallback-style rebalancing (paper §5)
    rebalance_min_frac: float = 0.25
    rebalance_noise: float = 0.05
    aug_noise: float = 0.05        # Gaussian embedding augmentation per batch
    weight_decay: float = 0.01
    qsim_variant: str = "perpos"   # "perpos" (DPR form) | "sum" (literal eq.1)
    seed: int = 0


@dataclass(frozen=True)
class CascadeConfig:
    """ScaleDoc's adaptive cascade (paper §4, §5).

    ``use_margin`` is the deprecated spelling of
    ``margin_mode="bernstein"``: it is folded into ``margin_mode`` and
    normalized back to None, as in the JAX package.
    """
    accuracy_target: float = 0.90
    num_bins: int = 64           # discretization granularity (paper §5)
    calib_fraction: float = 0.05  # calibration sample (paper: 5%)
    jitter_density: float = 0.01  # mass injected into empty bins
    ma_window: int = 5           # moving-average smoothing window
    metric: str = "f1"           # "f1" | "exact" (BARGAIN comparison)
    delta: float = 0.05          # confidence for the Bernstein margin
    margin_mode: str = "bootstrap"   # "none" | "bernstein" | "bootstrap"
    boot_samples: int = 64
    boot_conf: float = 0.95
    use_margin: Optional[bool] = None
    seed: int = 0

    def __post_init__(self):
        if self.use_margin is not None:
            warnings.warn(
                "CascadeConfig.use_margin is deprecated; use "
                "margin_mode='bernstein' instead", DeprecationWarning,
                stacklevel=3)
            if self.use_margin:
                object.__setattr__(self, "margin_mode", "bernstein")
            object.__setattr__(self, "use_margin", None)


def replace(cfg, **kw):
    """dataclasses.replace that tolerates nested dotted keys."""
    direct = {k: v for k, v in kw.items() if "." not in k}
    nested = {k: v for k, v in kw.items() if "." in k}
    out = dataclasses.replace(cfg, **direct) if direct else cfg
    for key, val in nested.items():
        head, rest = key.split(".", 1)
        sub = getattr(out, head)
        out = dataclasses.replace(out, **{head: replace(sub, **{rest: val})})
    return out
