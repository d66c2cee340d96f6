"""Configuration dataclasses and the architecture registry.

Copies of ``repro.config.base``'s ``ModelConfig`` (with ``MoEConfig``,
``SSMConfig``, ``RWKVConfig`` and the block-kind constants),
``ProxyConfig``, ``CascadeConfig`` and ``OptimizerConfig`` (and its
``replace``), and of ``repro.config.registry``, kept here so the port
imports nothing of the JAX package. Field names and defaults are the
same, so a config of one package reads as a config of the other; the
offline store's ``config_digest`` hashes ``dataclasses.asdict`` of a
``ModelConfig`` and so depends on every field.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# model configuration
# ---------------------------------------------------------------------------

BLOCK_ATTN = "attn"            # full (causal) attention
BLOCK_LOCAL_ATTN = "local"     # sliding-window attention
BLOCK_MAMBA2 = "mamba2"        # Mamba2 / SSD block
BLOCK_RWKV6 = "rwkv6"          # RWKV6 (Finch) time-mix block
BLOCK_SHARED_ATTN = "shared"   # shared-weight attention block (Zamba2)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    num_shared_experts: int = 0
    router_aux_weight: float = 0.01

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64
    conv_width: int = 4
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per architecture."""
    name: str = "unnamed"
    family: str = "dense"        # dense | moe | hybrid | ssm | audio | vlm

    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    d_ff: int = 512
    vocab_size: int = 1024
    head_dim: int = 0            # 0 -> d_model // num_heads

    block_pattern: Tuple[str, ...] = (BLOCK_ATTN,)
    sliding_window: int = 0      # window for BLOCK_LOCAL_ATTN layers

    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    rwkv: RWKVConfig = field(default_factory=RWKVConfig)

    encoder_layers: int = 0
    encoder_d_ff: int = 0
    frontend: str = "none"

    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    act: str = "silu"            # mlp activation
    dtype: str = "bfloat16"      # activation/param dtype

    remat: str = "full"
    scan_layers: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded to a multiple of 256, as the JAX package pads it."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0


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


# ---------------------------------------------------------------------------
# proxy, optimizer and cascade
# ---------------------------------------------------------------------------


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
