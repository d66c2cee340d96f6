"""Configuration dataclasses (``repro.config.base``).

Copies of ``repro.config.base``'s ``ModelConfig`` (with ``MoEConfig``,
``SSMConfig``, ``RWKVConfig``, the block-kind constants and the analytic
``param_count``/``active_param_count``), ``ProxyConfig``,
``CascadeConfig``, ``OptimizerConfig`` and ``replace``, kept here so the
port imports nothing of the JAX package. Field names and defaults are
the same, so ``dataclasses.asdict`` of a config of one package equals
that of the other; the offline store's ``config_digest`` hashes it and
so depends on every field.

``InputShape``, the four LM shapes (``TRAIN_4K``, ``PREFILL_32K``,
``DECODE_32K``, ``LONG_500K``, with ``ALL_SHAPES`` and
``SHAPES_BY_NAME``) and ``TrainConfig`` are copies too (the LM
trainer's, ``runtime.train_loop``); ``OptimizerConfig.compress_grads``
switches on ``optimizer.compression``. ``MeshConfig`` (with
``SINGLE_POD``, ``MULTI_POD`` and ``TEST_MESH``), ``ServeConfig`` and
``RunConfig`` are copies as well; ``launch.mesh`` makes a mesh of a
``MeshConfig``. ``ProxyConfig.contrastive_impl`` takes ``"auto"``, ``"kernel"``
and ``"ref"``, the proxy trainer's phase-2 forward
(``kernels.contrastive.ops.phase2_loss``): the device's choice, the
CUDA kernel (CPU latents raise), or the plain objective on any device;
``"interpret"`` (Pallas interpret mode) has no torch meaning and is
refused.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Optional, Tuple

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

    @property
    def attention_free(self) -> bool:
        return all(b in (BLOCK_MAMBA2, BLOCK_RWKV6)
                   for b in self.layer_kinds())

    def layer_kinds(self) -> Tuple[str, ...]:
        """``block_pattern`` tiled to ``num_layers`` entries."""
        pat = self.block_pattern
        reps = (self.num_layers + len(pat) - 1) // len(pat)
        return tuple((pat * reps)[: self.num_layers])

    def param_count(self) -> int:
        """Analytic parameter count, the JAX package's formula (it counts
        ``vocab_size``, not the padded vocabulary the params hold)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d

        def attn_params() -> int:
            return d * nq * hd + 2 * d * nkv * hd + nq * hd * d

        def mlp_params(ff: int) -> int:
            return 3 * d * ff  # gated: up, gate, down

        def moe_params() -> int:
            e = self.moe.num_experts
            return e * mlp_params(f) + d * e  # experts + router

        def mamba_params() -> int:
            di = self.ssm.expand * d
            nh = di // self.ssm.head_dim
            # in_proj (z, x, B, C, dt) + out_proj + conv + A, D
            return (d * (2 * di + 2 * self.ssm.state_dim * nh + nh)
                    + di * d + self.ssm.conv_width * di + 2 * nh)

        def rwkv_params() -> int:
            # r, k, v, g, o projections + decay/lora + channel-mix (k, r, v)
            return 5 * d * d + 2 * d * 64 + (d * int(3.5 * d) * 2 + d * d)

        shared_counted = False
        for k in self.layer_kinds():
            total += 2 * d  # norms
            if k in (BLOCK_ATTN, BLOCK_LOCAL_ATTN):
                total += attn_params()
                total += moe_params() if self.moe.enabled else mlp_params(f)
            elif k == BLOCK_SHARED_ATTN:
                if not shared_counted:
                    total += attn_params() + mlp_params(f)
                    shared_counted = True
            elif k == BLOCK_MAMBA2:
                total += mamba_params()
            elif k == BLOCK_RWKV6:
                total += rwkv_params()
        if self.is_encdec:
            ef = self.encoder_d_ff or f
            per_enc = attn_params() + mlp_params(ef) + 2 * d
            total += self.encoder_layers * per_enc
            total += self.num_layers * attn_params()  # cross-attention
        return total

    def active_param_count(self) -> int:
        """Parameters a token runs through (MoE: its top_k experts)."""
        if not self.moe.enabled:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        e, k = self.moe.num_experts, self.moe.top_k
        inactive = (e - k) * 3 * d * f * len(
            [b for b in self.layer_kinds()
             if b in (BLOCK_ATTN, BLOCK_LOCAL_ATTN)])
        return self.param_count() - inactive


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
    # int8 gradient compression (error feedback) for the DP all-reduce
    compress_grads: bool = False


# ---------------------------------------------------------------------------
# mesh / distribution
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes


SINGLE_POD = MeshConfig(shape=(16, 16), axes=("data", "model"))
MULTI_POD = MeshConfig(shape=(2, 16, 16), axes=("pod", "data", "model"))
# the one-device mesh of the CPU tests and of one card
TEST_MESH = MeshConfig(shape=(1, 1), axes=("data", "model"))


# ---------------------------------------------------------------------------
# input shapes (the four assigned LM shapes) and LM training
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclass(frozen=True)
class TrainConfig:
    shape: InputShape = TRAIN_4K
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    microbatch: int = 0          # 0 = no gradient accumulation
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    seed: int = 0


@dataclass(frozen=True)
class ServeConfig:
    """A serving cell: its shape and largest batch. ``decode_attention``
    ("gspmd" | "flash_shmap": the JAX package's decode strategies, the
    latter sequence-sharded flash-decoding) is accepted, so that the JAX
    package's configs construct, and ignored: no caller of the port
    reads it, whose decode attention is its one plain path
    (``models.attention.attn_decode``)."""
    shape: InputShape = DECODE_32K
    decode_attention: str = "gspmd"
    max_batch: int = 128


CONTRASTIVE_IMPLS = ("auto", "kernel", "ref")


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
    # phase-2 loss forward (kernels.contrastive.ops.phase2_loss's impl):
    # "auto" (the device's choice) | "kernel" | "ref"; "interpret" is
    # refused
    contrastive_impl: str = "auto"
    seed: int = 0

    def __post_init__(self):
        if self.contrastive_impl == "interpret":
            raise ValueError(
                "ProxyConfig.contrastive_impl='interpret' is Pallas "
                "interpret mode, which the port has no counterpart of; "
                f"use one of {CONTRASTIVE_IMPLS} (the tensors' device "
                "picks the CUDA kernel or the plain version)")
        if self.contrastive_impl not in CONTRASTIVE_IMPLS:
            raise ValueError(f"unknown contrastive_impl "
                             f"{self.contrastive_impl!r}; one of "
                             f"{CONTRASTIVE_IMPLS}")


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


@dataclass(frozen=True)
class RunConfig:
    """Top-level config: one run of the framework."""
    arch: str = "smollm-360m"
    model: ModelConfig = field(default_factory=ModelConfig)
    mesh: MeshConfig = SINGLE_POD
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    proxy: ProxyConfig = field(default_factory=ProxyConfig)
    cascade: CascadeConfig = field(default_factory=CascadeConfig)


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
