"""Cell enumeration (``repro.configs.shapes``): (architecture x input
shape) with the reason a cell is skipped.

All 40 cells (10 architectures x ``ALL_SHAPES``) are enumerated;
``skip_reason`` names the cells left out (``long_500k`` for the pure
full-attention architectures and the encoder-decoder), with the JAX
package's reasons, word for word.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.config.base import ALL_SHAPES, InputShape
from repro_torch.config.registry import list_archs

# architectures allowed to run long_500k (sub-quadratic context handling)
LONG_OK = {
    "rwkv6-7b": "attention-free: O(1) decode state",
    "zamba2-2.7b": "hybrid: SSM state carries context; only 9 shared-attn "
                   "applications keep KV",
    "gemma3-12b": "5:1 local:global — only 8/48 layers keep full 500k KV "
                  "(window=1024 elsewhere)",
}

LONG_SKIP = {
    "smollm-360m": "pure full attention: 500k KV/layer unsupported by "
                   "assignment rules",
    "llama3-8b": "pure full attention",
    "codeqwen1.5-7b": "pure full attention (kv=32: 500k KV is 2x llama3 "
                      "per layer)",
    "dbrx-132b": "pure full attention MoE",
    "qwen3-moe-30b-a3b": "pure full attention MoE",
    "internvl2-1b": "pure full attention VLM backbone",
    "whisper-base": "enc-dec with 448-token decoder regime; full attention",
}


def skip_reason(arch: str, shape: InputShape) -> Optional[str]:
    if shape.name == "long_500k" and arch not in LONG_OK:
        return LONG_SKIP.get(arch, "pure full attention")
    return None


def cell_is_runnable(arch: str, shape: InputShape) -> bool:
    return skip_reason(arch, shape) is None


def arch_cells(arch: Optional[str] = None
               ) -> List[Tuple[str, InputShape, Optional[str]]]:
    """All 40 (arch, shape, skip_reason) cells (or one arch's 4)."""
    archs = [arch] if arch else list_archs()
    return [(a, s, skip_reason(a, s)) for a in archs for s in ALL_SHAPES]
