"""Registered architectures (``repro.configs``): importing the package
registers each config module's ``FULL`` and ``SMOKE``. Ported so far:
the dense llama3-8b, smollm-360m, codeqwen1.5-7b and gemma3-12b (5:1
sliding-window and global attention), the vlm internvl2-1b (its vision
frontend stubbed: precomputed patch embeddings, as in the JAX package),
the attention-free rwkv6-7b and the MoE qwen3-moe-30b-a3b (128 experts,
top 8) and dbrx-132b (16 experts, top 4), and the hybrid zamba2-2.7b
(Mamba2 blocks and one shared attention block applied every sixth
layer), and the encoder-decoder whisper-base (its audio frontend
stubbed: precomputed frame embeddings, as in the JAX package).
``shapes`` enumerates the (architecture x input shape) cells, with the
reason a cell is skipped."""
from repro_torch.configs import (  # noqa: F401
    codeqwen15_7b,
    dbrx_132b,
    gemma3_12b,
    internvl2_1b,
    llama3_8b,
    qwen3_moe_30b_a3b,
    rwkv6_7b,
    smollm_360m,
    whisper_base,
    zamba2_27b,
)
from repro_torch.configs.shapes import (  # noqa: F401,E402
    arch_cells,
    cell_is_runnable,
    skip_reason,
)
