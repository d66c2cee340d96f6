"""The fused contrastive-loss kernel (``csrc/contrastive.cu``)."""
