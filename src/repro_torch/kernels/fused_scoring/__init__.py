"""The fused proxy-scoring kernel (``csrc/fused_scoring.cu``)."""
