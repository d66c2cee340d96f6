"""WKV6 inputs drawn with numpy, shared by the CPU parity tests
(test_torch_wkv6.py) and the card tests (test_torch_cuda.py): the
distribution of tests/test_kernels.py's WKV6 tests."""
import numpy as np


def wkv6_sequence(b, s, h, k, seed=0):
    """r, k, v (b, s, h, k) at scale 0.5, lw = -exp(2N - 1), u (h, k) at
    0.3, all float32."""
    rng = np.random.default_rng(seed)
    r, kk, v = ((0.5 * rng.normal(size=(b, s, h, k))).astype(np.float32)
                for _ in range(3))
    lw = -np.exp(2.0 * rng.normal(size=(b, s, h, k)) - 1.0).astype(
        np.float32)
    u = (0.3 * rng.normal(size=(h, k))).astype(np.float32)
    return r, kk, v, lw, u


def wkv6_inputs(b, nc, q, h, k, seed=0, extreme=False):
    """Chunked kernel inputs (r, k, v, cum, lw, u): (b, nc, q, h, k) and
    u (h, k), cum the within-chunk cumsum of lw; ``extreme`` sets lw to
    -200 (tests/test_kernels.py:213)."""
    r, kk, v, lw, u = wkv6_sequence(b, nc * q, h, k, seed)
    r, kk, v, lw = (x.reshape(b, nc, q, h, k) for x in (r, kk, v, lw))
    if extreme:
        lw = np.full_like(lw, -200.0)
    cum = np.cumsum(lw, axis=2, dtype=np.float32)
    return r, kk, v, cum, lw, u
