"""Kernel inputs drawn with numpy and the tolerances they are held to,
shared by the CPU parity tests (test_torch_kernels.py,
test_torch_flash.py) and the card tests (test_torch_cuda.py)."""
import numpy as np
import torch

F32 = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels.py's f32 tolerance
# the contrastive losses are sums of up to n LSE terms of size 1/tau ~ 14;
# tests/test_kernels.py holds the Pallas kernel to its reference with this
LOSS = dict(rtol=1e-4, atol=1e-5)
# tests/test_kernels.py's flash attention tolerances
FLASH = {torch.float32: dict(rtol=2e-5, atol=2e-5),
         torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
# the bf16 tensor-core kernel against its plain version, which rounds at
# the same points (P to bf16 for P V, the output to bf16): the two differ
# in the order of f32 sums only, which can move a rounding by one bf16
# ulp; rtol 8e-3 covers one ulp (2^-7 relative at most) at every |out|,
# atol the outputs near zero
FLASH_BF16_PLAIN = dict(rtol=8e-3, atol=8e-3)


# fused scoring: every (H, L) pair the CUDA kernel takes, and document
# counts that cut its 64-row tile raggedly (the Pallas kernel's is 128)
FUSED_WIDTHS = [(h, l) for h in (64, 128, 256, 512)
                for l in (64, 128, 256, 512) if l <= h]
FUSED_RAGGED_N = (63, 65, 129)


def _t(x, device="cpu"):
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _t_misaligned(x, device="cpu"):
    """``_t(x)`` as a contiguous view whose data starts 4 bytes past the
    start of its (aligned) storage: the fused kernel's 4-byte-copy path."""
    x = np.asarray(x, np.float32)
    flat = torch.empty(x.size + 1, dtype=torch.float32, device=device)
    view = flat[1:].view(x.shape)
    view.copy_(torch.from_numpy(x))
    return view


def _contrastive_inputs(n, p, pos_frac, seed=0, q=None):
    rng = np.random.default_rng(seed)
    lead = () if q is None else (q,)
    zq = rng.normal(size=lead + (p,)).astype(np.float32)
    zd = rng.normal(size=lead + (n, p)).astype(np.float32)
    y = (rng.random(lead + (n,)) < pos_frac).astype(np.float32)
    return zq, zd, y


def _degenerate(case, zq, zd, y):
    if case == "all_pos":
        y[...] = 1.0
    elif case == "all_neg":
        y[...] = 0.0
    elif case == "tie":
        y[..., :4] = [1, 0, 1, 0]
        zd[..., 2, :] = zd[..., 0, :]     # tied weakest-positive candidates
        zd[..., 3, :] = zd[..., 1, :]     # tied hardest-negative candidates
        zq[...] = -zd[..., 0, :]          # pushes row 0 (and 2) to the min
    elif case == "tie_far":
        # tied bellwether candidates in different row blocks of the CUDA
        # kernel (8 anchor rows a block): rows 0 and 9, rows 1 and 17
        y[..., [0, 9]] = 1.0
        y[..., [1, 17]] = 0.0
        zd[..., 9, :] = zd[..., 0, :]
        zd[..., 17, :] = zd[..., 1, :]
        # pushes rows 0 and 9 toward the min, rows 1 and 17 to the max
        zq[...] = zd[..., 1, :] - zd[..., 0, :]
    elif case == "empty_u":
        # n = 2 with one positive: every anchor's U(i) is empty
        y[...] = 0.0
        y[..., 0] = 1.0
    return zq, zd, y


def _scoring_inputs(n, d, h, l, q, seed=0):
    rng = np.random.default_rng(seed)
    docs = rng.normal(size=(n, d)).astype(np.float32)
    ws = [(rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
          for s in [(d, h), (h, h), (h, l)]]
    bs = [(0.1 * rng.normal(size=s)).astype(np.float32) for s in (h, h, l)]
    zq = rng.normal(size=(q, l)).astype(np.float32)
    zq /= np.linalg.norm(zq, axis=1, keepdims=True)
    return docs, [ws[0], bs[0], ws[1], bs[1], ws[2], bs[2]], zq


def _attention_inputs(b, sq, skv, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, n, hd)).astype(np.float32)
            for s, n in ((sq, h), (skv, kv), (skv, kv))]
