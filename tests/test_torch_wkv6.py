"""Port parity of the WKV6 recurrence (``repro_torch.kernels.wkv6``).

On the CPU the port's ``wkv6_intra_chunk`` computes its plain version;
it is held against the JAX package's Pallas kernel in interpret mode, as
tests/test_kernels.py runs it, on all four outputs and the same numpy
inputs. ``ops.wkv6`` (kernel, then the inter-chunk combine) is held
against the JAX sequential ``ref_wkv6`` and the JAX ``wkv6`` in
interpret mode. The CUDA kernel itself is held against the plain
version on the card by test_torch_cuda.py. Tolerance: 1e-5 of max |ref|
in float32, tests/test_kernels.py's bar for the Pallas kernel.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import ref as j_ref
from repro.kernels.wkv6.ops import wkv6 as j_wkv6
from repro.kernels.wkv6.wkv6 import wkv6_intra_chunk as j_intra
from repro_torch.kernels.wkv6 import ops, ref
from torch_wkv6_inputs import wkv6_inputs, wkv6_sequence
from torch_jax_state import no_jax_constrainer  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5


def _rel_err(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


# (b, nc, Q, H, K): tests/test_kernels.py's three wkv6 shapes as the
# chunker cuts them (s=64 chunk 16, s=96 chunk 32, s=40 chunk 16 -> Q=10),
# the rwkv6-7b head at a full chunk, a ragged chunk, and Q=1
INTRA_SHAPES = [(2, 4, 16, 2, 16), (1, 3, 32, 4, 32), (2, 4, 10, 2, 16),
                (1, 1, 128, 1, 64), (1, 2, 100, 2, 64), (1, 5, 1, 2, 16)]


@pytest.mark.parametrize("shape", INTRA_SHAPES)
@pytest.mark.parametrize("decay", ["random", "extreme"])
def test_plain_intra_chunk_matches_pallas(shape, decay):
    """All four outputs; "extreme" is lw = -200 everywhere
    (tests/test_kernels.py:213), where only exponents of differences
    stay finite."""
    args = wkv6_inputs(*shape, seed=sum(shape), extreme=decay == "extreme")
    # JAX on its own copies of the inputs, finished before the port runs
    want = [np.asarray(w) for w in
            j_intra(*map(jnp.array, args), interpret=True)]
    before = ops.KERNEL.launches
    got = ops.wkv6_intra_chunk(*map(torch.tensor, args))
    assert ops.KERNEL.launches == before          # the CPU never launches
    names = ("y_intra", "s_inj", "a_end", "r_dec")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, w) < REL, (name, _rel_err(g, w))


@functools.lru_cache(maxsize=None)
def _pallas_intra(shape, decay):
    """The Pallas kernel's four outputs (interpret mode) on the inputs of
    ``shape`` and ``decay``, as numpy arrays."""
    args = wkv6_inputs(*shape, seed=sum(shape), extreme=decay == "extreme")
    return [np.asarray(w) for w in
            j_intra(*map(jnp.array, args), interpret=True)]


@pytest.mark.parametrize("shape", INTRA_SHAPES)
@pytest.mark.parametrize("decay", ["random", "extreme"])
def test_sub_chunk_form_matches_pallas(shape, decay):
    """The CUDA kernel's plain version (``sub=ref.SUB``): all four
    outputs, against the Pallas kernel in interpret mode."""
    args = wkv6_inputs(*shape, seed=sum(shape), extreme=decay == "extreme")
    got = ref.wkv6_intra_chunk(*map(torch.tensor, args), sub=ref.SUB)
    names = ("y_intra", "s_inj", "a_end", "r_dec")
    for name, g, w in zip(names, got, _pallas_intra(shape, decay)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, w) < REL, (name, _rel_err(g, w))


@pytest.mark.parametrize("shape", INTRA_SHAPES + [(1, 2, 37, 2, 16)])
@pytest.mark.parametrize("decay", ["random", "extreme"])
def test_sub_chunk_form_matches_the_pairwise_form(shape, decay):
    """``sub=16`` against ``sub=None`` (one exponential per term), all
    four outputs, also at a chunk of three sub-chunks, the last ragged."""
    args = [torch.tensor(a) for a in
            wkv6_inputs(*shape, seed=sum(shape), extreme=decay == "extreme")]
    got = ref.wkv6_intra_chunk(*args, sub=16)
    want = ref.wkv6_intra_chunk(*args, sub=None)
    for name, g, w in zip(("y_intra", "s_inj", "a_end", "r_dec"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        assert _rel_err(g, w) < REL, (name, _rel_err(g, w))


@pytest.mark.parametrize("b,s,H,K,chunk", [(1, 64, 2, 16, 64),
                                           (2, 48, 2, 16, 48),
                                           (1, 37, 2, 16, 128)])
def test_kernel_mode_on_cpu_matches_jax_sequential(b, s, H, K, chunk):
    """``ops.wkv6`` on the CPU, the sub-chunk form, over chunks of two to
    four sub-chunks (the last ragged at 48 and 37) against JAX's
    sequential ``ref_wkv6``. Chunks this short keep the rounding of the
    within-chunk cumsum, which the chunked forms share, below the bar."""
    r, k, v, lw, u = wkv6_sequence(b, s, H, K, seed=s + K)
    got = ops.wkv6(*map(torch.tensor, (r, k, v, lw, u)), chunk=chunk)
    want = j_ref.ref_wkv6(*map(jnp.asarray, (r, k, v, lw, u)))
    assert got.shape == (b, s, H, K) and torch.isfinite(got).all()
    assert _rel_err(got, want) < REL


@pytest.mark.parametrize("b,s,H,K", [(1, 256, 2, 16), (2, 200, 2, 32)])
def test_kernel_mode_on_cpu_matches_direct_at_the_default_chunk(b, s, H, K):
    """At the default chunk of 128 (s=200: two chunks of 100) the
    cumsum's rounding moves every chunked form from the sequential
    recurrence, and torch's cumsum from jnp's, by ~2e-5; on one cumsum
    the two intra-chunk arithmetics, ``ops.wkv6`` (``sub=16``) and the
    direct scan (``sub=None``), agree to the bar."""
    args = [torch.tensor(a) for a in wkv6_sequence(b, s, H, K, seed=s + K)]
    assert _rel_err(ops.wkv6(*args), ref.wkv6_by_chunks(*args)) < REL


@pytest.mark.parametrize("b,s,H,K,chunk", [(2, 64, 2, 16, 16),
                                           (1, 96, 4, 32, 32),
                                           (2, 40, 2, 16, 16),
                                           (1, 37, 2, 16, 128)])
def test_wkv6_matches_jax_sequential_and_pallas(b, s, H, K, chunk):
    """tests/test_kernels.py's shapes, plus a prime length that the
    default chunk of 128 takes whole; and the plain scan (the time-mix's
    direct mode) on the same inputs."""
    r, k, v, lw, u = wkv6_sequence(b, s, H, K, seed=s)
    jargs = [jnp.asarray(a) for a in (r, k, v, lw, u)]
    targs = [torch.tensor(a) for a in (r, k, v, lw, u)]
    got = ops.wkv6(*targs, chunk=chunk)
    assert got.shape == (b, s, H, K)
    assert _rel_err(got, j_ref.ref_wkv6(*jargs)) < REL
    assert _rel_err(got, j_wkv6(*jargs, chunk=chunk, interpret=True)) < REL
    plain = ref.wkv6_by_chunks(*targs, chunk=chunk)
    assert _rel_err(plain, j_ref.ref_wkv6(*jargs)) < REL


def test_wkv6_extreme_decay_matches_jax():
    """tests/test_kernels.py:213's case through the whole recurrence."""
    b, s, H, K = 1, 32, 1, 16
    r = np.full((b, s, H, K), 0.3, np.float32)
    v = np.random.default_rng(0).normal(size=(b, s, H, K)).astype(np.float32)
    lw = np.full((b, s, H, K), -200.0, np.float32)
    u = np.zeros((H, K), np.float32)
    got = ops.wkv6(*map(torch.tensor, (r, r, v, lw, u)), chunk=16)
    assert torch.isfinite(got).all()
    want = j_ref.ref_wkv6(*map(jnp.asarray, (r, r, v, lw, u)))
    assert _rel_err(got, want) < REL


def test_port_sequential_ref_matches_jax():
    r, k, v, lw, u = wkv6_sequence(2, 24, 3, 16, seed=5)
    got = ref.ref_wkv6(*map(torch.tensor, (r, k, v, lw, u)))
    want = j_ref.ref_wkv6(*map(jnp.asarray, (r, k, v, lw, u)))
    assert _rel_err(got, want) < REL


@pytest.mark.parametrize("s,want", [(512, 128), (200, 100), (40, 40),
                                    (131, 1), (1, 1), (256, 128)])
def test_chunk_len_follows_jax(s, want):
    """min(chunk, s), decremented until it divides s (rwkv.py:124-126,
    ops.py:18-22)."""
    assert ref.chunk_len(s) == want


def test_wrapper_checks_refuse_what_the_kernel_does_not_take():
    """The checks the wrapper runs before a launch, on CPU tensors (the
    card's tests hold the same refusals through the launch path)."""
    def args(shape=(1, 2, 16, 2, 16), dtype=torch.float32):
        x = torch.zeros(shape, dtype=dtype)
        return [x, x, x, x, x, torch.zeros(shape[3:], dtype=dtype)]
    ops._check(*args())
    ops._check(*args((1, 1, 128, 1, 64)))
    with pytest.raises(ValueError, match="head_dim"):
        ops._check(*args((1, 1, 16, 1, 80)))
    with pytest.raises(ValueError, match="chunk length"):
        ops._check(*args((1, 1, 129, 1, 16)))
    with pytest.raises(TypeError):
        ops._check(*args(dtype=torch.bfloat16))
    a = args()
    a[2] = torch.zeros((1, 2, 16, 16, 2)).transpose(3, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(*a)
    a = args()
    a[5] = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="u "):
        ops._check(*a)
