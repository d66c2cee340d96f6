"""ScaleDoc on PyTorch and CUDA: the port of the ``repro`` JAX package.

The package mirrors ``repro``'s module paths (``repro_torch.core.trainer``
is ``repro.core.trainer``'s counterpart) and imports nothing of JAX or
of ``repro``. Its entry points run on the card (``device="cuda"``) unless
the caller passes ``device="cpu"``, where every kernel wrapper computes
its plain PyTorch version. The hand-written CUDA kernels live in
``csrc/`` and are built on first use (``repro_torch.kernels._build``).
"""
