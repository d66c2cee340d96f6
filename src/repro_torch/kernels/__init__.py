"""Hand-written CUDA kernels, their wrappers and plain versions."""

# what an entry point taking the JAX package's ``interpret`` raises with
INTERPRET = ("interpret=True is Pallas interpret mode, which the port has "
             "no counterpart of; the tensors' device picks the CUDA kernel "
             "or the plain version (force_ref=True: the plain version)")
