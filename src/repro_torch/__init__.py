"""WindTunnel on PyTorch and CUDA: the port of the JAX package ``repro``.

Module names mirror ``repro`` so each counterpart is easy to find. The
package imports ``torch`` and numpy, never ``jax`` or ``repro``. Every
entry point takes a ``device``; it runs on the card unless the caller asks
for the CPU, where the plain PyTorch versions of the kernels run.
"""
