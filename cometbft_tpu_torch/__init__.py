"""PyTorch + CUDA port of cometbft_tpu's commit-verification path.

The JAX package ``cometbft_tpu`` stays the reference; this package
mirrors its module paths (``ops/``, ``crypto/``, ``types/``,
``utils/``) and imports neither JAX nor anything of ``cometbft_tpu``.

Entry points take a ``device`` argument and run on ``cuda`` by
default. Without a GPU they raise, unless the caller passes
``device="cpu"``: then every kernel wrapper runs its plain PyTorch
version instead (the CPU tests do this). The CUDA kernels live in
``csrc/`` and are built with nvcc at first use (``kernels.py``).
"""
