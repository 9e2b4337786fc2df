"""PyTorch / CUDA port of ``porous_cfd_tpu``.

The package mirrors the JAX package's module layout (``data/``, ``physics/``,
``models/``, ``ops/``, ``train/``, ``pipelines/``) and holds each part of the
port to it in the CPU parity tests (``tests/test_torch_*.py``). It imports
``torch`` and numpy only: never JAX, flax, optax or ``porous_cfd_tpu``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``porous_cfd_tpu_torch.device.resolve_device``). The
hand-written CUDA kernels live in ``ops/csrc`` and are compiled with ``nvcc``
at first use into ``build/porous_cfd_tpu_torch/``.
"""
