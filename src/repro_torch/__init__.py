"""repro_torch: the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Mirrors ``src/repro/`` sub-path for sub-path. The scheduler the paper
studies (``core/``) and the architecture configs (``configs/``) are
mechanical copies of the JAX package's files, with ``repro.`` rewritten to
``repro_torch.`` and nothing else changed (tests/test_torch_imports.py
holds them identical). Models, kernels, serving and training are ported
to torch; every kernel on a ported path is written by hand for Hopper
(sm_90a), and training differentiates the plain paths behind the kernels
(``kernels/ops.py``).

The package imports ``torch`` and never ``jax`` or ``repro``.
"""

__version__ = "0.1.0"
