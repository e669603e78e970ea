"""ergo_uvo_tpu_torch — the PyTorch / CUDA port of ``ergo_uvo_tpu``.

The port keeps the JAX package's module layout, function names, fixed shapes
and validity masks, so each module here is the counterpart of the module of the
same path under ``ergo_uvo_tpu/``.  Plain tensor code is eager PyTorch; the one
Pallas kernel of the JAX package (the fused descriptor distance + row top-2)
is a hand-written CUDA kernel under ``csrc/``, launched for CUDA tensors and
replaced by its plain PyTorch version for CPU tensors.

The port imports ``torch`` and numpy only: never ``jax`` and never
``ergo_uvo_tpu`` (whose ``__init__`` imports JAX).  Host-only modules it needs
(``config.py``, ``io/synthetic.py``) are carried as copies.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry (triangulation, the 8-point/4-point solvers, the Jacobi eigensolver,
# LMEDS thresholds) needs true float32 products, as `ergo_uvo_tpu/__init__.py`
# forces with `jax_default_matmul_precision="float32"`.  TF32 keeps ~3 decimal
# digits; the matmul flag defaults to False and cuDNN's to True, so pin both.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
