"""PyTorch/CUDA port of ``pathtracing_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``models/``, ``utils/``) and never imports ``jax`` or anything
from ``pathtracing_tpu``. Plain tensor code is PyTorch; the TPU's Pallas
kernels become hand-written CUDA C++ kernels under ``csrc/``, built at
first use (``ops/cuda_build.py``).

Entry points run on the card (``torch.device("cuda")``) unless the caller
passes ``device="cpu"``; with no GPU and no explicit CPU request they
raise (``utils/config.resolve_device``).
"""
