"""PyTorch/CUDA port of fedml_tpu for NVIDIA Hopper (H100).

The JAX package ``fedml_tpu`` is the reference; this package mirrors its
layout (``models``, ``ops``, ``serve``, ``obs``, ``core``) and imports
neither JAX nor ``fedml_tpu``. Entry points place their tensors on
``cuda`` unless the caller passes ``device="cpu"``.
"""
