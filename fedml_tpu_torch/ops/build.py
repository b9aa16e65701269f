"""Builds the port's CUDA kernels from ``ops/csrc`` at first use.

All sources go into ONE ``torch.utils.cpp_extension.load`` call: the
binding (``binding.cpp``) is the only file that includes PyTorch's
headers, and every ``.cu`` file exposes plain C++ launch functions, so
adding a kernel adds one fast ``nvcc`` compile rather than another copy
of the slow one. The build lands in ``ops/_build/`` (listed in
``.gitignore``) and is cached there by content.
"""

from __future__ import annotations

import glob
import os
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]


class _Extension:
    """The built module, once per process (the plane's batcher thread and
    the caller may both reach first use)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.module = None

    def get(self, verbose: bool = False):
        with self._lock:
            if self.module is None:
                from torch.utils.cpp_extension import load

                os.makedirs(BUILD_DIR, exist_ok=True)
                sources = sorted(glob.glob(os.path.join(CSRC, "*.cpp"))
                                 + glob.glob(os.path.join(CSRC, "*.cu")))
                self.module = load(name="fedml_tpu_torch_kernels",
                                   sources=sources,
                                   build_directory=BUILD_DIR,
                                   extra_cuda_cflags=CUDA_FLAGS,
                                   verbose=verbose)
            return self.module


_EXT = _Extension()


def extension(verbose: bool = False):
    """The compiled kernel module (builds it on the first call)."""
    return _EXT.get(verbose)

