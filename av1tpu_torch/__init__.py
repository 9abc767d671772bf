"""av1tpu_torch: the av1tpu encoder ported to PyTorch and CUDA (NVIDIA H100).

Layout mirrors av1tpu/: ``ops`` (integer transforms), ``kernels`` (hand
CUDA kernels with their plain PyTorch versions; sources in ``csrc``),
``models`` (the intra/inter pipelines, loop filters, temporal filter,
probes), ``core`` (scene detection), ``metrics`` (PSNR) and ``cli``
(encode_clip and the command line).  ``state`` holds the device constants.
``spec`` (header and OBU writers, constant tables), ``coding`` (the ctypes
packer wrapper) and ``utils`` (clips and y4m IO) are the port's own copies
of the host-side code it needs from av1tpu.

Nothing here imports JAX or av1tpu: the one thing shared with the JAX
package is the C++ packer's source, native/coding/pack.cpp, which
``_build`` compiles into the port's own library.
"""

__version__ = "0.1.0"
