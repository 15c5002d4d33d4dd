"""Hand-written Hopper kernels (CUDA C++, ``csrc/``), their plain PyTorch
versions, and the device dispatch that chooses between them.

The seven public wrappers below are the counterpart of the reference's
kernel entry point (``repro.kernels``), with its argument order and return
types; :mod:`.ref` binds their plain versions under the reference's oracle
names.  A CPU tensor runs the plain version, a CUDA tensor the kernel.
"""
from .bitpack import pack, unpack
from .block_stats import block_stats
from .prefix_stats import prefix_stats2d
from .quant_lorenzo import quant_lorenzo2d
from .stencil_dq import grad2d, laplacian2d

__all__ = ["block_stats", "grad2d", "laplacian2d", "pack", "prefix_stats2d",
           "quant_lorenzo2d", "unpack"]
