"""Plain PyTorch oracles for every kernel of the entry point, under the
names of the reference's ``repro/kernels/ref.py``.

Each binds the plain version that sits beside its kernel; the CPU tests
hold them against the reference's oracles and Pallas kernels, and
``chip_smoke.py`` holds the kernels against them on the card.
"""
from __future__ import annotations

from .bitpack import pack_plain as pack_uniform
from .bitpack import unpack_plain as unpack_uniform
from .block_stats import block_stats_plain as block_stats
from .prefix_stats import prefix_stats2d_plain as prefix_stats2d
from .quant_lorenzo import quant_lorenzo2d_plain as quant_lorenzo2d
from .stencil_dq import grad2d_plain as stencil_dq_grad2d
from .stencil_dq import laplacian2d_plain as stencil_dq_laplacian2d

__all__ = ["block_stats", "pack_uniform", "prefix_stats2d", "quant_lorenzo2d",
           "stencil_dq_grad2d", "stencil_dq_laplacian2d", "unpack_uniform"]
