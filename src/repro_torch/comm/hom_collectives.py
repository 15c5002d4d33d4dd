"""Bit budget of the homomorphic compressed all-reduce.

The paper's stage-②/③ homomorphism (sums commute with quantization and
linear decorrelation) lets a gradient all-reduce add integer residuals hop
by hop and dequantize once at the end.  The wire container is int16, so each
worker's quantizer gets ``b = 15 - ceil(log2(world))`` magnitude bits and the
accumulator cannot overflow across the reduction; the audit's
``sharddisjoint`` analyzer sweeps that promise over every supported world
size.  This module holds that arithmetic; it is the same integers as the
reference's ``repro/comm/hom_collectives.py:35-52``.
"""
from __future__ import annotations

import math

#: largest magnitude an int16 psum accumulator may reach (the wire dtype's
#: positive range).  The audit's ``sharddisjoint`` collective sweep proves
#: :func:`worst_case_psum` stays under this for every supported world size.
PSUM_CONTAINER_MAX = 2**15 - 1


def bit_budget(world: int, container_bits: int = 16) -> int:
    """Per-worker magnitude bits so the psum cannot overflow the container.

    The ``max(2, ...)`` floor keeps the quantizer usable at absurd world
    sizes — which also means the overflow-freedom guarantee holds only up
    to ``world < 2**(container_bits - 3)`` (32768 for int16); the audit
    sweeps the supported range and documents the cliff.
    """
    return max(2, container_bits - 1 - math.ceil(math.log2(max(world, 1))))


def worst_case_psum(world: int, container_bits: int = 16) -> int:
    """Largest magnitude the compressed psum accumulator can reach: every
    worker contributing the clipping bound of its bit budget."""
    return world * (2 ** (bit_budget(world, container_bits) - 1) - 1)
