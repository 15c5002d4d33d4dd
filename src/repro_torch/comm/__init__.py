"""Homomorphic compressed collectives: the compressed all-reduce with error
feedback, the bit-packed all-gather, stage-① gradient telemetry, and the
arithmetic of the int16 wire format."""
from . import hom_collectives
from .hom_collectives import (PSUM_CONTAINER_MAX, PerWorker, bit_budget,
                              compressed_psum_tree, init_residuals,
                              packed_allgather, stage1_stats, worst_case_psum)

__all__ = ["PSUM_CONTAINER_MAX", "PerWorker", "bit_budget",
           "compressed_psum_tree", "hom_collectives", "init_residuals",
           "packed_allgather", "stage1_stats", "worst_case_psum"]
