"""Homomorphic compressed collectives: the compressed all-reduce with error
feedback, the bit-packed all-gather, stage-① gradient telemetry, and the
arithmetic of the int16 wire format; the peer exchanges of one mesh axis
(``all_to_all``, ``all_gather``, ``all_reduce``); and the collective
counters the dry run reads."""
from . import exchange, hom_collectives
from .exchange import all_gather, all_reduce, all_to_all
from .hom_collectives import (PSUM_CONTAINER_MAX, PerWorker, bit_budget,
                              compressed_psum_tree, init_residuals,
                              packed_allgather, stage1_stats, worst_case_psum)

__all__ = ["PSUM_CONTAINER_MAX", "PerWorker", "all_gather", "all_reduce",
           "all_to_all", "bit_budget", "compressed_psum_tree", "exchange",
           "hom_collectives", "init_residuals", "packed_allgather",
           "stage1_stats", "worst_case_psum"]
