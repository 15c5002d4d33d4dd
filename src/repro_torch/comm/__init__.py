"""Homomorphic compressed collectives: the arithmetic of the wire format.

The collectives themselves (compressed psum, packed all-gather, stage-①
telemetry) come with the train step, their only other user."""
from . import hom_collectives
from .hom_collectives import PSUM_CONTAINER_MAX, bit_budget, worst_case_psum

__all__ = ["PSUM_CONTAINER_MAX", "bit_budget", "hom_collectives",
           "worst_case_psum"]
