"""PyTorch / CUDA port of the HSZ homomorphic-compression system.

A second package beside the JAX reference ``repro``: it imports torch and
numpy only.  Entry points make their tensors on the card (``device="cuda"``)
unless the caller asks for the CPU; on a CUDA tensor the hot path runs the
hand-written Hopper kernels in ``repro_torch.kernels``, on a CPU tensor their
plain PyTorch versions.
"""
