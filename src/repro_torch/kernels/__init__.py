"""Hand-written Hopper kernels (CUDA C++, ``csrc/``), their plain PyTorch
versions, and the device dispatch that chooses between them."""
