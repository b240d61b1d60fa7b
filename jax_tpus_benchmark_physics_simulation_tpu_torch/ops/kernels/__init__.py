"""Cell-grid geometry, the CUDA kernels (B1 cell forces, B2 rebuild
permutation) with their plain PyTorch versions, and the grid MD engine."""
