"""Cell-grid geometry, the CUDA kernels with their plain PyTorch versions
(2D: B1 cell forces, B2 rebuild permutation; 3D: B4/B5 cell forces, B6/B7
rebuild permutation) and the grid MD engines ``GridMD`` and ``GridMD3``."""
