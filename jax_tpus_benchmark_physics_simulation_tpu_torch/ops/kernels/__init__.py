"""The CUDA kernels with their plain PyTorch versions (B1 2D cell forces,
B2 2D rebuild permutation, B4/B5 3D cell forces, B6/B7 3D rebuild
permutation, B8 all-pairs LJ forces, B9 all-pairs gravity, B10 the
bandwidth op's copy), the grid MD engines ``GridMD`` and ``GridMD3``, and
the plain-PyTorch list paths (``neighbor_list``, ``cell_dense``)."""
