"""Masked-argmin kernels of the allocation epoch's selects and the per-grant
pick (CUDA C++, ``csrc/argmin.cu``)."""
