"""Masked-argmin kernels of the allocation epoch's selects (Triton)."""
