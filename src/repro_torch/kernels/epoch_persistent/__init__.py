"""Persistent allocation-epoch kernel (CUDA C++, sm_90a)."""
