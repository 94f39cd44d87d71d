"""Flash attention forward (K5; CUDA C++, sm_90a)."""
