"""Chunked WKV6 recurrence of RWKV6 (K6; CUDA C++, sm_90a)."""
