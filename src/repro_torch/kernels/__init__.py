"""Hand-written Hopper kernels of the port.

Each kernel package holds the kernel (CUDA C++, ``csrc/*.cu``), its wrapper ``ops.py`` (plain version for CPU tensors,
kernel launch for CUDA tensors, a launch count) and its plain PyTorch
version ``ref.py``:

  psdsf_score      — masked argmins of the epoch's selects (K1, K2) and the
                     fused per-grant PS-DSF pick (K4; CUDA C++)
  epoch_persistent — the whole epoch segment in one launch (K3; CUDA C++)
  flash_attention  — the dense LMs' prefill attention (K5; CUDA C++)
  rwkv6            — RWKV6's chunked WKV recurrence (K6; CUDA C++)
"""


class KernelError(RuntimeError):
    """A kernel failed to build or to launch, faulted on the device, or was
    given inputs it cannot take.  Never transient: the allocator's
    self-healing re-raises it instead of finishing the epoch on the host,
    so a broken kernel cannot pass for a working one."""
