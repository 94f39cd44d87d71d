"""Hand-written Hopper kernels of the allocation epoch.

Each kernel package holds the kernel (Triton ``kernel.py`` or CUDA
``csrc/*.cu``), its wrapper ``ops.py`` (plain version for CPU tensors,
kernel launch for CUDA tensors, a launch count) and its plain PyTorch
version ``ref.py``:

  psdsf_score      — masked argmins of the epoch's selects (K1, K2; Triton)
  epoch_persistent — the whole epoch segment in one launch (K3; CUDA C++)
"""


class KernelError(RuntimeError):
    """A kernel failed to build or to launch, faulted on the device, or was
    given inputs it cannot take.  Never transient: the allocator's
    self-healing re-raises it instead of finishing the epoch on the host,
    so a broken kernel cannot pass for a working one."""
