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
import contextlib


class KernelError(RuntimeError):
    """A kernel failed to build or to launch, faulted on the device, or was
    given inputs it cannot take.  Never transient: the allocator's
    self-healing re-raises it instead of finishing the epoch on the host,
    so a broken kernel cannot pass for a working one."""


def row_major(t):
    """``t``, or a row-major copy of it where its strides are not the
    row-major ones (a custom op's CPU output must have the strides its
    fake output states; ``contiguous()`` keeps a size-1 dim's stride)."""
    import torch

    if t.stride() == torch.empty(t.shape, device="meta").stride():
        return t
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


_META_ROUTE = [False]


@contextlib.contextmanager
def meta_route():
    """For the duration, meta tensors take the card's route through K5's
    and K6's wrappers, to their custom ops' fake implementations: a dry
    run's trace on meta tensors (:func:`repro_torch.launch.dryrun.
    trace_cell`), which needs no ``FakeTensorMode``.  Outside it a meta
    tensor is refused, as any device but the CPU and CUDA."""
    old = _META_ROUTE[0]
    _META_ROUTE[0] = True
    try:
        yield
    finally:
        _META_ROUTE[0] = old


def route_devices() -> tuple:
    """The device types that take the card's route through K5's and K6's
    wrappers: CUDA, and meta inside :func:`meta_route`."""
    return ("cuda", "meta") if _META_ROUTE[0] else ("cuda",)
