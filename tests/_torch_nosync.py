"""A ``TorchDispatchMode`` that refuses what a captured CUDA graph cannot
hold, shared by the port's tests of its device-resident loops."""
import torch
from torch.utils._python_dispatch import TorchDispatchMode


class NoSync(TorchDispatchMode):
    """Raises on the operations that make a CUDA stream wait for the host:
    reading a device scalar, and the two whose output size depends on the
    data.  With ``host_data``, also on a tensor made from host data
    (``torch.tensor``/``torch.as_tensor`` of a Python value): on the card
    that is a copy from pageable host memory, which a capture refuses."""

    REFUSED = (torch.ops.aten._local_scalar_dense.default,
               torch.ops.aten.nonzero.default,
               torch.ops.aten.masked_select.default)
    HOST_DATA = (torch.ops.aten.lift_fresh.default,)

    def __init__(self, host_data: bool = False):
        super().__init__()
        self.refused = self.REFUSED + (self.HOST_DATA if host_data else ())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.refused:
            raise AssertionError(f"{func} syncs the host")
        return func(*args, **(kwargs or {}))
