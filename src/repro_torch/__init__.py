"""PyTorch/CUDA port of :mod:`repro`, the Mesos-style fair allocator.

The JAX package ``repro`` stays the reference; this package imports
neither it nor JAX.  ``core`` holds the allocator stack (copies of the
reference's numpy modules, the torch epoch engine ``engine_torch``, the
online allocator and the discrete-event simulator); ``kernels`` holds the
hand-written Hopper kernels of the allocation epoch.  Entry points run on
the card (``device="cuda"``) unless the caller asks for the CPU.
"""
