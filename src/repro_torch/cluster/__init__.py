"""Fleet-level use of the allocator: fair gang scheduling of jobs onto
slices (:mod:`.gang`)."""
