"""Entry points of the port: the allocator-as-a-service front end
(:mod:`.alloc_serve`) and the fleet gang-scheduling demo
(:mod:`.cluster_sim`)."""
