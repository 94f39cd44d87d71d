"""Entry points of the port: the allocator-as-a-service front end
(:mod:`.alloc_serve`), the fleet gang-scheduling demo (:mod:`.cluster_sim`),
the model serve (:mod:`.serve`) and the paper's drivers
(:mod:`.paper_tables`, :mod:`.paper_figures`, :mod:`.fig9_adaptation`)."""
