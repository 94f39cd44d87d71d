"""The distributed layer of the model substrate: logical-axis sharding
rules on a ``DeviceMesh`` (:mod:`.sharding`) and the per-architecture
strategy (:mod:`.strategy`)."""
