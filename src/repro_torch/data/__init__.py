"""The synthetic data pipeline: a copy of the reference's
``data/pipeline.py`` whose ``device_put_batch`` places a host batch on a
``DeviceMesh`` as DTensors (the reference's places it with JAX
shardings)."""
