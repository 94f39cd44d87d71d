"""The synthetic data pipeline: a copy of the reference's
``data/pipeline.py`` without ``device_put_batch`` (JAX shardings; it goes
with the distributed slice)."""
