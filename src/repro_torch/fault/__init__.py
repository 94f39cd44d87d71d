"""The training runtime's fault hooks: a copy of the reference's
``fault/tolerance.py`` (it imports no JAX)."""
