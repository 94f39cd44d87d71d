"""The train step (:mod:`.steps`)."""
