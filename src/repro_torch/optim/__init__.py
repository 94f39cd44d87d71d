"""AdamW (:mod:`.adamw`) and int8 error-feedback compression
(:mod:`.compress`) of the training path."""
