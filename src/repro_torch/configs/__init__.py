"""Model configurations: every served model is a ``ModelConfig`` in a registry."""
