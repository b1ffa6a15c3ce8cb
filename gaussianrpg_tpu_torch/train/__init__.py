"""Training: losses and the composite train step."""
