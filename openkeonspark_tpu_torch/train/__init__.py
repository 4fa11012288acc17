"""Training: losses, sparse optimizers, the step and the epoch loop."""
