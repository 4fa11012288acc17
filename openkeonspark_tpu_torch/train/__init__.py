"""Training: losses, sparse SGD, the step and the epoch loop."""
