"""Training of the anomaly stack: losses, SGD with the poly schedule, the
train step with its non-finite guard, epoch checkpoints, and the weight
bridge from the JAX package."""
