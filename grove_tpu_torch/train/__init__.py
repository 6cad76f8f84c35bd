"""Training: the freeze policy, the optimizer and the step function."""
