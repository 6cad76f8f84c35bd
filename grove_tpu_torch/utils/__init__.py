"""Training utilities: metric meters."""
