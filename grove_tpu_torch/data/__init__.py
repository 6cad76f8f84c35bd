"""Frame sampling and normalization constants (torch- and PIL-free)."""
