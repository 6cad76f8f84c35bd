"""Parallel training and inference: the ("data", "model") device mesh,
the partition rules and the GPipe pipeline (counterpart of
`grove_tpu/parallel/`)."""
