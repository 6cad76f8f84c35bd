"""Loading reference-named state dicts."""
