"""nn.Modules of the bf16 inference path."""
