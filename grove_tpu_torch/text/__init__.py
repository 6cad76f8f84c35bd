"""Prompt, packing, tagging and tokenizer host code: copies of
`grove_tpu/text/`, which the port may not import."""

from . import constants, conversation, tagging, prompts  # noqa: F401
