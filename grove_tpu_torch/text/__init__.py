"""Prompt, packing and tagging host code: copies of `grove_tpu/text/`
(all but the tokenizer loaders), which the port may not import."""

from . import constants, conversation, tagging, prompts  # noqa: F401
