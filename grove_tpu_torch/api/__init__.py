from .model import GroveForCausalLM  # noqa: F401
