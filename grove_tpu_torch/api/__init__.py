from .model import GroveForCausalLM  # noqa: F401
from .processor import GroveProcessor, DEFAULT_INSTRUCTION  # noqa: F401
