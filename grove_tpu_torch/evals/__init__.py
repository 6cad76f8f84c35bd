from . import anet, captions, iground, pointing, vidstg  # noqa: F401
