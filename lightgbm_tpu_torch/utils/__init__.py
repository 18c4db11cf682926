from . import log  # noqa: F401
