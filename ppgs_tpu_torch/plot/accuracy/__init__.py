from .core import from_eval
