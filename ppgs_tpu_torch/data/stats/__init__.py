from .core import process
