from .core import reallocate, regex, regex_find, shift, swap
from . import grid
