from . import notify, profiling
