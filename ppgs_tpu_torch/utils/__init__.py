from . import notify
