"""Completion/failure webhook notifications.

Equivalent of the reference's ``@torchutil.notify`` decorators (reference
ppgs/train/core.py:17, ppgs/preprocess/core.py:16, ppgs/evaluate/core.py:15,
ppgs/data/download/core.py:15): long-running jobs POST a message to the URL
in the ``PPGS_NOTIFICATION_URL`` environment variable when they finish or
fail. No-op when the variable is unset; delivery failures never interrupt
the job.
"""

import functools
import json
import os
import time
import urllib.request

ENV_VAR = 'PPGS_NOTIFICATION_URL'


def send(message: str, url: str = None) -> bool:
    """POST {"text": message} as JSON; returns True when delivered."""
    url = url or os.environ.get(ENV_VAR)
    if not url:
        return False
    try:
        request = urllib.request.Request(
            url,
            data=json.dumps({'text': message}).encode(),
            headers={'Content-Type': 'application/json'})
        urllib.request.urlopen(request, timeout=10)
        return True
    except Exception:
        return False


def notify(name: str):
    """Decorator: send a message when the wrapped job completes or raises."""
    def decorator(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            start = time.time()
            try:
                result = fn(*args, **kwargs)
            except Exception as error:
                send(f'{name} failed after {time.time() - start:.0f}s: '
                     f'{type(error).__name__}: {error}')
                raise
            send(f'{name} finished in {time.time() - start:.0f}s')
            return result
        return wrapped
    return decorator
