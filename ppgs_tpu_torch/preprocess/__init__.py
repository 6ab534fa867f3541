from . import mel


def get(representation: str):
    """Frontend for a representation. Only ``mel`` is ported so far; the
    other frontends of the JAX package are queued in ROADMAP.md."""
    if representation == 'mel':
        return mel
    raise ValueError(
        f'Representation {representation!r} is not ported to ppgs_tpu_torch '
        f'yet (see ROADMAP.md); only mel is available')
