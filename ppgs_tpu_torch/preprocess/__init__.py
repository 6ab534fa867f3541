from . import mel, w2v2fb


def get(representation: str):
    """Frontend for a representation. ``mel`` and ``w2v2fb`` are ported so
    far; the other frontends of the JAX package are queued in ROADMAP.md."""
    if representation == 'mel':
        return mel
    if representation == 'w2v2fb':
        return w2v2fb
    raise ValueError(
        f'Representation {representation!r} is not ported to ppgs_tpu_torch '
        f'yet (see ROADMAP.md); mel and w2v2fb are available')
