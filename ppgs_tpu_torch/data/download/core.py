"""Dataset download/format orchestration
(reference: ppgs/data/download/core.py:16-66).

A copy of the JAX package's. Host-side only. Network helpers use urllib;
the Common Voice Google Drive path additionally needs the optional gdown
package. Nothing is fetched unless ``datasets`` is called without
``format_only``.
"""

import tarfile
import tempfile
import urllib.request
import zipfile
from pathlib import Path

from ... import config as config_mod
from ...utils import notify as _notify_mod


@_notify_mod.notify("download")
def datasets(names=None, format_only=False, config=None):
    """Download and/or format datasets into the cache."""
    from .. import datasets as datasets_mod

    config = config_mod.get(config)
    names = names or list(config.datasets)
    for name in (n.lower() for n in names):
        if not hasattr(datasets_mod, name):
            raise ValueError(f'Dataset {name} does not exist')
        module = getattr(datasets_mod, name)
        if not format_only:
            module.download()
        module.format()


###############################################################################
# Utilities
###############################################################################


def ci_fmt(fragment):
    """Case-insensitive glob fragment"""
    return ''.join(f'[{c}{c.upper()}]' for c in fragment.lower())


def files_with_extension(ext, path):
    return list(Path(path).rglob(f'*.{ci_fmt(ext)}'))


def download_file(url, path):
    """Download a file over HTTP(S)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with urllib.request.urlopen(url) as response, open(path, 'wb') as out:
        while True:
            chunk = response.read(1 << 20)
            if not chunk:
                break
            out.write(chunk)
    return path


def download_tarbz2(url, directory):
    """Download and extract a .tar.bz2 archive."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(suffix='.tar.bz2') as tmp:
        download_file(url, tmp.name)
        with tarfile.open(tmp.name, 'r:bz2') as archive:
            archive.extractall(directory)


def download_google_drive_zip(url, path, skip_first=True):
    """Download a zip from Google Drive, extract flat into path (needs
    the optional gdown package, as in the reference)."""
    try:
        import gdown
    except ImportError as error:
        raise ImportError(
            "The 'gdown' package is required for Google Drive downloads: "
            'pip install gdown') from error

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(suffix='.zip') as tmp:
        gdown.download(url, tmp.name)
        with zipfile.ZipFile(tmp.name) as archive:
            infos = archive.infolist()[1 if skip_first else 0:]
            for info in infos:
                name = Path(info.filename).name
                with archive.open(info) as src, \
                        open(path / name, 'wb') as dst:
                    dst.write(src.read())
