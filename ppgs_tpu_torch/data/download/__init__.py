from . import align
from .core import (
    ci_fmt,
    datasets,
    download_file,
    download_tarbz2,
    files_with_extension,
)
