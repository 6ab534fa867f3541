from . import accuracy
from .core import (
    from_file_to_file,
    from_files_to_files,
    from_ppg_to_image,
    from_ppg_to_image_file,
    from_ppg_to_video_file,
)
