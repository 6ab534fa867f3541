"""PPG visualization (reference: ppgs/plot/core.py:24-575); the
counterpart of ``ppgs_tpu/plot/core.py``.

PPG -> pixel image with phoneme-row labels; optional overlays: a TextGrid
alignment rendered as a green one-hot trace, or a second PPG in blue.
Drawing is host work on numpy arrays: PIL draws the images, cv2 (and
ffmpeg, when it is on the PATH) the scrolling video, each imported only
when called. A PPG plotted from audio is inferred by the port's
``from_file`` on ``device``, the card unless the caller names the CPU.
"""

from itertools import repeat
from pathlib import Path
from typing import List, Optional

import numpy as np

from .. import config as config_mod
from ..phonemes import PHONEMES, PHONEME_TO_INDEX_MAPPING, SILENCE

# Pixels per frame and per phoneme row
CELL_WIDTH = 4
CELL_HEIGHT = 12
LABEL_WIDTH = 36


def _ppg_to_pixels(ppg):
    """(40, T) probabilities -> (40, T) uint8 intensity (white=1)."""
    ppg = np.asarray(ppg, dtype=np.float32)
    return (np.clip(ppg, 0.0, 1.0) * 255).astype(np.uint8)


def _textgrid_to_onehot(textgrid_file, frames, config):
    """Alignment -> (40, T) one-hot at frame centers."""
    from ..data.textgrid import Alignment

    alignment = Alignment(textgrid_file)
    for word in alignment.words():
        for phoneme in word:
            if phoneme.phoneme == '[SIL]':
                phoneme.phoneme = SILENCE
            else:
                phoneme.phoneme = phoneme.phoneme.lower()
    hopsize = config.hopsize / config.sample_rate
    times = np.arange(frames) * hopsize + hopsize / 2
    indices = alignment.framewise_phoneme_indices(
        PHONEME_TO_INDEX_MAPPING, hopsize, times)
    onehot = np.zeros((len(PHONEMES), frames), dtype=np.uint8)
    onehot[indices, np.arange(frames)] = 255
    return onehot


def combine_pixels(primary, overlay_green=None, overlay_blue=None):
    """Compose channel images: primary in white, overlays in green/blue."""
    h, w = primary.shape
    rgb = np.stack([primary, primary, primary], axis=-1)
    if overlay_green is not None:
        rgb[..., 1] = np.maximum(rgb[..., 1], overlay_green)
    if overlay_blue is not None:
        rgb[..., 2] = np.maximum(rgb[..., 2], overlay_blue)
    return rgb


def from_ppg_to_image(ppg, second_ppg=None, textgrid_file=None, config=None):
    """Render a (40, T) PPG to a PIL Image with phoneme labels."""
    from PIL import Image, ImageDraw

    config = config_mod.get(config)
    ppg = np.asarray(ppg)
    frames = ppg.shape[-1]

    green = (_textgrid_to_onehot(textgrid_file, frames, config)
             if textgrid_file is not None else None)
    blue = (_ppg_to_pixels(second_ppg)
            if second_ppg is not None else None)
    rgb = combine_pixels(_ppg_to_pixels(ppg), green, blue)

    # Upscale cells (nearest)
    rgb = np.repeat(np.repeat(rgb, CELL_HEIGHT, axis=0), CELL_WIDTH, axis=1)
    image = Image.new(
        'RGB', (LABEL_WIDTH + rgb.shape[1], rgb.shape[0]), 'black')
    image.paste(Image.fromarray(rgb), (LABEL_WIDTH, 0))

    draw = ImageDraw.Draw(image)
    for i, phoneme in enumerate(PHONEMES):
        label = 'sil' if phoneme == SILENCE else phoneme
        draw.text((2, i * CELL_HEIGHT), label, fill='yellow')
    return image


def from_ppg_to_image_file(ppg, output_file, second_ppg=None,
                           textgrid_file=None, config=None):
    from_ppg_to_image(ppg, second_ppg, textgrid_file, config).save(
        output_file)


def from_ppg_to_video_file(ppg, audio_file, output_file, second_ppg=None,
                           textgrid_file=None, scalefactor=16, config=None):
    """Scrolling-playhead PPG video (reference ppgs/plot/core.py:254-420).

    Geometry matches the reference: a window of sample_rate/hopsize PPG
    frames (1 s) scrolls by 2 frames per video frame at 50 fps (real time),
    with the strip padded half a window each side so the red playhead column
    stays centered over "now". Rendered with cv2 instead of moviepy; audio
    is muxed with ffmpeg when a binary is on PATH, otherwise the video is
    written silent with a warning.
    """
    import shutil
    import subprocess
    import tempfile
    import warnings

    import cv2

    config = config_mod.get(config)
    ppg = np.asarray(ppg)
    frames = ppg.shape[-1]

    window = config.sample_rate // config.hopsize          # 100 frames = 1 s
    hop = 2
    padding = window // 2 - hop // 2                       # playhead center
    fps = window // hop                                    # real-time: 50

    green = (_textgrid_to_onehot(textgrid_file, frames, config)
             if textgrid_file is not None else None)
    blue = (_ppg_to_pixels(second_ppg)
            if second_ppg is not None else None)
    strip = combine_pixels(_ppg_to_pixels(ppg), green, blue)   # (40, T, 3)
    strip = np.pad(strip, ((0, 0), (padding, padding), (0, 0)))

    rows = strip.shape[0]
    height = (rows + 10) * scalefactor                     # +10px black bar
    width = window * scalefactor

    # Static overlays, rendered once: phoneme labels (right of playhead, as
    # in the reference) and the red playhead column
    from PIL import Image, ImageDraw

    label_img = Image.new('L', (width, height), 0)
    draw = ImageDraw.Draw(label_img)
    for i, phoneme in enumerate(PHONEMES):
        label = 'sil' if phoneme == SILENCE else phoneme
        draw.text((width // 2, i * scalefactor), label, fill=255)
    label_mask = np.asarray(label_img) > 0                 # (H, W)
    playhead_x = width // 2 - scalefactor

    video_only = Path(tempfile.mkdtemp()) / 'video.mp4'
    writer = cv2.VideoWriter(
        str(video_only), cv2.VideoWriter_fourcc(*'mp4v'), fps,
        (width, height))
    if not writer.isOpened():
        raise RuntimeError('cv2.VideoWriter failed to open an mp4 encoder')
    bar = np.zeros((10, window, 3), np.uint8)
    for i in range(frames // hop):
        chunk = strip[:, i * hop: i * hop + window]
        frame = np.concatenate([chunk, bar], axis=0)
        frame = cv2.resize(frame, (width, height),
                           interpolation=cv2.INTER_NEAREST)
        frame[:, playhead_x] = (255, 0, 0)
        frame[label_mask] = (255, 255, 255)
        writer.write(frame[..., ::-1])                     # RGB -> BGR
    writer.release()

    ffmpeg = shutil.which('ffmpeg')
    if audio_file is not None and ffmpeg:
        subprocess.run(
            [ffmpeg, '-y', '-loglevel', 'error', '-i', str(video_only),
             '-i', str(audio_file), '-c:v', 'copy', '-c:a', 'aac',
             '-shortest', str(output_file)],
            check=True)
        video_only.unlink()
    else:
        if audio_file is not None:
            warnings.warn(
                'No ffmpeg binary found: writing the PPG video without the '
                'audio track')
        shutil.move(str(video_only), str(output_file))
    video_only.parent.rmdir()


def from_file_to_file(
    ppg_file,
    output_file,
    second_ppg_file=None,
    textgrid_file=None,
    audio_file=None,
    checkpoint=None,
    config=None,
    device=None,
):
    """Plot one PPG file (or infer it from audio on ``device``: None means
    the card, raising without one) to an image/video file."""
    config = config_mod.get(config)
    if ppg_file is not None:
        ppg = np.load(ppg_file)
    else:
        from ..core import from_file as infer_from_file

        ppg = infer_from_file(audio_file, checkpoint=checkpoint,
                              config=config, device=device).cpu().numpy()
    second = np.load(second_ppg_file) if second_ppg_file else None

    ext = str(output_file).split('.')[-1]
    if ext in ('jpg', 'png', 'pdf'):
        from_ppg_to_image_file(ppg, output_file, second, textgrid_file,
                               config)
    elif ext == 'mp4':
        from_ppg_to_video_file(ppg, audio_file, output_file, second,
                               textgrid_file, config=config)
    else:
        raise ValueError(f'Unknown extension {ext}')


def from_files_to_files(
    output_files: List,
    ppg_files: Optional[List] = None,
    audio_files: Optional[List] = None,
    second_ppg_files: Optional[List] = None,
    textgrid_files: Optional[List] = None,
    checkpoint=None,
    config=None,
    device=None,
):
    """Plot PPGs (from files or inferred from audio on ``device``) to
    image/video files."""
    assert ppg_files is not None or audio_files is not None
    n = len(output_files)
    ppg_files = ppg_files if ppg_files is not None else repeat(None, n)
    audio_files = audio_files if audio_files is not None else repeat(None, n)
    second_ppg_files = (second_ppg_files if second_ppg_files is not None
                        else repeat(None, n))
    textgrid_files = (textgrid_files if textgrid_files is not None
                      else repeat(None, n))
    for ppg_file, audio_file, second, textgrid, output in zip(
            ppg_files, audio_files, second_ppg_files, textgrid_files,
            output_files):
        from_file_to_file(ppg_file, output, second, textgrid, audio_file,
                          checkpoint, config, device)
