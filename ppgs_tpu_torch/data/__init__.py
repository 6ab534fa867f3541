from . import audio, textgrid
