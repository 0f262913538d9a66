"""Helpers of the port (counterpart of ``mptpu.utils``; only the ported
names)."""

from .music import midi_to_hz, musical_scale_hz
from .playable import encode_audio, playable
from .reporting import audio_data_url, audio_element, html_page, section, table_of_contents
from .wav import read_wav

__all__ = ["midi_to_hz", "musical_scale_hz", "encode_audio", "playable", "audio_data_url",
           "audio_element", "html_page", "section", "table_of_contents", "read_wav"]
