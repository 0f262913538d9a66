"""The config layer (counterpart of ``mptpu.config``): paths from the
environment or a ``.env`` file, and the ``Experiment`` bundle of a filter
bank and a perceptual feature."""

from .dotenv import audio_path, cache_path, impulse_response_path, parse_dotenv
from .experiment import Experiment

__all__ = ["audio_path", "cache_path", "impulse_response_path", "parse_dotenv", "Experiment"]
