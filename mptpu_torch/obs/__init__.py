"""Observability of the port (counterpart of ``mptpu.obs``; only the
ported names): the static HTML article and the WAV bytes it embeds."""

from .article import AudioComponent, ImageComponent, conjure_article
from .collection import encode_audio

__all__ = ["AudioComponent", "ImageComponent", "conjure_article", "encode_audio"]
