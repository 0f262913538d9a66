"""Observability of the port (counterpart of ``mptpu.obs``): the static
HTML article, the logged-value collection and its live dashboard."""

from .article import (AudioComponent, CompositeComponent, ImageComponent, TextComponent,
                      conjure_article)
from .collection import Collection, encode_audio, loggers
from .server import serve_collection

__all__ = ["AudioComponent", "CompositeComponent", "ImageComponent", "TextComponent", "conjure_article", "Collection", "encode_audio",
           "loggers", "serve_collection"]
