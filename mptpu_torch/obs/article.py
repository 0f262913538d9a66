"""A static HTML article (counterpart of ``conjure_article``,
``AudioComponent`` and ``ImageComponent`` in ``mptpu/obs/article.py``, which
imports no JAX; the port keeps its own copy), with ``TextComponent`` and
``CompositeComponent``): audio as base64 WAV data
URLs, a 2-D array as an inline SVG strip, so that the file needs no other.
"""

from __future__ import annotations

import base64
import html
from dataclasses import dataclass, field
from typing import List

import numpy as np

from .collection import encode_audio


@dataclass
class AudioComponent:
    samples: np.ndarray
    samplerate: int = 22050
    title: str = ""

    def render(self) -> str:
        wav = encode_audio(np.asarray(self.samples), self.samplerate)
        b64 = base64.b64encode(wav).decode()
        t = f"<h4>{html.escape(self.title)}</h4>" if self.title else ""
        return (
            f'<div class="component">{t}'
            f'<audio controls src="data:audio/wav;base64,{b64}"></audio></div>'
        )


@dataclass
class ImageComponent:
    """Renders a 2-d array as an inline SVG heat strip (spectrogram-ish)."""

    array: np.ndarray
    title: str = ""
    height: int = 200

    def render(self) -> str:
        arr = np.nan_to_num(np.asarray(self.array, dtype=np.float64))
        arr = arr.reshape(arr.shape[0], -1) if arr.ndim > 2 else np.atleast_2d(arr)
        arr = arr - arr.min()
        arr = arr / (arr.max() + 1e-9)
        h, w = arr.shape
        # downsample for svg sanity
        step_h = max(1, h // 64)
        step_w = max(1, w // 256)
        small = arr[::step_h, ::step_w]
        sh, sw = small.shape
        rects = []
        for i in range(sh):
            for j in range(sw):
                v = float(small[i, j])
                if v < 0.02:
                    continue
                c = int(v * 255)
                rects.append(
                    f'<rect x="{j}" y="{sh - 1 - i}" width="1" height="1" '
                    f'fill="rgb({c},{c // 2},{255 - c})"/>'
                )
        t = f"<h4>{html.escape(self.title)}</h4>" if self.title else ""
        return (
            f'<div class="component">{t}'
            f'<svg viewBox="0 0 {sw} {sh}" width="100%" height="{self.height}" '
            f'preserveAspectRatio="none">{"".join(rects)}</svg></div>'
        )


@dataclass
class TextComponent:
    markdown: str

    def render(self) -> str:
        # minimal markdown: headers + paragraphs
        lines = []
        for line in self.markdown.split("\n"):
            s = line.strip()
            if s.startswith("## "):
                lines.append(f"<h2>{html.escape(s[3:])}</h2>")
            elif s.startswith("# "):
                lines.append(f"<h1>{html.escape(s[2:])}</h1>")
            elif s:
                lines.append(f"<p>{html.escape(s)}</p>")
        return "\n".join(lines)


@dataclass
class CompositeComponent:
    """Its components rendered in order inside one ``<section>``, under
    ``title`` when there is one."""

    components: List = field(default_factory=list)
    title: str = ""

    def render(self) -> str:
        inner = "\n".join(c.render() for c in self.components)
        t = f"<h3>{html.escape(self.title)}</h3>" if self.title else ""
        return f"<section>{t}{inner}</section>"


_STYLE = """body{max-width:900px;margin:2em auto;font-family:Georgia,serif;
line-height:1.6;color:#222;padding:0 1em}
.component{margin:1.5em 0} audio{width:100%}
h1,h2,h3{font-family:Helvetica,sans-serif}"""


def conjure_article(
    path: str,
    title: str,
    components: List,
    intro_markdown: str = "",
) -> str:
    """Render components to a standalone HTML article file."""
    body = "\n".join(
        c.render() if hasattr(c, "render") else TextComponent(str(c)).render()
        for c in components
    )
    intro = TextComponent(intro_markdown).render() if intro_markdown else ""
    doc = (
        f"<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title><style>{_STYLE}</style></head>"
        f"<body><h1>{html.escape(title)}</h1>{intro}{body}</body></html>"
    )
    with open(path, "w") as f:
        f.write(doc)
    return path
