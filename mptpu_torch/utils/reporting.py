"""HTML report pieces (counterpart of ``mptpu/utils/reporting.py``): audio
embedded as data URLs, sections and a table of contents."""

from __future__ import annotations

import base64
import html
from typing import List, Tuple

from .playable import encode_audio


def audio_data_url(samples, samplerate: int = 22050) -> str:
    return "data:audio/wav;base64," + base64.b64encode(encode_audio(samples, samplerate)).decode()


def audio_element(samples, samplerate: int = 22050, title: str = "") -> str:
    t = f"<h4>{html.escape(title)}</h4>" if title else ""
    return f'{t}<audio controls src="{audio_data_url(samples, samplerate)}"></audio>'


def section(title: str, body_html: str, anchor: str | None = None) -> str:
    anchor = anchor or title.lower().replace(" ", "-")
    return f'<section id="{html.escape(anchor)}"><h2>{html.escape(title)}</h2>{body_html}</section>'


def table_of_contents(titles: List[str]) -> str:
    items = "".join(f'<li><a href="#{html.escape(t.lower().replace(" ", "-"))}">'
                    f"{html.escape(t)}</a></li>" for t in titles)
    return f"<nav><ul>{items}</ul></nav>"


def html_page(title: str, sections: List[Tuple[str, str]]) -> str:
    toc = table_of_contents([t for t, _ in sections])
    body = "\n".join(section(t, b) for t, b in sections)
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title></head>"
            f"<body><h1>{html.escape(title)}</h1>{toc}{body}</body></html>")
