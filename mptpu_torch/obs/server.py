"""Live training dashboard: a small threaded HTTP server over a
``Collection`` (counterpart of ``mptpu/obs/server.py``; the same page and
endpoints).

Endpoints:
  GET /                  -> the HTML dashboard (refreshes itself)
  GET /api/names         -> JSON list of logged names
  GET /api/meta/<name>   -> JSON of a name's kind, count and time
  GET /api/value/<name>  -> a JSON array, or WAV bytes for audio
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .collection import Collection

_PAGE = """<!doctype html>
<html><head><title>mptpu dashboard</title>
<style>body{font-family:monospace;background:#111;color:#eee;padding:1em}
.item{margin:1em 0;padding:1em;background:#1c1c1c;border-radius:8px}</style>
</head><body>
<h1>mptpu training dashboard</h1><div id="items"></div>
<script>
async function refresh(){
  const names = await (await fetch('/api/names')).json();
  const root = document.getElementById('items');
  for(const n of names){
    let el = document.getElementById('item-'+n);
    if(!el){ el = document.createElement('div'); el.className='item';
      el.id='item-'+n; root.appendChild(el); }
    const meta = await (await fetch('/api/meta/'+n)).json();
    if(meta.kind==='audio'){
      el.innerHTML = '<b>'+n+'</b><br><audio controls src="/api/value/'+n+'?t='+Date.now()+'"></audio>';
    } else {
      const v = await (await fetch('/api/value/'+n)).json();
      el.innerHTML = '<b>'+n+'</b> <pre>'+JSON.stringify(v).slice(0,2000)+'</pre>';
    }
  }
}
refresh(); setInterval(refresh, 5000);
</script></body></html>"""


def serve_collection(collection: Collection, port: int = 9999, daemon: bool = True,
                     host: str = "0.0.0.0"):
    """Start the dashboard server on ``host:port`` (port 0: any free one,
    ``server.server_address`` says which) in a background thread; returns
    the server (``.shutdown()`` then ``.server_close()`` stop it)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code, content_type, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                if self.path == "/" or self.path.startswith("/index"):
                    self._send(200, "text/html", _PAGE.encode())
                elif self.path.startswith("/api/names"):
                    self._send(
                        200,
                        "application/json",
                        json.dumps(collection.names()).encode(),
                    )
                elif self.path.startswith("/api/meta/"):
                    name = self.path.split("/api/meta/")[1].split("?")[0]
                    self._send(
                        200,
                        "application/json",
                        json.dumps(collection.meta(name)).encode(),
                    )
                elif self.path.startswith("/api/value/"):
                    name = self.path.split("/api/value/")[1].split("?")[0]
                    meta = collection.meta(name)
                    value = collection.latest(name)
                    if meta["kind"] == "audio":
                        self._send(200, "audio/wav", bytes(value))
                    else:
                        arr = np.asarray(value)
                        flat = arr.reshape(-1)[:4096].tolist()
                        self._send(
                            200,
                            "application/json",
                            json.dumps(
                                {"shape": list(arr.shape), "data": flat}
                            ).encode(),
                        )
                else:
                    self._send(404, "text/plain", b"not found")
            except KeyError:
                self._send(404, "text/plain", b"unknown name")
            except (BrokenPipeError, ConnectionResetError):
                pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=daemon)
    thread.start()
    return server
