"""Web UI — browse the results store from a browser
(``jepsen/web.clj``): a table of runs with validity, per-run file
listings, artifact serving, and zip download of a whole run.

The counterpart of the JAX package's ``harness/web.py``: host code
reading the store through the port's ``ops.edn`` and ``harness.store``;
the same pages.
"""

from __future__ import annotations

import html
import io
import os
import threading
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import unquote

from ..ops.edn import read_edn_all
from . import store as store_ns

CONTENT_TYPES = {
    ".html": "text/html; charset=utf-8",
    ".svg": "image/svg+xml",
    ".edn": "text/plain; charset=utf-8",
    ".txt": "text/plain; charset=utf-8",
    ".log": "text/plain; charset=utf-8",
    ".json": "application/json",
}


def _runs(store_root: str):
    """(name, start-time, valid?) rows, newest first
    (``web.clj:36-76``)."""
    rows = []
    if not os.path.isdir(store_root):
        return rows
    for name in sorted(os.listdir(store_root)):
        d = os.path.join(store_root, name)
        if not os.path.isdir(d) or name == "latest":
            continue
        for t in store_ns.tests(name, store_root):
            valid = None
            rpath = os.path.join(d, t, "results.edn")
            if os.path.exists(rpath):
                try:
                    forms = read_edn_all(open(rpath).read())
                    if forms:
                        valid = forms[0].get("valid?")
                except Exception:
                    valid = "?"
            rows.append((name, t, valid))
    rows.sort(key=lambda r: r[1], reverse=True)
    return rows


def _index_html(store_root: str) -> str:
    rows = _runs(store_root)
    body = ["<html><head><title>comdb2_tpu store</title><style>",
            "body{font:14px monospace} table{border-collapse:collapse}",
            "td,th{border:1px solid #ccc;padding:4px 8px}",
            ".valid{background:#B7FFB7}.invalid{background:#FFD4D5}",
            ".unknown{background:#FEFFC1}",
            "</style></head><body><h1>test runs</h1><table>",
            "<tr><th>test</th><th>time</th><th>valid?</th><th></th></tr>"]
    for name, t, valid in rows:
        cls = ("valid" if valid is True
               else "invalid" if valid is False else "unknown")
        qn, qt = html.escape(name), html.escape(t)
        body.append(
            f'<tr class="{cls}"><td><a href="/files/{qn}/{qt}/">{qn}</a>'
            f"</td><td>{qt}</td><td>{html.escape(str(valid))}</td>"
            f'<td><a href="/zip/{qn}/{qt}">zip</a></td></tr>')
    body.append("</table>")
    # the verifier daemon's status artifact (store/service/ — written
    # by `python -m comdb2_tpu_torch.service --store`; docs/service.md)
    svc = os.path.join(store_root, "service", "latest.json")
    if os.path.exists(svc):
        summary = ""
        try:
            import json as _json

            st = _json.loads(open(svc).read())
            summary = (f" — {st.get('completed', 0)} checked, "
                       f"{st.get('dispatches', 0)} dispatches, "
                       f"queue {st.get('queue_depth', 0)}")
        except Exception:
            pass
        links = ['<a href="/files/service/">verifier service</a>']
        # obs artifacts written by the daemon's artifact pass
        # (docs/observability.md): the latency/rate timeline and —
        # with --trace — the Perfetto span export
        for art in ("timeline.svg", "trace.json"):
            if os.path.exists(os.path.join(store_root, "service",
                                           art)):
                links.append(f'<a href="/files/service/{art}">'
                             f"{art}</a>")
        body.append(f"<p>{' · '.join(links)}"
                    f"{html.escape(summary)}</p>")
    body.append("</body></html>")
    return "".join(body)


def _listing_html(root: str, rel: str) -> str:
    d = os.path.join(root, rel)
    entries = sorted(os.listdir(d))
    body = [f"<html><body style='font:14px monospace'>"
            f"<h1>/{html.escape(rel)}</h1><ul>",
            '<li><a href="/">&larr; index</a></li>']
    for e in entries:
        q = html.escape(e)
        suffix = "/" if os.path.isdir(os.path.join(d, e)) else ""
        body.append(f'<li><a href="{q}{suffix}">{q}{suffix}</a></li>')
    body.append("</ul></body></html>")
    return "".join(body)


def _zip_run(root: str, rel: str) -> bytes:
    buf = io.BytesIO()
    base = os.path.join(root, rel)
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for dirpath, _dirs, files in os.walk(base):
            for f in files:
                full = os.path.join(dirpath, f)
                z.write(full, os.path.relpath(full, base))
    return buf.getvalue()


def _safe_rel(root: str, rel: str) -> Optional[str]:
    """Resolve a URL path inside the store root, rejecting traversal."""
    rel = unquote(rel).lstrip("/")
    full = os.path.realpath(os.path.join(root, rel))
    if not full.startswith(os.path.realpath(root) + os.sep) \
            and full != os.path.realpath(root):
        return None
    return rel


class _Handler(BaseHTTPRequestHandler):
    store_root = "store"

    def log_message(self, *args):
        pass

    def _send(self, code: int, content: bytes,
              ctype: str = "text/html; charset=utf-8"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(content)))
        self.end_headers()
        self.wfile.write(content)

    def do_GET(self):
        root = self.store_root
        try:
            if self.path in ("/", "/index.html"):
                self._send(200, _index_html(root).encode())
                return
            if self.path.startswith("/zip/"):
                rel = _safe_rel(root, self.path[len("/zip/"):])
                if rel is None or not os.path.isdir(
                        os.path.join(root, rel)):
                    self._send(404, b"not found")
                    return
                data = _zip_run(root, rel)
                name = rel.replace("/", "_") + ".zip"
                self.send_response(200)
                self.send_header("Content-Type", "application/zip")
                self.send_header("Content-Disposition",
                                 f'attachment; filename="{name}"')
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            if self.path.startswith("/files/"):
                rel = _safe_rel(root, self.path[len("/files/"):])
                if rel is None:
                    self._send(403, b"forbidden")
                    return
                full = os.path.join(root, rel)
                if os.path.isdir(full):
                    self._send(200, _listing_html(root, rel).encode())
                    return
                if os.path.isfile(full):
                    ext = os.path.splitext(full)[1]
                    ctype = CONTENT_TYPES.get(ext,
                                              "application/octet-stream")
                    with open(full, "rb") as fh:
                        self._send(200, fh.read(), ctype)
                    return
            self._send(404, b"not found")
        except BrokenPipeError:
            pass


def serve(store_root: str = "store", port: int = 8080,
          block: bool = True) -> Tuple[ThreadingHTTPServer, int]:
    """Serve the store browser; ``block=False`` runs it on a daemon
    thread and returns (server, port). Port 0 picks a free port."""
    handler = type("Handler", (_Handler,), {"store_root": store_root})
    srv = ThreadingHTTPServer(("127.0.0.1", port), handler)
    port = srv.server_address[1]
    if block:
        srv.serve_forever()
    else:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, port
