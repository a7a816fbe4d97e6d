"""Demo chat UI: a dependency-free frontend for a served Workspace.

A copy of ``kaito_tpu.ui`` for the port: one stdlib HTTP server ships an
embedded chat page and proxies ``/v1/*`` to the workspace service, so
the browser needs no CORS and the pod no pip installs.  The page's bytes
are the JAX package's.

Run: ``python -m kaito_tpu_torch.ui --backend http://<ws>.<ns>.svc:5000``.
The port's engine server (``kaito_tpu_torch.engine.server``) serves the
same page at ``/ui`` for single-pod demos.
"""

from __future__ import annotations

import argparse
import json
import logging
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

logger = logging.getLogger(__name__)

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>kaito-tpu chat</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:760px;margin:2rem auto;
      padding:0 1rem;background:#111;color:#eee}
 h1{font-size:1.1rem;color:#9cf}
 #log{border:1px solid #333;border-radius:8px;padding:1rem;min-height:300px;
      white-space:pre-wrap}
 .u{color:#9cf;margin:.5rem 0 .2rem}
 .a{color:#dfd;margin:.2rem 0 .8rem}
 form{display:flex;gap:.5rem;margin-top:1rem}
 input{flex:1;padding:.6rem;border-radius:6px;border:1px solid #444;
       background:#1a1a1a;color:#eee}
 button{padding:.6rem 1.2rem;border-radius:6px;border:0;background:#247;
        color:#fff;cursor:pointer}
</style></head><body>
<h1>kaito-tpu &mdash; chat demo</h1>
<div id="log"></div>
<form id="f"><input id="q" placeholder="Ask something" autofocus>
<button>Send</button></form>
<script>
const log = document.getElementById("log");
const messages = [];
document.getElementById("f").addEventListener("submit", async (e) => {
  e.preventDefault();
  const q = document.getElementById("q");
  const text = q.value.trim();
  if (!text) return;
  q.value = "";
  messages.push({role: "user", content: text});
  log.insertAdjacentHTML("beforeend",
    `<div class="u">you: ${text.replace(/</g, "&lt;")}</div>`);
  const out = document.createElement("div");
  out.className = "a";
  out.textContent = "assistant: ";
  log.appendChild(out);
  let acc = "";
  try {
    const resp = await fetch("/v1/chat/completions", {
      method: "POST", headers: {"Content-Type": "application/json"},
      body: JSON.stringify({messages, stream: true, max_tokens: 512}),
    });
    if (!resp.ok) {
      const err = await resp.text();
      out.textContent = `error ${resp.status}: ${err.slice(0, 300)}`;
      messages.pop();            // don't replay the failed turn
      return;
    }
    const reader = resp.body.getReader();
    const dec = new TextDecoder();
    let buf = "";
    while (true) {
      const {done, value} = await reader.read();
      if (done) break;
      buf += dec.decode(value, {stream: true});
      const lines = buf.split("\\n");
      buf = lines.pop();         // keep the incomplete tail unparsed
      for (const line of lines) {
        if (!line.startsWith("data: ") || line.includes("[DONE]")) continue;
        try {
          const delta = JSON.parse(line.slice(6)).choices[0].delta;
          if (delta.content) { acc += delta.content; out.textContent =
            "assistant: " + acc; }
        } catch {}
      }
    }
  } catch (err) {
    out.textContent = `error: ${err}`;
    messages.pop();
    return;
  }
  messages.push({role: "assistant", content: acc});
  window.scrollTo(0, document.body.scrollHeight);
});
</script></body></html>"""


def serve_page(handler: BaseHTTPRequestHandler) -> None:
    """Write the chat page on any stdlib handler (shared by the
    standalone proxy and the engine server's /ui route)."""
    body = PAGE.encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "text/html; charset=utf-8")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def make_handler(backend: str):
    class UIHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path in ("/", "/ui", "/ui/"):
                return serve_page(self)
            if self.path == "/health":
                body = b'{"status": "ok"}'
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_POST(self):
            if not self.path.lstrip("/").startswith("v1/"):
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            n = int(self.headers.get("Content-Length", "0"))
            payload = self.rfile.read(n)
            req = urllib.request.Request(
                backend.rstrip("/") + "/" + self.path.lstrip("/"),
                data=payload,
                headers={"Content-Type": "application/json"})
            try:
                upstream = urllib.request.urlopen(req, timeout=600)
            except urllib.error.HTTPError as e:
                upstream = e
            except urllib.error.URLError as e:
                # backend down/restarting: a clean 502 the page can
                # show, not a dropped socket
                body = json.dumps({"error": {
                    "message": f"workspace backend unreachable: "
                               f"{e.reason}", "type": "bad_gateway"}}
                ).encode()
                self.send_response(502)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self.send_response(upstream.status)
            ctype = upstream.headers.get("Content-Type",
                                         "application/json")
            self.send_header("Content-Type", ctype)
            if "text/event-stream" in ctype:
                # forward whatever is available NOW (read1) — a full
                # read(4096) would batch the SSE tokens into bursts
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                while True:
                    chunk = upstream.read1(4096)
                    if not chunk:
                        break
                    self.wfile.write(f"{len(chunk):x}\r\n".encode()
                                     + chunk + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
            else:
                body = upstream.read()
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

    return UIHandler


def make_server(backend: str, host: str = "0.0.0.0",
                port: int = 8000) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(backend))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kaito-tpu-torch-ui")
    ap.add_argument("--backend", required=True,
                    help="workspace service URL, e.g. "
                         "http://ws.default.svc.cluster.local:5000")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    srv = make_server(args.backend, args.host, args.port)
    logger.info("demo UI on %s:%d -> %s", args.host, args.port, args.backend)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
