"""Dependency-free HTTP serving for AniPortrait (stdlib only); port of
``scripts/serve.py``.

The reference's only serving surface is a Gradio app (reference
``scripts/app.py:417-494``) that blocks the request thread for the whole
generation and has no queue.  This server provides the same two capabilities
(audio2video, video2video) through a plain ``http.server`` front-end with:

  * a background worker thread owning the GPU: requests enqueue jobs and
    poll, so the card is never contended and uploads never stall generation;
  * a JSON job API (`POST /api/audio2video`, `POST /api/video2video`,
    `GET /api/jobs[/<id>]`, `GET /healthz`) usable headless;
  * a minimal built-in HTML page at `/` for interactive use.

Run:
    python -m aniportrait_tpu_torch.scripts.serve --config configs/prompts/animation_audio.yaml
    python -m aniportrait_tpu_torch.scripts.serve --random-init --size micro --device cpu

The model callbacks are shared with the Gradio app via
``scripts/serving_core.py``.  The models run on the card unless ``--device
cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import mimetypes
import os
import queue
import re
import tempfile
import threading
import time
import uuid
from email.parser import BytesParser
from email.policy import HTTP
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

INDEX_HTML = """<!doctype html>
<html><head><title>AniPortrait-TPU</title>
<style>
 body{font-family:sans-serif;max-width:760px;margin:2em auto;padding:0 1em}
 fieldset{margin-bottom:1.5em} .job{margin:.3em 0;font-family:monospace}
 .done{color:#070} .failed{color:#b00} .running{color:#850}
</style></head><body>
<h1>AniPortrait-TPU</h1>
<fieldset><legend><b>Audio2Video</b></legend>
<form onsubmit="return submitJob(this,'/api/audio2video')">
 ref image <input type=file name=ref_image accept=image/* required>
 audio <input type=file name=audio required>
 head-pose video (optional) <input type=file name=headpose_video>
 <br>size <input name=size value=512 size=4>
 steps <input name=steps value=25 size=4>
 length <input name=length value=150 size=4>
 seed <input name=seed value=42 size=4>
 <button>Generate</button>
</form></fieldset>
<fieldset><legend><b>Video2Video</b></legend>
<form onsubmit="return submitJob(this,'/api/video2video')">
 ref image <input type=file name=ref_image accept=image/* required>
 source video <input type=file name=source_video required>
 <br>size <input name=size value=512 size=4>
 steps <input name=steps value=25 size=4>
 length <input name=length value=150 size=4>
 seed <input name=seed value=42 size=4>
 <button>Generate</button>
</form></fieldset>
<h3>Jobs</h3><div id=jobs></div>
<script>
async function submitJob(form, url){
  const r = await fetch(url, {method:'POST', body:new FormData(form)});
  refresh(); return false;
}
async function refresh(){
  const r = await fetch('/api/jobs'); const jobs = await r.json();
  document.getElementById('jobs').innerHTML = jobs.map(j =>
    `<div class="job ${j.status}">${j.id.slice(0,8)} ${j.kind} ${j.status}` +
    (j.result ? ` <a href="${j.result}">result</a>` : '') +
    (j.error ? ` ${j.error}` : '') + `</div>`).join('');
}
setInterval(refresh, 2000); refresh();
</script></body></html>"""


class JobStore:
    def __init__(self):
        self.jobs = {}
        self.order = []
        self.lock = threading.Lock()

    def create(self, kind, payload):
        jid = uuid.uuid4().hex
        with self.lock:
            self.jobs[jid] = {
                "id": jid, "kind": kind, "status": "queued",
                "submitted": time.time(), "result": None, "error": None,
            }
            self.order.append(jid)
        return jid

    def update(self, jid, **kw):
        with self.lock:
            self.jobs[jid].update(kw)

    def get(self, jid):
        with self.lock:
            return dict(self.jobs[jid]) if jid in self.jobs else None

    def list(self):
        with self.lock:
            return [dict(self.jobs[j]) for j in reversed(self.order)]


class Worker(threading.Thread):
    """Single worker owning the GPU; jobs run strictly in order."""

    def __init__(self, store, handlers, out_dir):
        super().__init__(daemon=True)
        self.q = queue.Queue()
        self.store = store
        self.handlers = handlers
        self.out_dir = out_dir

    def submit(self, jid, kind, kwargs):
        self.q.put((jid, kind, kwargs))

    def run(self):
        while True:
            jid, kind, kwargs = self.q.get()
            self.store.update(jid, status="running", started=time.time())
            try:
                path = self.handlers[kind](out_dir=self.out_dir, **kwargs)
                if path is None:
                    raise ValueError("no face detected in the reference image")
                self.store.update(
                    jid, status="done", finished=time.time(),
                    result="/results/" + os.path.basename(path),
                )
            except Exception as e:  # noqa: BLE001 — surfaced to the client
                self.store.update(
                    jid, status="failed", finished=time.time(),
                    error=f"{type(e).__name__}: {e}",
                )


def parse_multipart(headers, body: bytes):
    """Parse a multipart/form-data body into {name: str | (filename, bytes)}
    with the stdlib email parser (no cgi module — removed in py3.13)."""
    ctype = headers.get("Content-Type", "")
    if not ctype.startswith("multipart/form-data"):
        raise ValueError("expected multipart/form-data")
    msg = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body
    )
    fields = {}
    for part in msg.iter_parts():
        cd = part.get("Content-Disposition", "")
        m = re.search(r'name="([^"]*)"', cd)
        if not m:
            continue
        name = m.group(1)
        fm = re.search(r'filename="([^"]*)"', cd)
        payload = part.get_payload(decode=True)
        if fm and fm.group(1):
            fields[name] = (fm.group(1), payload)
        else:
            fields[name] = (payload or b"").decode("utf-8", "replace").strip()
    return fields


def make_handler(store, worker, upload_dir, out_dir, defaults, max_queue=8):
    def save_upload(item):
        if not isinstance(item, tuple):
            return None
        filename, data = item
        if not data:
            return None
        suffix = os.path.splitext(filename)[1] or ".bin"
        fd, path = tempfile.mkstemp(suffix=suffix, dir=upload_dir)
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        return path

    def decode_image(item):
        import cv2
        import numpy as np

        filename, data = item
        arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if arr is None:
            raise ValueError(f"could not decode image {filename!r}")
        return cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, obj, code=200):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                data = INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path == "/healthz":
                self._json({"ok": True, "queued": worker.q.qsize()})
            elif self.path == "/api/jobs":
                self._json(store.list())
            elif self.path.startswith("/api/jobs/"):
                job = store.get(self.path.rsplit("/", 1)[1])
                self._json(job or {"error": "unknown job"}, 200 if job else 404)
            elif self.path.startswith("/results/"):
                name = os.path.basename(self.path)
                path = os.path.join(out_dir, name)
                if not os.path.exists(path):
                    self._json({"error": "not found"}, 404)
                    return
                ctype = mimetypes.guess_type(name)[0] or "application/octet-stream"
                with open(path, "rb") as f:
                    data = f.read()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            if self.path not in ("/api/audio2video", "/api/video2video"):
                self._json({"error": "not found"}, 404)
                return
            # graceful degradation under load: refuse NEW work with a 503
            # (+ Retry-After) once the single-accelerator queue is full,
            # instead of accepting unbounded jobs whose uploads pile up in
            # tmp and whose wait times silently grow
            if worker.q.qsize() >= max_queue:
                data = json.dumps({
                    "error": "server at capacity "
                             f"({worker.q.qsize()} jobs queued, max {max_queue}); "
                             "retry later",
                }).encode()
                self.send_response(503)
                self.send_header("Retry-After", "30")
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                fields = parse_multipart(self.headers, body)
                kind = self.path.rsplit("/", 1)[1]
                kwargs = {
                    "size": int(fields.get("size", defaults["size"])),
                    "steps": int(fields.get("steps", defaults["steps"])),
                    "length": int(fields.get("length", defaults["length"])),
                    "seed": int(fields.get("seed", 42)),
                    "ref_img_rgb": decode_image(fields["ref_image"]),
                }
                if kind == "audio2video":
                    kwargs["input_audio"] = save_upload(fields["audio"])
                    kwargs["headpose_video"] = save_upload(
                        fields.get("headpose_video")
                    )
                else:
                    kwargs["source_video"] = save_upload(fields["source_video"])
            except (KeyError, ValueError) as e:
                self._json({"error": f"bad request: {e}"}, 400)
                return
            jid = store.create(kind, None)
            worker.submit(jid, kind, kwargs)
            self._json({"id": jid, "status": "queued"}, 202)

    return Handler


def build_server(handlers, host="127.0.0.1", port=7860, out_dir="output/serve",
                 max_queue=8):
    """handlers: {'audio2video': fn, 'video2video': fn} — each fn takes the
    parsed request kwargs (+ out_dir) and returns the result file path.
    Injectable so tests can run the HTTP layer without models.
    max_queue: jobs allowed to wait for the single accelerator worker;
    POSTs beyond it get a 503 + Retry-After."""
    os.makedirs(out_dir, exist_ok=True)
    upload_dir = tempfile.mkdtemp(prefix="aniportrait_uploads_")
    store = JobStore()
    worker = Worker(store, handlers, out_dir)
    worker.start()
    httpd = ThreadingHTTPServer(
        (host, port), make_handler(store, worker, upload_dir, out_dir, defaults={
            "size": 512, "steps": 25, "length": 150,
        }, max_queue=max_queue)
    )
    httpd.job_store = store
    httpd.worker = worker
    return httpd


def preload_warmup(models, size=512, steps=25, length=150):
    """Warm up the serving pipeline before accepting traffic: one synthetic
    generation at the default serving shape, so the first request does not
    pay the first launches (cuDNN's algorithm search, the kernels' module
    load, the allocator's growth)."""
    import numpy as np

    rs = np.random.RandomState(0)
    ref = rs.randint(0, 255, (size, size, 3), np.uint8)
    poses = [rs.randint(0, 255, (size, size, 3), np.uint8)
             for _ in range(length)]
    t0 = time.time()
    models.pipe(ref, poses, None, size, size, length, steps, 3.5, seed=0)
    print(f"preload: warm-up of the {size}x{size}/{length}f/{steps}step serving "
          f"shape in {time.time() - t0:.0f}s")


def model_handlers(models):
    """Wrap the serving_core callbacks as server handlers."""
    from aniportrait_tpu_torch.scripts.serving_core import run_audio2video, run_video2video

    def a2v(ref_img_rgb, input_audio, headpose_video=None, out_dir="output/serve",
            **kw):
        path, _ = run_audio2video(
            models, input_audio, ref_img_rgb, headpose_video,
            out_dir=out_dir, **kw,
        )
        return path

    def v2v(ref_img_rgb, source_video, out_dir="output/serve", **kw):
        path, _ = run_video2video(
            models, ref_img_rgb, source_video, out_dir=out_dir, **kw,
        )
        return path

    return {"audio2video": a2v, "video2video": v2v}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="./configs/prompts/animation_audio.yaml")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--out-dir", default="output/serve")
    ap.add_argument("--random-init", action="store_true",
                    help="random weights (no checkpoint zoo) — smoke runs")
    ap.add_argument("--device", default="cuda",
                    help="where the models run: cuda (default) or cpu")
    ap.add_argument("--size", default="full",
                    help="factory size preset (full/tiny/micro)")
    ap.add_argument("--max-queue", type=int, default=8,
                    help="jobs allowed to queue for the accelerator; "
                         "POSTs beyond it get 503 + Retry-After")
    ap.add_argument("--preload", action="store_true",
                    help="warm up the default serving shape "
                         "(512x512/150f/25step) before accepting traffic")
    ap.add_argument("--preload-shape", default=None, metavar="SIZExLENxSTEPS",
                    help="override the preload shape, e.g. 512x48x25")
    args = ap.parse_args(argv)

    from aniportrait_tpu_torch.scripts.serving_core import load_serving_models

    models = load_serving_models(
        args.config, random_init=args.random_init, size=args.size, device=args.device
    )
    if args.preload or args.preload_shape:
        size, length, steps = (
            map(int, args.preload_shape.split("x"))
            if args.preload_shape
            else (512, 150, 25)
        )
        preload_warmup(models, size=size, steps=steps, length=length)
    httpd = build_server(
        model_handlers(models), host=args.host, port=args.port,
        out_dir=args.out_dir, max_queue=args.max_queue,
    )
    print(f"serving on http://{args.host}:{args.port}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
