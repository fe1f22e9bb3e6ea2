"""Web frontend (reference ``app.py`` Streamlit role) on the stdlib: the
port of ``fvd_tpu/ui/web.py``.

Serves a single-page app with:

* an input form (video path, debug toggle, progressive mode);
* a live dependency-aware status board + SVG DAG render, polling
  ``GET /status`` (the board logic is the shared
  :class:`fvd_tpu_torch.runtime.status.StatusBoard`, reference app.py:224-313);
* a results panel: verdict card (FAKE if p > 0.5, app.py:332-334), feature
  metrics, claims & evidence, transcript/OCR, raw state.

No Streamlit/Flask dependency: ``http.server`` + a worker thread running the
real Scheduler stream, or :func:`fvd_tpu_torch.streaming.analyze_progressive`
in progressive mode, on the manager's ``device`` (default the card).

The port's artifacts are PNG keyframes and crops and PNG-in-AVI viz files,
where the JAX package writes JPEG and mp4: ``/artifact`` serves ``.png`` as
``image/png`` and ``.avi`` as ``video/x-msvideo``, and the page links the viz
files (a browser does not play PNG-in-AVI) where the JAX page embeds them.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.graph import NODE_ORDER, build_graph
from fvd_tpu_torch.nodes.c1_lipsync import calculate_mar
from fvd_tpu_torch.runtime.scheduler import Scheduler
from fvd_tpu_torch.runtime.status import StatusBoard
from fvd_tpu_torch.state import State
from fvd_tpu_torch.streaming import analyze_progressive


class RunManager:
    """One analysis run at a time on ``device`` (default the card); thread-safe
    snapshots for polling."""

    def __init__(self, config: Optional[Config] = None, providers=None, device=None):
        self.config = config or default_config()
        self.providers = providers
        self.device = device
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.reset()

    def _graph(self):
        return build_graph(self.config, self.providers, device=self.device)

    def reset(self):
        dag = self._graph()
        self.board = StatusBoard(NODE_ORDER, dag.edges())
        self.running = False
        self.error: Optional[str] = None
        self.result: Optional[Dict[str, Any]] = None
        self.progressive: List[Dict[str, Any]] = []
        self.input_path = ""

    def graph_layout(self) -> Dict[str, Any]:
        dag = self._graph()
        depth: Dict[str, int] = {}
        for name in dag.topological_order():
            deps = dag.nodes[name].deps
            depth[name] = 1 + max((depth[d] for d in deps), default=-1)
        cols: Dict[int, List[str]] = {}
        for n, d in depth.items():
            cols.setdefault(d, []).append(n)
        pos = {}
        for d, nodes in cols.items():
            for i, n in enumerate(nodes):
                pos[n] = {"x": 90 + d * 130, "y": 50 + i * 62}
        return {"nodes": pos, "edges": dag.edges()}

    def start(self, input_path: str, label: Optional[int], debug: bool) -> bool:
        with self._lock:
            if self.running:
                return False
            self.reset()
            self.running = True
            self.input_path = input_path

        def work():
            state = State(input_path=input_path, debug=debug)
            if label is not None:
                state.label = label
            try:
                for ev in Scheduler(self._graph()).stream(state):
                    if ev.node == "__end__":
                        if ev.status == "error":
                            with self._lock:
                                self.error = ev.error
                        else:
                            final = ev.delta["__final_state__"]
                            with self._lock:
                                self.result = _summarize(final)
                    elif ev.status == "done":
                        with self._lock:
                            self.board.mark_done([ev.node])
                    elif ev.status == "error":
                        with self._lock:
                            self.error = f"{ev.node}: {ev.error}"
            finally:
                with self._lock:
                    self.running = False

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def start_progressive(self, input_path: str, chunk_seconds: float = 5.0) -> bool:
        """Streaming mode: per-chunk running probability instead of the DAG
        (``fvd_tpu_torch.streaming``; the CLI's --stream analog)."""
        with self._lock:
            if self.running:
                return False
            self.reset()
            self.running = True
            self.input_path = input_path

        def work():
            try:
                last = None
                for u in analyze_progressive(input_path, config=self.config,
                                             providers=self.providers,
                                             chunk_seconds=chunk_seconds,
                                             device=self.device):
                    last = u
                    with self._lock:
                        self.progressive.append({
                            "t": round(u.t_end, 2),
                            "fraction": round(u.fraction, 3),
                            "p": u.fake_probability,
                            "lip_sync": u.features["lip_sync"],
                        })
                with self._lock:
                    if last is None:
                        self.error = ("progressive mode needs a local video "
                                      "and a landmark model")
                    else:
                        p = last.fake_probability
                        self.result = {
                            "fake_probability": p,
                            "verdict": "FAKE" if p > 0.5 else "REAL",
                            "features": last.features,
                            "metadata": {"duration": last.t_end},
                            "keyframes": 0, "faces": 0, "claims": [],
                            "transcript": "", "ocr_text": [], "signals": {},
                            "frames": [], "viz": {}, "data_dir": "",
                        }
            except Exception as e:  # surfaced via /status
                with self._lock:
                    self.error = repr(e)
            finally:
                with self._lock:
                    self.running = False

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "running": self.running,
                "input": self.input_path,
                "statuses": self.board.statuses(),
                "error": self.error,
                "result": self.result,
                "progressive": list(self.progressive),
            }


def _downsample(values: List[float], limit: int = 200) -> List[float]:
    if len(values) <= limit:
        return [float(v) for v in values]
    step = len(values) / limit
    return [float(values[int(i * step)]) for i in range(limit)]


def _summarize(state: State) -> Dict[str, Any]:
    p = state.fake_probability
    meta = state.metadata or {}
    claims = []
    for c in state.claims or []:
        if isinstance(c, dict):
            claims.append(
                {
                    "text": c.get("claim_text") or c.get("text", ""),
                    "verdict": c.get("verdict", "?"),
                    "score": c.get("evidence_score", 0.0),
                    "evidence_count": c.get("evidence_count", 0),
                }
            )
    ocr_text = []
    for fr in state.ocr_results or []:
        ocr_text.extend(d.get("text", "") for d in fr.get("detections", []))

    # Signals tab (reference app.py "Signals"): envelope, EAR track, MAR
    # track, pose angles — downsampled for the sparkline renderer.
    signals: Dict[str, List[float]] = {}
    if state.audio_envelope:
        signals["audio_envelope"] = _downsample(list(state.audio_envelope))
    if state.blink_data:
        signals["ear"] = _downsample([b.get("ear", 0.0) for b in state.blink_data])
    if state.mouth_landmarks:
        signals["mar"] = _downsample(
            [
                m["mar"] if "mar" in m else (calculate_mar(m.get("landmarks") or []) or 0.0)
                for m in state.mouth_landmarks
            ]
        )
    for angle in ("yaw", "pitch", "roll"):
        if state.head_pose_data:
            signals[angle] = _downsample(
                [h.get("pose", {}).get(angle, 0.0) for h in state.head_pose_data]
            )

    # Frames & Faces tab: keyframe/crop artifact paths served via /artifact.
    frames = []
    for det in (state.face_detections or [])[:24]:
        frames.append(
            {
                "frame_id": det.get("frame_id"),
                "timestamp": det.get("timestamp"),
                "keyframe": det.get("keyframe_path"),
                "crops": [f.get("crop_path") for f in det.get("faces", [])
                          if f.get("crop_path")],
            }
        )

    # Raw-state tab: JSON-safe dump, long lists truncated.
    raw: Dict[str, Any] = {}
    for key, value in state.to_dict().items():
        if isinstance(value, list) and len(value) > 20:
            value = value[:20] + [f"... ({len(value)} items total)"]
        try:
            json.dumps(value)
            raw[key] = value
        except TypeError:
            raw[key] = f"<non-JSON: {type(value).__name__}>"

    return {
        "fake_probability": p,
        "verdict": "FAKE" if (p or 0.0) > 0.5 else "REAL",
        "features": state.features,
        "metadata": {
            "duration": meta.get("duration"),
            "fps": meta.get("fps"),
            "size": meta.get("size"),
            "title": meta.get("title"),
        },
        "transcript": (state.transcript or "")[:2000],
        "ocr_text": ocr_text[:50],
        "claims": claims,
        "keyframes": len(state.keyframes or []),
        "faces": sum(len(d.get("faces", [])) for d in (state.face_detections or [])),
        "lip_sync_score": state.lip_sync_score,
        "texture_ela_score": state.texture_ela_score,
        "data_dir": state.data_dir,
        "signals": signals,
        "frames": frames,
        "viz": {
            "landmarks": state.mouth_landmarks_viz_path,
            "headpose": state.headpose_viz_path,
        },
        "raw_state": raw,
    }


PAGE = """<!DOCTYPE html>
<html><head><title>Fake Video Detection Engine (PyTorch/CUDA)</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 2em; background: #111; color: #eee; }
 input[type=text] { width: 30em; padding: 6px; background:#222; color:#eee; border:1px solid #555; }
 button { padding: 6px 16px; }
 .done { fill: #2a4; } .running { fill: #fa0; } .queued { fill: #444; }
 .node-label { fill: #fff; font-size: 12px; text-anchor: middle; dominant-baseline: middle; }
 .edge { stroke: #666; stroke-width: 1.2; fill: none; marker-end: url(#arr); }
 .card { border: 1px solid #444; border-radius: 8px; padding: 1em; margin: 1em 0; }
 .fake { color: #f55; font-size: 1.6em; font-weight: bold; }
 .real { color: #5f5; font-size: 1.6em; font-weight: bold; }
 table { border-collapse: collapse; } td, th { border: 1px solid #444; padding: 4px 10px; }
 .bar { height: 8px; background: #39f; display: inline-block; vertical-align: middle; }
</style></head>
<body>
<h2>Fake Video Detection Engine <small style="color:#888">PyTorch/CUDA</small></h2>
<form onsubmit="start(); return false;">
  <input type="text" id="path" placeholder="video path or URL">
  <label><input type="checkbox" id="debug"> debug</label>
  <label><input type="checkbox" id="stream"> progressive</label>
  <select id="label"><option value="">no label</option><option value="0">real (0)</option><option value="1">fake (1)</option></select>
  <button type="submit">Analyze</button>
</form>
<div id="progressive"></div>
<svg id="dag" width="900" height="460">
  <defs><marker id="arr" markerWidth="8" markerHeight="8" refX="7" refY="3" orient="auto">
    <path d="M0,0 L7,3 L0,6" fill="none" stroke="#666"/></marker></defs>
</svg>
<div id="error" style="color:#f66"></div>
<div id="result"></div>
<script>
function esc(v) {
  return String(v ?? '').replace(/&/g, '&amp;').replace(/</g, '&lt;')
    .replace(/>/g, '&gt;').replace(/"/g, '&quot;').replace(/'/g, '&#39;');
}
let layout = null;
async function loadGraph() {
  layout = await (await fetch('/graph')).json();
  const svg = document.getElementById('dag');
  for (const [src, dst] of layout.edges) {
    const a = layout.nodes[src], b = layout.nodes[dst];
    const e = document.createElementNS('http://www.w3.org/2000/svg', 'path');
    e.setAttribute('d', `M ${a.x+28} ${a.y} C ${(a.x+b.x)/2} ${a.y}, ${(a.x+b.x)/2} ${b.y}, ${b.x-30} ${b.y}`);
    e.setAttribute('class', 'edge');
    svg.appendChild(e);
  }
  for (const [name, p] of Object.entries(layout.nodes)) {
    const c = document.createElementNS('http://www.w3.org/2000/svg', 'ellipse');
    c.setAttribute('cx', p.x); c.setAttribute('cy', p.y);
    c.setAttribute('rx', 28); c.setAttribute('ry', 18);
    c.setAttribute('id', 'node-' + name); c.setAttribute('class', 'queued');
    svg.appendChild(c);
    const t = document.createElementNS('http://www.w3.org/2000/svg', 'text');
    t.setAttribute('x', p.x); t.setAttribute('y', p.y);
    t.setAttribute('class', 'node-label'); t.textContent = name;
    svg.appendChild(t);
  }
}
async function start() {
  const path = document.getElementById('path').value;
  const debug = document.getElementById('debug').checked;
  const stream = document.getElementById('stream').checked;
  const label = document.getElementById('label').value;
  await fetch('/analyze?path=' + encodeURIComponent(path) +
              '&debug=' + debug + '&stream=' + stream +
              (label ? '&label=' + label : ''), {method: 'POST'});
  poll();
}
async function poll() {
  const s = await (await fetch('/status')).json();
  for (const [name, st] of Object.entries(s.statuses)) {
    const el = document.getElementById('node-' + name);
    if (el) el.setAttribute('class', st);
  }
  document.getElementById('error').textContent = s.error || '';
  if (s.progressive && s.progressive.length) {
    const last = s.progressive[s.progressive.length - 1];
    document.getElementById('progressive').innerHTML =
      '<div class="card"><h3>Progressive analysis</h3>' +
      sparkline('running fake_probability', s.progressive.map(u => u.p)) +
      sparkline('running lip_sync', s.progressive.map(u => u.lip_sync)) +
      `<div>t=${esc(last.t)}s (${(last.fraction * 100).toFixed(0)}%) · ` +
      `p=${last.p.toFixed(4)}</div></div>`;
  }
  if (s.result) render(s.result);
  if (s.running) setTimeout(poll, 500);
}
function render(r) {
  let h = `<div class="card"><span class="${r.verdict === 'FAKE' ? 'fake' : 'real'}">${r.verdict}</span>
    &nbsp; fake_probability = ${(r.fake_probability ?? 0).toFixed(4)}
    <div>duration ${esc(r.metadata.duration ?? '?')}s · fps ${esc(r.metadata.fps ?? '?')} ·
     keyframes ${r.keyframes} · faces ${r.faces}</div></div>`;
  if (r.features) {
    h += '<div class="card"><h3>Features</h3><table>';
    for (const [k, v] of Object.entries(r.features))
      h += `<tr><td>${esc(k)}</td><td>${v.toFixed(4)}</td>
            <td><span class="bar" style="width:${Math.min(100, v*100)}px"></span></td></tr>`;
    h += '</table></div>';
  }
  if (r.claims && r.claims.length) {
    h += '<div class="card"><h3>Claims &amp; Evidence</h3><table><tr><th>claim</th><th>verdict</th><th>score</th><th>sources</th></tr>';
    for (const c of r.claims)
      h += `<tr><td>${esc(c.text)}</td><td>${esc(c.verdict)}</td><td>${esc(c.score)}</td><td>${esc(c.evidence_count)}</td></tr>`;
    h += '</table></div>';
  }
  if (r.transcript) h += `<div class="card"><h3>Transcript</h3><p>${esc(r.transcript)}</p></div>`;
  if (r.ocr_text && r.ocr_text.length)
    h += `<div class="card"><h3>On-screen text</h3><p>${esc(r.ocr_text.join(' · '))}</p></div>`;
  if (r.signals && Object.keys(r.signals).length) {
    h += '<div class="card"><h3>Signals</h3>';
    for (const [name, vals] of Object.entries(r.signals)) h += sparkline(name, vals);
    h += '</div>';
  }
  if (r.frames && r.frames.length) {
    h += '<div class="card"><h3>Frames &amp; Faces</h3><div style="display:flex;flex-wrap:wrap;gap:6px">';
    for (const fr of r.frames) {
      h += `<div style="text-align:center"><img src="/artifact?path=${encodeURIComponent(fr.keyframe)}"
            style="height:80px"><br><small>t=${(fr.timestamp ?? 0).toFixed(1)}s</small></div>`;
      for (const c of fr.crops.slice(0, 2))
        h += `<img src="/artifact?path=${encodeURIComponent(c)}" style="height:80px">`;
    }
    h += '</div></div>';
  }
  if (r.viz && (r.viz.landmarks || r.viz.headpose)) {
    h += '<div class="card"><h3>Media</h3>';
    for (const [name, path] of Object.entries(r.viz))
      if (path) h += `<div>${esc(name)}: <a href="/artifact?path=${encodeURIComponent(path)}"
        download>${esc(path.split('/').pop())}</a> (PNG-in-AVI)</div>`;
    h += '</div>';
  }
  if (r.raw_state)
    h += `<div class="card"><details><summary>Raw state</summary>
      <pre style="max-height:400px;overflow:auto">${esc(JSON.stringify(r.raw_state, null, 1))}</pre></details></div>`;
  h += `<div class="card">artifacts: <code>${esc(r.data_dir)}</code></div>`;
  document.getElementById('result').innerHTML = h;
}
function sparkline(name, vals) {
  const w = 360, hh = 42;
  const mn = Math.min(...vals), mx = Math.max(...vals);
  const span = (mx - mn) || 1;
  const pts = vals.map((v, i) =>
    `${(i / (vals.length - 1 || 1) * w).toFixed(1)},${(hh - 4 - (v - mn) / span * (hh - 8)).toFixed(1)}`
  ).join(' ');
  return `<div><small>${esc(name)} [${mn.toFixed(2)} … ${mx.toFixed(2)}]</small><br>
    <svg width="${w}" height="${hh}"><polyline points="${pts}"
    fill="none" stroke="#39f" stroke-width="1.5"/></svg></div>`;
}
loadGraph().then(poll);
</script>
</body></html>
"""


def make_handler(manager: RunManager):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            parsed = urlparse(self.path)
            if parsed.path == "/":
                body = PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif parsed.path == "/status":
                self._json(manager.snapshot())
            elif parsed.path == "/graph":
                self._json(manager.graph_layout())
            elif parsed.path == "/artifact":
                self._artifact(parse_qs(parsed.query).get("path", [""])[0])
            else:
                self._json({"error": "not found"}, 404)

        def _artifact(self, rel_path: str):
            """Serve a run artifact; restricted to the current run's
            data_dir (no traversal outside it)."""
            snap = manager.snapshot()
            data_dir = (snap.get("result") or {}).get("data_dir")
            if not data_dir or not rel_path:
                self._json({"error": "no artifact"}, 404)
                return
            base = os.path.realpath(data_dir)
            target = os.path.realpath(rel_path)
            if not target.startswith(base + os.sep) and target != base:
                self._json({"error": "forbidden"}, 403)
                return
            if not os.path.isfile(target):
                self._json({"error": "not found"}, 404)
                return
            ctype = "application/octet-stream"
            if target.endswith(".png"):
                ctype = "image/png"
            elif target.endswith(".avi"):
                ctype = "video/x-msvideo"
            elif target.endswith((".json", ".txt")):
                ctype = "text/plain"
            with open(target, "rb") as f:
                body = f.read()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path == "/analyze":
                q = parse_qs(parsed.query)
                path = q.get("path", [""])[0]
                if not path:
                    self._json({"error": "path required"}, 400)
                    return
                debug = q.get("debug", ["false"])[0] == "true"
                label_raw = q.get("label", [None])[0]
                label = int(label_raw) if label_raw in ("0", "1") else None
                if q.get("stream", ["false"])[0] == "true":
                    chunk = float(q.get("chunk", ["5.0"])[0])
                    started = manager.start_progressive(path, chunk_seconds=chunk)
                else:
                    started = manager.start(path, label, debug)
                self._json({"started": started})
            else:
                self._json({"error": "not found"}, 404)

        def log_message(self, *args):  # quiet
            pass

    return Handler


def serve_web(
    host: str = "127.0.0.1",
    port: int = 8861,
    config: Optional[Config] = None,
    providers=None,
    prefill_url: Optional[str] = None,
    block: bool = True,
    device=None,
):
    """The web UI at ``http://host:port/`` (``port=0``: a free port), its
    runs on ``device`` (default the card); with ``block=False`` it returns
    ``(server, manager)`` without serving, for the caller's own thread."""
    manager = RunManager(config, providers, device)
    server = ThreadingHTTPServer((host, port), make_handler(manager))
    print(f"Serving frontend at http://{host}:{server.server_address[1]}/")
    if prefill_url:
        manager.start(prefill_url, None, False)
    if block:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            print("\nFrontend closed.")
    return server, manager
