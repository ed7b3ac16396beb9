"""Browser viewer: orbit camera + live render + actor/time/lidar controls
(torch port of `neurad_tpu/viewer/server.py`: the same page, endpoints,
request and response JSON, resolutions, payload cap, per-client stale drop
and train-rate control).

Counterpart of `nerfstudio/viewer/` (Viewer `viewer.py:58`,
RenderStateMachine `render_state_machine.py:57-120`, LidarRenderer 361-451,
actor-edit sliders from DynamicActors, export panel). A self-contained stdlib
HTTP server + embedded JS page: the browser posts camera poses, the server
renders through the model under a lock (the reference's train_lock) with
resolution adaptation — low-res while the camera moves, full-res when static
(the low_move/low_static/high FSM). PNGs are encoded by `data/png.py`.

A render, lidar or export callback that raises fails its request: the
exception leaves the handler, the lock is released and the connection closes
without a reply (no blank or cached image stands in for it).

Endpoints:
  GET  /         the viewer page
  POST /render   {pose, quality, t01, edits, client, seq} -> {png} or {stale}
  POST /lidar    {t01, channels, fov_up, fov_down, azim_res, drop_threshold}
                 -> {pts: [[x,y,z,intensity], ...]} (virtual-lidar render)
  POST /export   {} -> {path} (server-side pointcloud export hook)
  POST /train    {paused?, train_util?} -> live train stats (step, loss,
                 steps/s) — the reference's pause/resume + "train util" slider
                 (`viewer.py:58` Viewer controls, `trainer.py:171` train_lock)

Render state is PER CLIENT (the reference keeps one RenderStateMachine per
websocket client, `render_state_machine.py:57`): each client stamps its
requests with a monotonically increasing seq; when a newer request from the
same client has already arrived, the older one returns {stale} WITHOUT taking
the train lock — dragging the camera can't queue up a backlog of renders that
starves training or other clients.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from neurad_tpu_torch.data.png import encode_png, quantise

_PAGE = """<!DOCTYPE html>
<html><head><title>neurad_tpu viewer</title><style>
body { margin:0; background:#111; color:#eee; font-family:monospace; }
#hud { position:absolute; top:8px; left:8px; background:#000a; padding:8px; border-radius:6px; }
canvas { display:block; }
input[type=range] { width: 160px; vertical-align: middle; }
.row { margin: 2px 0; }
button { background:#333; color:#eee; border:1px solid #666; border-radius:4px; }
</style></head><body>
<div id="hud">
  <div>neurad_tpu viewer &mdash; drag orbit, wheel zoom, shift-drag pan</div>
  <div class="row">time <input type="range" id="time" min="0" max="1" step="0.01" value="0"><span id="tv">0</span></div>
  <details><summary>actor edits</summary>
    <div class="row">lateral <input type="range" id="ed_lat" min="-5" max="5" step="0.1" value="0"><span id="v_lat">0</span>m</div>
    <div class="row">longitudinal <input type="range" id="ed_lon" min="-5" max="5" step="0.1" value="0"><span id="v_lon">0</span>m</div>
    <div class="row">rotation <input type="range" id="ed_rot" min="-3.14" max="3.14" step="0.05" value="0"><span id="v_rot">0</span>rad</div>
    <div class="row">height <input type="range" id="ed_hei" min="-2" max="2" step="0.1" value="0"><span id="v_hei">0</span>m</div>
    <div class="row">actor index <input type="number" id="ed_idx" min="-1" value="-1" style="width:50px"> (-1 = all)</div>
    <div class="row">rolling shutter <input type="range" id="ed_rs" min="-0.05" max="0.05" step="0.005" value="0"><span id="v_rs">0</span>s</div>
  </details>
  <details><summary>virtual lidar</summary>
    <div class="row"><label><input type="checkbox" id="lidar_on"> show point cloud</label></div>
    <div class="row">channels <input type="number" id="li_ch" min="4" max="128" value="32" style="width:50px"></div>
    <div class="row">azim res <input type="number" id="li_az" min="0.2" max="5" step="0.2" value="1.0" style="width:50px">deg</div>
    <div class="row">drop thresh <input type="range" id="li_dt" min="0" max="1" step="0.05" value="0.5"><span id="v_dt">0.5</span></div>
  </details>
  <details open><summary>training</summary>
    <div class="row"><button id="pause">pause</button>
      util <input type="range" id="t_util" min="0.1" max="1" step="0.05" value="0.9"><span id="v_util">0.90</span></div>
    <div class="row" id="t_stats"></div>
  </details>
  <div class="row"><button id="export">export pointcloud</button> <span id="exp_out"></span></div>
  <div id="status"></div>
</div>
<canvas id="c"></canvas>
<script>
const canvas = document.getElementById('c');
const ctx = document.getElementById('c').getContext('2d');
let az = 0.5, el = 0.3, dist = 30, target = [10, 0, 1], drag = null, timer = null;
let t01 = 0, lidarPts = null;
function edits() {
  return {lateral: +ed_lat.value, longitudinal: +ed_lon.value, rotation: +ed_rot.value,
          height: +ed_hei.value, index: parseInt(ed_idx.value), rs: +ed_rs.value};
}
function pose() {
  const ce = Math.cos(el), se = Math.sin(el), ca = Math.cos(az), sa = Math.sin(az);
  const eye = [target[0] + dist*ce*ca, target[1] + dist*ce*sa, target[2] + dist*se];
  const f = [(target[0]-eye[0])/dist, (target[1]-eye[1])/dist, (target[2]-eye[2])/dist];
  const up = [0,0,1];
  let r = [f[1]*up[2]-f[2]*up[1], f[2]*up[0]-f[0]*up[2], f[0]*up[1]-f[1]*up[0]];
  const rn = Math.hypot(...r); r = r.map(x=>x/rn);
  const u = [r[1]*f[2]-r[2]*f[1], r[2]*f[0]-r[0]*f[2], r[0]*f[1]-r[1]*f[0]];
  return [[r[0], u[0], -f[0], eye[0]], [r[1], u[1], -f[1], eye[1]], [r[2], u[2], -f[2], eye[2]]];
}
function drawLidar() {
  if (!lidarPts) return;
  const p = pose(), w = canvas.width, h = canvas.height, focal = 0.7*w;
  // world -> cam: R^T (x - t)
  for (const q of lidarPts) {
    const d = [q[0]-p[0][3], q[1]-p[1][3], q[2]-p[2][3]];
    const xc = p[0][0]*d[0]+p[1][0]*d[1]+p[2][0]*d[2];
    const yc = p[0][1]*d[0]+p[1][1]*d[1]+p[2][1]*d[2];
    const zc = p[0][2]*d[0]+p[1][2]*d[1]+p[2][2]*d[2];
    if (zc > -0.1) continue;
    const u = w/2 + focal*xc/(-zc), v = h/2 - focal*yc/(-zc);
    if (u < 0 || u >= w || v < 0 || v >= h) continue;
    ctx.fillStyle = `rgba(${Math.floor(80+170*q[3])},255,120,0.8)`;
    ctx.fillRect(u, v, 2, 2);
  }
}
const clientId = Math.random().toString(36).slice(2);
let seq = 0;
async function render(hi) {
  const res = await fetch('/render', {method:'POST', body: JSON.stringify(
    {pose: pose(), quality: hi?'high':'low', t01, edits: edits(),
     client: clientId, seq: ++seq})});
  const data = await res.json();
  if (data.stale) return;  // a newer request from this client superseded it
  const img = new Image();
  img.onload = () => { canvas.width = window.innerWidth; canvas.height = window.innerHeight;
    ctx.imageSmoothingEnabled = false;
    ctx.drawImage(img, 0, 0, canvas.width, canvas.height); drawLidar(); };
  img.src = 'data:image/png;base64,' + data.png;
  document.getElementById('status').textContent = data.status || '';
  if (hi && lidar_on.checked) {
    const lr = await fetch('/lidar', {method:'POST', body: JSON.stringify(
      {t01, channels: +li_ch.value, azim_res: +li_az.value, drop_threshold: +li_dt.value, edits: edits()})});
    lidarPts = (await lr.json()).pts; drawLidar();
  } else if (!lidar_on.checked) lidarPts = null;
}
function queueRender() {
  render(false);
  clearTimeout(timer);
  timer = setTimeout(() => render(true), 400);
}
canvas.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) { target[0] -= dx*0.05; target[2] += dy*0.05; }
  else { az -= dx*0.01; el = Math.max(-1.4, Math.min(1.4, el + dy*0.01)); }
  drag = [e.clientX, e.clientY, drag[2]];
  queueRender();
};
window.onwheel = e => { dist = Math.max(2, dist * (1 + e.deltaY*0.001)); queueRender(); };
for (const [id, lab] of [['time','tv'],['ed_lat','v_lat'],['ed_lon','v_lon'],['ed_rot','v_rot'],['ed_hei','v_hei'],['ed_rs','v_rs'],['li_dt','v_dt']]) {
  document.getElementById(id).oninput = e => {
    document.getElementById(lab).textContent = (+e.target.value).toFixed(2);
    if (id === 'time') t01 = +e.target.value;
    queueRender();
  };
}
document.getElementById('ed_idx').onchange = queueRender;
document.getElementById('lidar_on').onchange = queueRender;
document.getElementById('export').onclick = async () => {
  const r = await fetch('/export', {method:'POST', body: '{}'});
  document.getElementById('exp_out').textContent = (await r.json()).path || 'n/a';
};
let paused = false;
async function postTrain(body) {
  const r = await fetch('/train', {method:'POST', body: JSON.stringify(body)});
  const s = await r.json();
  paused = s.paused;
  document.getElementById('pause').textContent = paused ? 'resume' : 'pause';
  document.getElementById('t_stats').textContent =
    `step ${s.step}  loss ${s.loss==null?'-':s.loss.toFixed(4)}  ${s.steps_per_sec.toFixed(2)} it/s`;
}
document.getElementById('pause').onclick = () => postTrain({paused: !paused});
document.getElementById('t_util').oninput = e => {
  document.getElementById('v_util').textContent = (+e.target.value).toFixed(2);
  postTrain({train_util: +e.target.value});
};
setInterval(() => postTrain({}), 2000);
queueRender();
</script></body></html>"""


class ViewerServer:
    """Serves the viewer page + render/lidar/export endpoints.

    render_fn(c2w [3,4] numpy, width, height, time01, edits: dict|None) -> rgb [H, W, 3].
    lidar_fn(time01, channels, azim_res_deg, drop_threshold, edits) -> pts [N, 4]
        (world xyz + intensity), or None when unavailable.
    export_fn() -> str path of the written artifact, or None.
    """

    def __init__(
        self,
        render_fn: Callable,
        port: int = 7007,
        train_lock: Optional[threading.Lock] = None,
        lidar_fn: Optional[Callable] = None,
        export_fn: Optional[Callable] = None,
    ):
        self.render_fn = render_fn
        self.lidar_fn = lidar_fn
        self.export_fn = export_fn
        self.port = port
        self.train_lock = train_lock or threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        # train-rate control (reference Viewer's pause + train-util slider):
        # the train loop polls train_gate() every step
        self._tstate_lock = threading.Lock()
        self._paused = False
        self._train_util = 0.9
        self._resume_evt = threading.Event()
        self._resume_evt.set()
        self._stats = {"step": 0, "loss": None, "steps_per_sec": 0.0}
        self._last_gate = None
        # per-client render state: latest seq per client id (stale-drop)
        self._client_seq: dict = {}

    # ---------------- train-rate control ----------------

    def train_gate(self) -> None:
        """Called by the train loop once per step: blocks while paused, and
        throttles to `train_util` (sleeps (1-u)/u x the measured step time so
        render requests get the remaining slice of the train lock)."""
        import time as _time

        self._resume_evt.wait()
        now = _time.perf_counter()
        with self._tstate_lock:
            util, last = self._train_util, self._last_gate
        if last is not None and util < 1.0:
            busy = now - last  # actual train time only: _last_gate is post-sleep
            _time.sleep(min(busy * (1.0 - util) / max(util, 1e-3), 1.0))
        # record AFTER the sleep so the throttle itself never counts as busy
        # time (otherwise the feedback loop overshoots geometrically for
        # util <= 0.5 until it hits the 1.0s cap)
        with self._tstate_lock:
            self._last_gate = _time.perf_counter()

    def update_train_stats(self, step: int, loss=None, steps_per_sec=None) -> None:
        with self._tstate_lock:
            self._stats["step"] = int(step)
            if loss is not None:
                self._stats["loss"] = float(loss)
            if steps_per_sec is not None:
                self._stats["steps_per_sec"] = float(steps_per_sec)

    def _train_ctl(self, req: dict) -> dict:
        with self._tstate_lock:
            if "paused" in req:
                self._paused = bool(req["paused"])
                (self._resume_evt.clear if self._paused else self._resume_evt.set)()
            if "train_util" in req:
                self._train_util = float(min(max(req["train_util"], 0.05), 1.0))
            return {
                "paused": self._paused,
                "train_util": self._train_util,
                **self._stats,
            }

    def _register_seq(self, client, seq) -> None:
        if client is None:
            return
        with self._tstate_lock:
            # LRU semantics: pop + re-insert so eviction removes the LEAST
            # RECENTLY SEEN client, not the longest-connected active one
            # (plain insertion order would evict an active client, whose next
            # out-of-order frame then passes _is_stale after re-insertion)
            prev = self._client_seq.pop(client, 0)
            self._client_seq[client] = max(seq, prev)
            # clientIds regenerate per page load; evict stalest entries so a
            # long-running viewer process doesn't grow this without bound
            while len(self._client_seq) > 64:
                self._client_seq.pop(next(iter(self._client_seq)))

    def _is_stale(self, client, seq) -> bool:
        if client is None:
            return False
        with self._tstate_lock:
            return seq < self._client_seq.get(client, 0)

    def _handler(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/train":
                    return self._reply(outer._train_ctl(req))
                if self.path == "/lidar":
                    if outer.lidar_fn is None:
                        return self._reply({"pts": []})
                    with outer.train_lock:
                        pts = outer.lidar_fn(
                            float(req.get("t01", 0.0)),
                            int(req.get("channels", 32)),
                            float(req.get("azim_res", 1.0)),
                            float(req.get("drop_threshold", 0.5)),
                            req.get("edits"),
                        )
                    pts = np.asarray(pts) if pts is not None else np.zeros((0, 4))
                    if pts.shape[0] > 20000:  # cap payload
                        pts = pts[:: pts.shape[0] // 20000 + 1]
                    return self._reply({"pts": np.round(pts, 3).tolist()})
                if self.path == "/export":
                    path = None
                    if outer.export_fn is not None:
                        with outer.train_lock:
                            path = outer.export_fn()
                    return self._reply({"path": path})

                hi = req.get("quality") == "high"
                w, h = (384, 256) if hi else (96, 64)
                client, seq = req.get("client"), int(req.get("seq", 0))
                outer._register_seq(client, seq)
                pose = np.asarray(req["pose"], dtype=np.float32)
                with outer.train_lock:
                    # re-check inside the lock: drop renders a newer request
                    # from the SAME client superseded while we queued
                    if outer._is_stale(client, seq):
                        return self._reply({"stale": True})
                    rgb = outer.render_fn(pose, w, h, float(req.get("t01", 0.0)), req.get("edits"))
                png = encode_png(quantise(np.asarray(rgb)))
                self._reply({"png": base64.b64encode(png).decode(), "status": f"{w}x{h}"})

            def log_message(self, *args):
                pass

        return Handler

    def start(self, background: bool = True):
        self._server = ThreadingHTTPServer(("0.0.0.0", self.port), self._handler())
        print(f"[viewer] http://localhost:{self.port}")
        if background:
            threading.Thread(target=self._server.serve_forever, daemon=True).start()
        else:
            self._server.serve_forever()

    def stop(self):
        if self._server:
            self._server.shutdown()
            self._server.server_close()
