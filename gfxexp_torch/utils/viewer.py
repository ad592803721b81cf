"""Lightweight progressive viewer for headless rendering (port of
gfxexp_tpu/utils/viewer.py).

The reference is an interactive GLFW/ImGui app (path_tracing_main.cpp:
663-857); a headless GPU server has no display, so the viewer is a
streaming one: the render loop pushes progressive accumulation snapshots
and a small HTTP server in the standard library serves an auto-refreshing
page; open http://localhost:<port> in any browser. The server binds the
loopback interface unless told otherwise (JAX's binds every interface):
forward the port over SSH to view it from another machine.

Input path (reference parity: WASD + mouse camera and ImGui toggles,
path_tracing_main.cpp:1359-1680): the page captures mouse drags (orbit),
wheel (dolly), WASD/QE (pan) and panel controls, POSTs them to /control as
JSON events, and the render loop drains them with `drain_events()` between
frames — camera moves then rebuild the camera and reset accumulation
exactly like the reference's resetAccumulation-on-move.
"""

from __future__ import annotations

import json
import threading


class LiveViewer:
    """Serves the latest pushed image at / (HTML wrapper) and /frame.png,
    and queues /control POST events for the render loop.

    Usage:
        viewer = LiveViewer(port=8716)   # prints the URL
        for f in range(frames):
            for ev in viewer.drain_events():
                ...  # apply orbit/dolly/pan/toggle
            viewer.update(np.asarray(film.beauty), frame=f)
    """

    def __init__(self, port: int = 8716, refresh_ms: int = 500,
                 title: str = "gfxexp_torch", host: str = "127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._png = b""
        self._frame = 0
        self._lock = threading.Lock()
        self._events = []
        self._pick = ""

        viewer = self

        page = f"""<!doctype html><html><head><title>{title}</title>
<style>body{{background:#111;color:#ccc;font-family:monospace;
text-align:center}}img{{image-rendering:pixelated;max-width:95vw;
max-height:80vh;cursor:grab}}#panel{{margin:6px}}button{{margin:2px}}
</style></head><body>
<h3>{title} — frame <span id=f>0</span></h3>
<div id=panel>
 drag: orbit &nbsp; wheel: dolly &nbsp; WASD/QE: pan &nbsp;
 <button onclick="send({{action:'toggle',bit:0}})">NEE</button>
 <button onclick="send({{action:'toggle',bit:1}})">implicit</button>
 <button onclick="send({{action:'toggle',bit:2}})">RR</button>
 <button onclick="send({{action:'reset'}})">reset accum</button>
 brightness <input id=br type=range min=-3 max=3 step=0.1 value=0
  oninput="send({{action:'brightness',log2:parseFloat(this.value)}})">
</div>
<img id=im src=/frame.png draggable=false>
<pre id=pick style="text-align:left;margin:8px auto;max-width:60em"></pre>
<script>
const send=(ev)=>fetch('/control',{{method:'POST',
  body:JSON.stringify(ev)}});
let drag=null;
const im=document.getElementById('im');
im.addEventListener('mousedown',e=>{{
  if(e.shiftKey){{const r=im.getBoundingClientRect();
    send({{action:'pick',u:(e.clientX-r.left)/r.width,
          v:(e.clientY-r.top)/r.height}});return;}}
  drag=[e.clientX,e.clientY];}});
window.addEventListener('mouseup',()=>{{drag=null;}});
window.addEventListener('mousemove',e=>{{if(!drag)return;
  const dx=e.clientX-drag[0],dy=e.clientY-drag[1];drag=[e.clientX,e.clientY];
  send({{action:'orbit',dx:dx,dy:dy}});}});
im.addEventListener('wheel',e=>{{e.preventDefault();
  send({{action:'dolly',amount:Math.sign(e.deltaY)}});}});
window.addEventListener('keydown',e=>{{
  const k=e.key.toLowerCase();
  const m={{w:[0,0,1],s:[0,0,-1],a:[-1,0,0],d:[1,0,0],q:[0,-1,0],
           e:[0,1,0]}};
  if(m[k])send({{action:'pan',v:m[k]}});}});
setInterval(()=>{{im.src='/frame.png?'+Date.now();
fetch('/meta').then(r=>r.text()).then(t=>
  document.getElementById('f').textContent=t);
fetch('/pick').then(r=>r.text()).then(t=>
  document.getElementById('pick').textContent=t);}},{refresh_ms});
</script></body></html>"""

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with viewer._lock:
                        data = viewer._png
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path.startswith("/meta"):
                    self.send_response(200)
                    self.end_headers()
                    self.wfile.write(str(viewer._frame).encode())
                elif self.path.startswith("/pick"):
                    self.send_response(200)
                    self.end_headers()
                    with viewer._lock:
                        self.wfile.write(viewer._pick.encode())
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(page.encode())

            def do_POST(self):
                if not self.path.startswith("/control"):
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if not (0 <= n <= 65536):
                        raise ValueError("oversized control event")
                    ev = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(ev, dict):
                        raise ValueError("a control event is an object")
                except ValueError:
                    self.send_response(400)
                    self.end_headers()
                    return
                with viewer._lock:
                    viewer._events.append(ev)
                self.send_response(204)
                self.end_headers()

            def log_message(self, *a):  # quiet
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        print(f"live viewer: http://localhost:{self.port}/", flush=True)

    def set_pick(self, info):
        """Publish the latest pick-info dict (shown on the page and at
        GET /pick) — the reference's pick-under-cursor readback
        (path_tracing_main.cpp:1541-1567)."""
        with self._lock:
            self._pick = json.dumps(info, indent=1)

    def drain_events(self):
        """All control events POSTed since the last call (render-loop poll)."""
        with self._lock:
            evs, self._events = self._events, []
        return evs

    def update(self, image, frame: int = 0, brightness: float = 1.0):
        """image: [H, W, 3] linear float. Tonemapped (x/(1+x)) + sRGB."""
        import numpy as np

        from gfxexp_torch.utils.image_io import encode_png

        img = np.asarray(image, np.float32) * brightness
        img = img / (1.0 + img)
        data = encode_png(img, apply_srgb=True)
        with self._lock:
            self._png = data
            self._frame = int(frame)

    def close(self):
        """Stop serving and release the port."""
        self._server.shutdown()
        self._server.server_close()


class CameraRig:
    """Orbit-camera state driven by viewer control events (the analogue of
    the reference's WASD + mouse camera state machine,
    path_tracing_main.cpp:1359-1436). Owns (position, target, up); applies
    orbit/dolly/pan events and reports whether the camera changed so the
    app can rebuild it and reset accumulation."""

    def __init__(self, position, target, up=(0.0, 1.0, 0.0),
                 orbit_speed: float = 0.005, pan_speed: float = 0.05,
                 dolly_base: float = 1.12):
        import numpy as np

        self.position = np.asarray(position, np.float64).copy()
        self.target = np.asarray(target, np.float64).copy()
        self.up = np.asarray(up, np.float64)
        self.orbit_speed = orbit_speed
        self.pan_speed = pan_speed
        self.dolly_base = dolly_base
        self.brightness = 1.0
        self.debug_switches = 0
        self.reset_requested = False
        self.pick_requests = []  # (u, v) normalized image coords

    def _frame(self):
        import numpy as np

        fwd = self.target - self.position
        dist = max(float(np.linalg.norm(fwd)), 1e-9)
        fwd = fwd / dist
        right = np.cross(fwd, self.up)
        right /= max(float(np.linalg.norm(right)), 1e-9)
        upv = np.cross(right, fwd)
        return fwd, right, upv, dist

    def apply(self, events) -> bool:
        """Apply drained viewer events; True when the CAMERA changed
        (accumulation must reset). Toggle/brightness events mutate
        debug_switches/brightness without invalidating accumulation
        (brightness is display-only; switches do invalidate — treated as
        camera-changed)."""
        import numpy as np

        changed = False
        for ev in events:
            a = ev.get("action")
            if a == "orbit":
                fwd, right, upv, dist = self._frame()
                yaw = -float(ev.get("dx", 0.0)) * self.orbit_speed
                pitch = -float(ev.get("dy", 0.0)) * self.orbit_speed
                v = self.position - self.target
                cy, sy = np.cos(yaw), np.sin(yaw)
                # yaw about the up axis
                v = (v * cy + np.cross(self.up, v) * sy
                     + self.up * np.dot(self.up, v) * (1 - cy))
                # pitch about the right axis, clamped near the poles
                cp, sp = np.cos(pitch), np.sin(pitch)
                v2 = (v * cp + np.cross(right, v) * sp
                      + right * np.dot(right, v) * (1 - cp))
                cos_pole = abs(np.dot(v2 / max(np.linalg.norm(v2), 1e-9),
                                      self.up))
                if cos_pole < 0.99:
                    v = v2
                self.position = self.target + v
                changed = True
            elif a == "dolly":
                f = self.dolly_base ** float(ev.get("amount", 0.0))
                self.position = self.target + (self.position
                                               - self.target) * f
                changed = True
            elif a == "pan":
                fwd, right, upv, dist = self._frame()
                vx, vy, vz = (float(x) for x in ev.get("v", (0, 0, 0)))
                step = (right * vx + upv * vy + fwd * vz) * \
                    (self.pan_speed * dist)
                self.position = self.position + step
                self.target = self.target + step
                changed = True
            elif a == "toggle":
                self.debug_switches ^= 1 << int(ev.get("bit", 0))
                changed = True
            elif a == "brightness":
                self.brightness = float(2.0 ** float(ev.get("log2", 0.0)))
            elif a == "pick":
                self.pick_requests.append((float(ev.get("u", 0.5)),
                                           float(ev.get("v", 0.5))))
            elif a == "reset":
                self.reset_requested = True
                changed = True
        return changed

    def take_picks(self):
        picks, self.pick_requests = self.pick_requests, []
        return picks

    def make_camera(self, fov_y, aspect):
        """The port's Camera at the rig's position and target, on the
        CPU."""
        from gfxexp_torch.render.camera import make_camera

        return make_camera(self.position.tolist(), fov_y=fov_y,
                           aspect=aspect, target=self.target.tolist())
