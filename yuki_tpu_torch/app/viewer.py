"""Interactive viewer: port of ``yuki_tpu/app/viewer.py``, a lightweight
web front end.

The reference's interactive layer is an imgui/glium GL window
(app/window.rs, app/ui.rs); the equivalent surface is a local HTTP viewer:
a live progressive image, render controls (integrator, sampler, spp,
resolution, tone map), camera orbit and dolly, render and kill buttons,
Ctrl+click debug rays and the BVH overlay.  Renders run through the
threaded ``Renderer`` on the scene's device (the card unless the caller
passes ``device="cpu"``); the page is yuki_tpu's, unchanged.

Three threads use the device: the HTTP handler threads (debug rays, the
BVH overlay, PNG and EXR requests), the renderer's manager thread and the
server thread; the counters and caches they share take locks
(``ops/_build.bump``, ``vecmath.const``, the kernel library's build).  The
film is read back once a PNG or EXR request, under ``ViewerState.lock``,
and tone-mapped on the host.  The PNG is encoded with the standard
library (``zlib``, one IDAT chunk), from yuki_tpu's sRGB formula.
"""

from __future__ import annotations

import json
import struct
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..camera import Camera, FoV
from ..device import resolve_device
from ..film import FilmSettings, film_or_new
from ..integrators import PathParams, WhittedParams
from ..integrators.debug_rays import (DebugRay, collect_debug_rays,
                                      collect_debug_rays_whitted,
                                      project_segments)
from ..renderer import (RenderError, Renderer, RenderFinished, RenderProgress,
                        RenderSettings)
from ..sampling import SampleCtx, StratifiedSampler, UniformSampler
from ..tonemap import FilmicParams, HeatmapParams, filmic, heatmap
from .settings import VIEW_NAMES, InitialSettings, save_settings
from .util import try_load_scene, write_exr

_PAGE = """<!DOCTYPE html>
<html><head><title>yuki-tpu</title>
<style>
 body { background:#181818; color:#ddd; font-family:monospace; margin:0; display:flex; }
 #panel { width: 320px; padding: 12px; background:#222; min-height:100vh; }
 #panel label { display:block; margin-top:8px; font-size: 12px; }
 #panel input, #panel select { width: 95%; background:#333; color:#ddd; border:1px solid #555; }
 #img { image-rendering: pixelated; max-width: calc(100vw - 360px); }
 button { margin-top:10px; background:#2a6; border:0; color:#fff; padding:6px 14px; cursor:pointer; }
 button.red { background:#a33; }
 #status { white-space: pre; font-size: 11px; margin-top: 10px; color:#9c9; }
</style></head>
<body>
<div id="panel">
 <h3>yuki-tpu</h3>
 <label>Integrator
  <select id="integrator">
   <option>Path</option><option>Whitted</option>
   <option>GeometryNormals</option><option>ShadingNormals</option>
   <option>ShadingUVs</option><option>BVHIntersections</option>
  </select></label>
 <label>Max depth <input id="max_depth" type="number" value="3" min="1" max="12"></label>
 <label>Sampler
  <select id="sampler"><option>Stratified</option><option>Uniform</option></select></label>
 <label>Samples/pixel <input id="spp" type="number" value="4" min="1" max="4096"></label>
 <label>Resolution <input id="res" value="640x480"></label>
 <label>Exposure <input id="exposure" type="number" step="0.1" value="1.0"></label>
 <label>Tonemap
  <select id="tonemap"><option>Filmic</option><option>Raw</option><option>Heatmap</option></select></label>
 <label><input id="accumulate" type="checkbox" style="width:auto"> accumulate</label>
 <label><input id="quarter" type="checkbox" style="width:auto"> 1/16 res preview</label>
 <button onclick="render()">Render</button>
 <button class="red" onclick="fetch('/kill', {method:'POST'})">Kill</button>
 <button onclick="fetch('/save_exr', {method:'POST', body: JSON.stringify({tonemapped: false})})">EXR raw</button>
 <button onclick="fetch('/save_exr', {method:'POST', body: JSON.stringify({tonemapped: true})})">EXR tonemapped</button>
 <button onclick="fetch('/save_settings', {method:'POST'})">Save settings</button>
 <div id="status">idle</div>
 <h4>Debug</h4>
 <label>BVH vis level <input id="bvh_level" type="number" value="-1" min="-1" max="40"></label>
 <div style="font-size:11px">ctrl-click image: debug ray</div>
 <h4>Camera</h4>
 <label>Position <input id="cam_pos" value="%CAM_POS%"></label>
 <label>Target <input id="cam_target" value="%CAM_TARGET%"></label>
 <label>FoV <input id="cam_fov" type="number" value="%CAM_FOV%"></label>
 <div style="font-size:11px;margin-top:6px">drag: orbit &middot; shift/middle-drag: pan &middot; wheel: dolly</div>
 <h4>Scene</h4>
 <label>BVH split
  <select id="split_method">
   <option>SurfaceAreaHeuristic</option><option>Middle</option>
   <option>EqualCounts</option>
  </select></label>
 <label>Max shapes in node <input id="max_shapes" type="number" value="1" min="1" max="64"></label>
 <button onclick="reloadScene()">Reload scene</button>
 <div id="scene_stats" style="white-space:pre;font-size:11px;margin-top:8px;color:#acd"></div>
</div>
<div style="position:relative">
 <img id="img" src="/image.png">
 <svg id="overlay" style="position:absolute;left:0;top:0;pointer-events:none"></svg>
</div>
<script>
async function render() {
  const body = {
    integrator: document.getElementById('integrator').value,
    max_depth: +document.getElementById('max_depth').value,
    sampler: document.getElementById('sampler').value,
    spp: +document.getElementById('spp').value,
    res: document.getElementById('res').value,
    exposure: +document.getElementById('exposure').value,
    tonemap: document.getElementById('tonemap').value,
    accumulate: document.getElementById('accumulate').checked,
    sixteenth: document.getElementById('quarter').checked,
    cam_pos: document.getElementById('cam_pos').value,
    cam_target: document.getElementById('cam_target').value,
    cam_fov: +document.getElementById('cam_fov').value,
  };
  await fetch('/render', {method:'POST', body: JSON.stringify(body)});
}
document.getElementById('img').addEventListener('click', async (e) => {
  if (!e.ctrlKey) return;
  const img = e.target;
  const r = img.getBoundingClientRect();
  const fx = (e.clientX - r.left) / r.width;
  const fy = (e.clientY - r.top) / r.height;
  const segs = await (await fetch('/debug_ray', {method:'POST',
    body: JSON.stringify({fx, fy})})).json();
  drawSegs(segs.segments, r.width / segs.res[0], r.height / segs.res[1]);
});
function drawSegs(segs, sx, sy) {
  const svg = document.getElementById('overlay');
  const img = document.getElementById('img');
  svg.setAttribute('width', img.clientWidth);
  svg.setAttribute('height', img.clientHeight);
  svg.innerHTML = segs.map(s =>
    `<line x1="${s.x0*sx}" y1="${s.y0*sy}" x2="${s.x1*sx}" y2="${s.y1*sy}"
      stroke="rgb(${s.color.map(c=>c*255).join(',')})" stroke-width="1"/>`).join('');
}
document.getElementById('bvh_level').addEventListener('change', async (e) => {
  const lvl = +e.target.value;
  if (lvl < 0) { document.getElementById('overlay').innerHTML = ''; return; }
  const img = document.getElementById('img').getBoundingClientRect();
  const segs = await (await fetch('/bvh?level=' + lvl)).json();
  drawSegs(segs.segments, img.width / segs.res[0], img.height / segs.res[1]);
});
setInterval(async () => {
  const s = await (await fetch('/status')).json();
  document.getElementById('status').textContent = s.text;
  if (s.dirty) document.getElementById('img').src = '/image.png?' + Date.now();
}, 500);

// Scene panel (reference ui.rs:298-575: BVH split method, max shapes in
// node, live scene stats).
async function loadStats() {
  const s = await (await fetch('/scene_stats')).json();
  document.getElementById('scene_stats').textContent = s.text;
  document.getElementById('split_method').value = s.split_method;
  document.getElementById('max_shapes').value = s.max_shapes;
}
async function reloadScene() {
  document.getElementById('scene_stats').textContent = 'reloading...';
  await fetch('/reload_scene', {method:'POST', body: JSON.stringify({
    split_method: document.getElementById('split_method').value,
    max_shapes: +document.getElementById('max_shapes').value,
  })});
  await loadStats();
  render();
}
loadStats();

// Camera mouse gestures (reference window.rs drag handling): left drag =
// trackball orbit around the target, middle or shift+left drag = pan in
// the view plane, wheel = dolly along the view direction.  Each gesture
// edits the cam_pos/cam_target fields and debounce-retriggers the render
// (the reference's 32 ms settings debounce; we use 300 ms since every
// render is a full device dispatch).
const camEls = {
  pos: document.getElementById('cam_pos'),
  tgt: document.getElementById('cam_target'),
};
function getVec(el) { return el.value.split(',').map(Number); }
function setVec(el, v) { el.value = v.map(x => x.toFixed(3)).join(','); }
const sub = (a,b) => a.map((x,i) => x - b[i]);
const add = (a,b) => a.map((x,i) => x + b[i]);
const scale = (a,s) => a.map(x => x * s);
const lenv = a => Math.hypot(...a);
const norm = a => scale(a, 1 / (lenv(a) || 1));
const cross = (a,b) => [a[1]*b[2]-a[2]*b[1], a[2]*b[0]-a[0]*b[2], a[0]*b[1]-a[1]*b[0]];
let renderTimer = null;
function queueRender() {
  clearTimeout(renderTimer);
  renderTimer = setTimeout(render, 300);
}
function orbit(dx, dy) {
  const pos = getVec(camEls.pos), tgt = getVec(camEls.tgt);
  const v = sub(pos, tgt), r = lenv(v);
  let theta = Math.atan2(v[0], v[2]);
  let phi = Math.acos(Math.max(-1, Math.min(1, v[1] / (r || 1))));
  theta -= dx * 0.01;
  phi = Math.max(0.05, Math.min(Math.PI - 0.05, phi - dy * 0.01));
  setVec(camEls.pos, add(tgt, [r*Math.sin(phi)*Math.sin(theta),
                               r*Math.cos(phi),
                               r*Math.sin(phi)*Math.cos(theta)]));
  queueRender();
}
function pan(dx, dy) {
  const pos = getVec(camEls.pos), tgt = getVec(camEls.tgt);
  const fwd = norm(sub(tgt, pos)), dist = lenv(sub(tgt, pos));
  const right = norm(cross(fwd, [0,1,0]));
  const up = cross(right, fwd);
  const delta = add(scale(right, -dx * dist * 0.002),
                    scale(up, dy * dist * 0.002));
  setVec(camEls.pos, add(pos, delta));
  setVec(camEls.tgt, add(tgt, delta));
  queueRender();
}
function dolly(steps) {
  const pos = getVec(camEls.pos), tgt = getVec(camEls.tgt);
  const v = sub(pos, tgt);
  const r = Math.max(1e-3, lenv(v) * Math.pow(1.1, steps));
  setVec(camEls.pos, add(tgt, scale(norm(v), r)));
  queueRender();
}
let drag = null;
const imgEl = document.getElementById('img');
imgEl.addEventListener('mousedown', e => {
  if (e.ctrlKey) return;  // ctrl+click = debug ray
  drag = {x: e.clientX, y: e.clientY,
          pan: e.button === 1 || e.shiftKey};
  e.preventDefault();
});
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan) pan(dx, dy); else orbit(dx, dy);
});
window.addEventListener('mouseup', () => { drag = null; });
imgEl.addEventListener('wheel', e => {
  e.preventDefault();
  dolly(Math.sign(e.deltaY));
});
imgEl.addEventListener('dragstart', e => e.preventDefault());
</script>
</body></html>
"""


_BOX_EDGES = ((0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 7),
              (5, 1), (5, 4), (5, 7), (6, 2), (6, 4), (6, 7))


def srgb_bytes(img: np.ndarray) -> np.ndarray:
    """[H,W,3] f32 display values -> uint8 sRGB, by yuki_tpu's formula
    (viewer.py:466-471)."""
    srgb = np.where(img <= 0.0031308, 12.92 * img,
                    1.055 * np.clip(img, 0, 1) ** (1 / 2.4) - 0.055)
    return (np.clip(srgb, 0, 1) * 255).astype(np.uint8)


def encode_png(rgb: np.ndarray) -> bytes:
    """[H,W,3] uint8 -> PNG bytes: IHDR (8-bit RGB), one zlib IDAT of the
    rows each behind filter byte 0, IEND."""
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(rgb, np.uint8).reshape(h, -1)],
                         axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


class ViewerState:
    """The viewer's scene, film, renderer and last render settings, on
    ``device`` (None: the card)."""

    def __init__(self, settings: InitialSettings, device=None):
        self.settings = settings
        self.device = resolve_device(device)
        self.scene, self.cam_params, _scene_fs, self.load_secs = (
            try_load_scene(settings.load_settings, device=self.device))
        self.film = None
        self.renderer = Renderer()
        self.status_text = "idle"
        self.tonemap_kind = "Filmic"
        self.exposure = 1.0
        self.lock = threading.Lock()
        self.last_res = (640, 480)
        self.last_depth = 3
        self.last_integrator = "Path"
        self.last_camera = None

    def start_render(self, cfg: dict):
        res = cfg.get("res", "640x480")
        try:
            rx, ry = (int(v) for v in res.lower().split("x"))
        except ValueError:
            rx, ry = 640, 480
        fs = FilmSettings(
            res=(rx, ry),
            accumulate=bool(cfg.get("accumulate")),
            sixteenth_res=bool(cfg.get("sixteenth")),
        )
        kind = cfg.get("integrator", "Path")
        depth = int(cfg.get("max_depth", 3))
        if kind == "Path":
            integrator = PathParams(max_depth=depth)
        elif kind == "Whitted":
            integrator = WhittedParams(max_depth=depth)
        else:
            integrator = VIEW_NAMES[kind]
        spp = int(cfg.get("spp", 4))
        if cfg.get("sampler", "Stratified") == "Uniform":
            sampler = UniformSampler(pixel_samples=spp)
        else:
            side = max(1, int(round(spp ** 0.5)))
            sampler = StratifiedSampler(pixel_samples_x=side,
                                        pixel_samples_y=side)
        self.tonemap_kind = cfg.get("tonemap", "Filmic")
        self.exposure = float(cfg.get("exposure", 1.0))
        cam = self.cam_params
        for key, attr in (("cam_pos", "position"), ("cam_target", "target")):
            if cfg.get(key):
                try:
                    vals = tuple(float(v) for v in cfg[key].split(","))
                    setattr(cam, attr, vals)
                except ValueError:
                    pass
        if cfg.get("cam_fov"):
            cam.fov = FoV(cam.fov.axis, float(cfg["cam_fov"]))
        with self.lock:
            rx_eff, ry_eff = fs.effective_res()
            self.last_res = (rx_eff, ry_eff)
            self.last_depth = depth
            self.last_integrator = kind
            self.last_camera = Camera.create(cam, rx_eff, ry_eff)
            self.film = film_or_new(self.film, fs, device=self.device)
            # Synchronous status flip: pollers must never read the
            # previous render's terminal "done" line as this one's.
            self.status_text = "rendering..."
            self.renderer.launch(
                self.scene, cam, self.film, sampler, integrator, fs,
                RenderSettings(),
            )

    def poll(self) -> dict:
        dirty = False
        for msg in self.renderer.check_status():
            if isinstance(msg, RenderProgress):
                self.status_text = (
                    f"{msg.tiles_done}/{msg.tiles_total} tiles\n"
                    f"{msg.rays_per_sec / 1e6:.2f} Mrays/s\n"
                    f"ETA {msg.approx_remaining_s:.1f}s"
                )
                dirty = True
            elif isinstance(msg, RenderFinished):
                self.status_text = (
                    f"done: {msg.ray_count / 1e6:.2f} Mrays in "
                    f"{msg.elapsed_s:.2f}s\n"
                    f"{msg.ray_count / max(msg.elapsed_s, 1e-9) / 1e6:.2f} "
                    "Mrays/s"
                )
                dirty = True
            elif isinstance(msg, RenderError):
                self.status_text = f"error: {msg.message}"
                dirty = True
        return {"text": self.status_text, "dirty": dirty}

    def _camera(self):
        rx, ry = self.last_res
        if self.last_camera is None:
            self.last_camera = Camera.create(self.cam_params, rx, ry)
        return self.last_camera, rx, ry

    def debug_ray(self, fx: float, fy: float) -> dict:
        """Ctrl+click debug ray (window.rs:595-614 + 811-905): trace the
        path for the clicked film pixel, return projected segments.
        Whitted renders get the Whitted walk (both specular branches,
        whitted.rs:73-181); everything else the path walk."""
        camera, rx, ry = self._camera()
        px = int(min(max(fx * rx, 0), rx - 1))
        py = int(min(max(fy * ry, 0), ry - 1))
        dev = self.device
        ctx = SampleCtx(px=torch.tensor([px], dtype=torch.int32, device=dev),
                        py=torch.tensor([py], dtype=torch.int32, device=dev),
                        sample_index=0, seed=0)
        o, d = camera.ray(torch.tensor([[px + 0.5, py + 0.5]],
                                       dtype=torch.float32, device=dev))
        collect = (collect_debug_rays_whitted
                   if self.last_integrator == "Whitted"
                   else collect_debug_rays)
        rays = collect(self.scene.data, self.scene.meta,
                       PathParams(self.last_depth), UniformSampler(1), ctx,
                       o.contiguous(), d.contiguous())[0]
        return {"segments": project_segments(camera, rx, ry, rays),
                "res": [rx, ry]}

    def bvh_level(self, level: int) -> dict:
        """BVH node box wireframes at a tree level
        (renderpasses/bvh_visualization.rs:28-85), at most 256 boxes."""
        camera, rx, ry = self._camera()
        lo, hi = self.scene.bvh_host.node_bounds(level)
        rays = []
        for bb_lo, bb_hi in zip(lo[:256], hi[:256]):
            c = [np.array([x, y, z])
                 for x in (bb_lo[0], bb_hi[0])
                 for y in (bb_lo[1], bb_hi[1])
                 for z in (bb_lo[2], bb_hi[2])]
            for a, b in _BOX_EDGES:
                rays.append(DebugRay(c[a], c[b], "reflection"))
        return {"segments": project_segments(camera, rx, ry, rays),
                "res": [rx, ry]}

    def reload_scene(self, cfg: dict) -> None:
        """Rebuild the scene with new BVH options (ui.rs:298-370: the
        split-method combo and the max-shapes drag trigger a reload)."""
        ls = self.settings.load_settings
        if cfg.get("split_method") in (
            "SurfaceAreaHeuristic", "Middle", "EqualCounts"
        ):
            ls.split_method = cfg["split_method"]
        if cfg.get("max_shapes"):
            ls.max_shapes_in_node = max(1, min(64, int(cfg["max_shapes"])))
        with self.lock:
            self.renderer.kill()
            self.scene, self.cam_params, _, self.load_secs = try_load_scene(
                ls, device=self.device)
            self.film = None
            self.last_camera = None

    def scene_stats(self) -> dict:
        """The live scene stats block (ui.rs:468-575: shape and light
        counts, BVH shape, load time)."""
        m = self.scene.meta
        bh = self.scene.bvh_host
        n_nodes = int(bh.node_lo.shape[0]) if bh is not None else 0
        text = (
            f"scene: {m.name}\n"
            f"triangles: {m.n_tris}\n"
            f"spheres: {m.n_spheres}\n"
            f"lights: {m.n_lights}\n"
            f"materials: {m.n_materials}\n"
            f"bvh nodes: {n_nodes} (max leaf {m.bvh_max_leaf})\n"
            f"traversal: {m.traversal}\n"
            f"loaded in {self.load_secs:.2f}s"
        )
        ls = self.settings.load_settings
        return {
            "text": text,
            "split_method": ls.split_method,
            "max_shapes": ls.max_shapes_in_node,
        }

    def _film_image(self):
        """The film's sample-normalised image read back to the host once
        (None before the first render).  Call under ``lock``."""
        if self.film is None:
            return None
        return self.film.image_device().cpu()

    def save_exr(self, tonemapped: bool) -> str:
        """EXR export (window.rs:943-982) into the working directory: the
        raw sample-normalised radiance or the Filmic display image."""
        with self.lock:
            img = self._film_image()
        if img is None:
            return ""
        if tonemapped:
            img = filmic(img, FilmicParams(exposure=self.exposure))
        path = "render_tonemapped.exr" if tonemapped else "render.exr"
        write_exr(path, img)
        return path

    def display_image(self) -> np.ndarray:
        """The film as the page shows it before the sRGB encode: [H,W,3] f32
        tone-mapped by the last render's choice (640x480 black before the
        first render)."""
        with self.lock:
            img = self._film_image()
        if img is None:
            return np.zeros((480, 640, 3), np.float32)
        if self.tonemap_kind == "Filmic":
            img = filmic(img, FilmicParams(exposure=self.exposure))
        elif self.tonemap_kind == "Heatmap":
            mn = float(img.min())
            mx = float(img.max())
            img = heatmap(img, HeatmapParams(min_val=mn,
                                             max_val=max(mx, mn + 1e-6)))
        return img.numpy()

    def image_png(self) -> bytes:
        return encode_png(srgb_bytes(self.display_image()))


def make_server(settings: InitialSettings, port: int = 8000,
                state: "ViewerState | None" = None,
                device=None) -> ThreadingHTTPServer:
    """Build the viewer's HTTP server on 127.0.0.1 without entering
    serve_forever, so that endpoint tests can run it on an ephemeral port
    exactly as ``serve`` does.  The state's scene lives on ``device``
    (None: the card) unless a ``state`` is given."""
    state = state or ViewerState(settings, device=device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj):
            self._send(200, "application/json", json.dumps(obj).encode())

        def do_GET(self):
            if self.path.startswith("/image.png"):
                self._send(200, "image/png", state.image_png())
            elif self.path.startswith("/status"):
                self._json(state.poll())
            elif self.path.startswith("/scene_stats"):
                self._json(state.scene_stats())
            elif self.path.startswith("/bvh"):
                q = parse_qs(urlparse(self.path).query)
                self._json(state.bvh_level(int(q.get("level", ["0"])[0])))
            else:
                cam = state.cam_params
                page = (
                    _PAGE
                    .replace("%CAM_POS%", ",".join(
                        f"{v:.3f}" for v in cam.position))
                    .replace("%CAM_TARGET%", ",".join(
                        f"{v:.3f}" for v in cam.target))
                    .replace("%CAM_FOV%", f"{cam.fov.degrees:g}")
                )
                self._send(200, "text/html", page.encode())

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n) if n else b"{}"
            cfg = json.loads(body or b"{}")
            if self.path == "/render":
                state.start_render(cfg)
                self._json({})
            elif self.path == "/debug_ray":
                self._json(state.debug_ray(float(cfg.get("fx", 0.5)),
                                           float(cfg.get("fy", 0.5))))
            elif self.path == "/reload_scene":
                state.reload_scene(cfg)
                self._json({})
            elif self.path == "/kill":
                state.renderer.kill()
                self._json({})
            elif self.path == "/save_exr":
                self._json({"path": state.save_exr(
                    bool(cfg.get("tonemapped")))})
            elif self.path == "/save_settings":
                save_settings(state.settings, "settings.yaml")
                self._json({})
            else:
                self._send(404, "text/plain", b"")

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    server.viewer_state = state  # test/introspection handle
    return server


def serve(settings: InitialSettings, port: int = 8000, device=None):
    """Serve the viewer on 127.0.0.1:``port`` (0: any free port) until
    interrupted; prints the URL first."""
    server = make_server(settings, port, device=device)
    print(f"yuki-tpu viewer on http://127.0.0.1:{server.server_address[1]}",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.viewer_state.renderer.kill()
        server.server_close()
