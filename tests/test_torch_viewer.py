"""Endpoint tests of the port's web viewer (yuki_tpu_torch/app/viewer.py),
tests/test_viewer.py's cases on a ThreadingHTTPServer on an ephemeral
port with ``device="cpu"``, tiny Cornell renders; no JAX.

Also: the PNG decoded (by PIL, here only) equals yuki_tpu's sRGB formula
(yuki_tpu/app/viewer.py:466-471) over the port's tone-mapped film, the
port's encoder imports no PIL, requests made during a render neither
break it nor change its film, and ``python -m yuki_tpu_torch --device
cpu`` with no ``--out`` serves the viewer.  Every request and wait has its
own deadline.
"""

import io
import json
import os
import queue
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from yuki_tpu_torch.app.settings import InitialSettings
from yuki_tpu_torch.app.viewer import encode_png, make_server

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def server():
    # Empty load path -> the built-in Cornell box.
    srv = make_server(InitialSettings(), port=0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.viewer_state.renderer.kill()
    srv.shutdown()
    srv.server_close()


def _url(server, path):
    return f"http://127.0.0.1:{server.server_address[1]}{path}"


def _get(server, path, timeout=60):
    with urllib.request.urlopen(_url(server, path), timeout=timeout) as r:
        return r.status, r.read()


def _post(server, path, body=None, timeout=60):
    data = json.dumps(body or {}).encode()
    req = urllib.request.Request(_url(server, path), data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


_SMALL = {
    "integrator": "Path", "max_depth": 2, "sampler": "Uniform",
    "spp": 1, "res": "64x48", "exposure": 1.0, "tonemap": "Filmic",
}


def _render_and_wait(server, cfg=None, timeout=60.0):
    code, _ = _post(server, "/render", {**_SMALL, **(cfg or {})})
    assert code == 200
    deadline = time.monotonic() + timeout
    msg = None
    while time.monotonic() < deadline:
        _, body = _get(server, "/status", timeout=10)
        msg = json.loads(body)
        assert not msg["text"].startswith("error"), msg
        if msg["text"].startswith("done"):
            return msg
        time.sleep(0.05)
    raise AssertionError(f"render did not finish: {msg}")


def test_index_page(server):
    code, body = _get(server, "/")
    assert code == 200
    assert b"yuki-tpu" in body
    assert b"%CAM_POS%" not in body and b"%CAM_FOV%" not in body


def test_render_poll_image(server):
    """The PNG equals yuki_tpu's formula over the port's Filmic film."""
    from PIL import Image

    from yuki_tpu_torch.tonemap import FilmicParams, filmic

    msg = _render_and_wait(server, {"exposure": 1.5})
    assert "Mrays" in msg["text"]
    code, body = _get(server, "/image.png?1")
    assert code == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
    state = server.viewer_state
    assert state.film.res == (64, 48)
    img = filmic(state.film.image_device(), FilmicParams(exposure=1.5))
    img = img.numpy()
    srgb = np.where(img <= 0.0031308, 12.92 * img,
                    1.055 * np.clip(img, 0, 1) ** (1 / 2.4) - 0.055)
    want = (np.clip(srgb, 0, 1) * 255).astype(np.uint8)
    got = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    assert got.shape == (48, 64, 3)
    assert np.array_equal(got, want)
    assert want.max() > 100


def test_png_encoder_without_pil():
    """encode_png round-trips through PIL's decoder, and a process that
    encodes a PNG has not imported PIL."""
    from PIL import Image

    rgb = np.random.default_rng(1).integers(0, 256, (7, 5, 3), np.uint8)
    back = np.asarray(Image.open(io.BytesIO(encode_png(rgb))))
    assert np.array_equal(back, rgb)
    code = ("import sys, numpy as np; from yuki_tpu_torch.app import viewer; "
            "viewer.encode_png(np.zeros((2, 3, 3), np.uint8)); "
            "print('PIL' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_debug_ray_projection(server):
    _render_and_wait(server)
    code, body = _post(server, "/debug_ray", {"fx": 0.5, "fy": 0.5})
    assert code == 200
    out = json.loads(body)
    assert out["res"] == [64, 48]
    segs = out["segments"]
    # The centre of Cornell hits the back wall: at least its normal and a
    # shadow segment, which start on the wall at the film's centre.
    assert len(segs) >= 2
    for s in segs:
        assert set(s) >= {"x0", "y0", "x1", "y1", "color", "type"}
    assert abs(segs[0]["x0"] - 32) < 2 and abs(segs[0]["y0"] - 24) < 2
    assert "shadow" in {s["type"] for s in segs}


def test_debug_ray_whitted(server):
    """After a Whitted render the debug ray takes the Whitted walk."""
    _render_and_wait(server, {"integrator": "Whitted", "max_depth": 3})
    _, body = _post(server, "/debug_ray", {"fx": 0.75, "fy": 0.8})
    segs = json.loads(body)["segments"]
    assert server.viewer_state.last_integrator == "Whitted"
    assert len(segs) >= 2


def test_bvh_level_overlay(server):
    _render_and_wait(server)
    code, body = _get(server, "/bvh?level=1")
    assert code == 200
    out = json.loads(body)
    # Each box draws 12 edges.
    assert len(out["segments"]) >= 12
    assert len(out["segments"]) % 12 == 0


def test_scene_stats(server):
    code, body = _get(server, "/scene_stats")
    assert code == 200
    out = json.loads(body)
    assert "triangles: 36" in out["text"]
    assert out["split_method"] in (
        "SurfaceAreaHeuristic", "Middle", "EqualCounts"
    )


def test_save_exr_roundtrip(server, tmp_path, monkeypatch):
    from yuki_tpu_torch.app.exr import read_exr
    from yuki_tpu_torch.tonemap import FilmicParams, filmic

    _render_and_wait(server)
    monkeypatch.chdir(tmp_path)
    code, body = _post(server, "/save_exr", {"tonemapped": False})
    assert code == 200
    path = json.loads(body)["path"]
    assert path == "render.exr" and os.path.exists(tmp_path / path)
    img = read_exr(str(tmp_path / path))
    film = server.viewer_state.film.image_device()
    assert img.shape == (48, 64, 3)
    assert np.array_equal(img, film.numpy()) and float(img.max()) > 0.0

    code, body = _post(server, "/save_exr", {"tonemapped": True})
    tpath = json.loads(body)["path"]
    timg = read_exr(str(tmp_path / tpath))
    assert tpath == "render_tonemapped.exr"
    assert np.array_equal(timg, filmic(film, FilmicParams()).numpy())
    assert float(timg.max()) <= 1.0 + 1e-6


def test_save_settings(server, tmp_path, monkeypatch):
    from yuki_tpu_torch.app.settings import load_settings

    monkeypatch.chdir(tmp_path)
    code, _ = _post(server, "/save_settings")
    assert code == 200
    assert (tmp_path / "settings.yaml").exists()
    s = load_settings(str(tmp_path / "settings.yaml"))
    assert s is not None


def test_kill_endpoint(server):
    code, _ = _post(server, "/render", dict(_SMALL, spp=64))
    assert code == 200
    code, _ = _post(server, "/kill")
    assert code == 200
    assert not server.viewer_state.renderer.is_active()
    # A fresh render still works after the kill.
    _render_and_wait(server)


def test_requests_during_render(server):
    """Debug rays, the BVH overlay and PNGs asked for while a render runs
    neither break it nor change its film: the film equals render_frame's
    of the same settings."""
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import UniformSampler

    cfg = dict(_SMALL, res="48x32", spp=8, max_depth=3)
    code, _ = _post(server, "/render", cfg)
    assert code == 200
    for _ in range(3):
        assert _post(server, "/debug_ray", {"fx": 0.3, "fy": 0.6})[0] == 200
        assert _get(server, "/bvh?level=2")[0] == 200
        assert _get(server, "/image.png")[0] == 200
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        text = json.loads(_get(server, "/status")[1])["text"]
        assert not text.startswith("error"), text
        if text.startswith("done"):
            break
        time.sleep(0.05)
    else:
        raise AssertionError("render did not finish")
    state = server.viewer_state
    ref = render_frame(state.scene, state.cam_params,
                       FilmSettings(res=(48, 32)), UniformSampler(8),
                       PathParams(max_depth=3), seed=0)
    assert torch.equal(state.film.image_device(), ref.film.image_device())


def test_reload_scene_with_bvh_options(server):
    old_scene = server.viewer_state.scene
    code, _ = _post(
        server, "/reload_scene",
        {"split_method": "Middle", "max_shapes": 4},
    )
    assert code == 200
    state = server.viewer_state
    assert state.scene is not old_scene
    assert state.settings.load_settings.split_method == "Middle"
    assert state.settings.load_settings.max_shapes_in_node == 4
    assert state.scene.meta.bvh_max_leaf <= 4
    assert state.scene.bvh_host.node_lo.shape[0] < (
        old_scene.bvh_host.node_lo.shape[0])
    _render_and_wait(server)


def test_unknown_post_404(server):
    req = urllib.request.Request(
        _url(server, "/nope"), data=b"{}", method="POST"
    )
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 404


def test_cli_without_out_serves(tmp_path):
    """python -m yuki_tpu_torch --device cpu --port 0 (no --out) prints
    its URL and answers /status; then it is terminated."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "yuki_tpu_torch", "--device", "cpu", "--port",
         "0"], cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        url, seen = None, []
        deadline = time.monotonic() + 120
        while url is None:
            assert time.monotonic() < deadline, "".join(seen)
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                assert proc.poll() is None, "".join(seen)
                continue
            seen.append(line)
            if "viewer on http://" in line:
                url = line.strip().split("viewer on ")[1]
        with urllib.request.urlopen(url + "/status", timeout=30) as r:
            assert json.loads(r.read())["text"] == "idle"
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=20)


def test_shared_counters_under_threads():
    """The counters and the constant cache the viewer's threads share:
    16 threads (more than the cores given) bumping one counter 2,000
    times each lose no update, and asking for one new constant at once
    yields one cached tensor."""
    from yuki_tpu_torch import vecmath
    from yuki_tpu_torch.ops import _build

    counts = {"n": 0}
    like = torch.zeros(1)
    got = []
    start = threading.Barrier(16)

    def work():
        start.wait(timeout=30)
        got.append(vecmath.const(0.123456789, like))
        for _ in range(2000):
            _build.bump(counts, "n")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counts["n"] == 32000
    assert len(got) == 16 and all(c is got[0] for c in got)
