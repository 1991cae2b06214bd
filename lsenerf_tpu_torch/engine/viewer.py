"""Interactive web viewer: orbit a trained model in the browser. Port of
lsenerf_tpu/engine/viewer.py.

One thread serves a dependency-free HTML/JS orbit page; a render request
POSTs a camera-to-world matrix and is answered by the full-image renderer
(`engine/renderer.py`) with `c2w` as its pose override. The viewer offers a
fixed ladder of resolutions (a drag preview and a full render); renders
serialise on a lock (one device), and the page tags each request with a
sequence number and drops stale replies.

Replies are JPEG through PIL where it imports, as the JAX viewer sends
them; without PIL they are PNG through the port's own zlib codec
(`data/imageio.py`). The page shows either through a blob URL.
"""

from __future__ import annotations

import dataclasses
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from lsenerf_tpu_torch.cameras import cameras as cam_lib
from lsenerf_tpu_torch.data.imageio import encode_png
from lsenerf_tpu_torch.engine import evaluation as eval_lib
from lsenerf_tpu_torch.engine import renderer


def scaled_cameras(cams: cam_lib.Cameras, max_dim: int) -> cam_lib.Cameras:
    """A copy of `cams` resized so max(height, width) == max_dim, with
    intrinsics scaled to match (the same field of view)."""
    s = max_dim / max(cams.height, cams.width)
    h, w = max(1, round(cams.height * s)), max(1, round(cams.width * s))
    return dataclasses.replace(cams, fx=cams.fx * s, fy=cams.fy * s, cx=cams.cx * s,
                               cy=cams.cy * s, width=w, height=h)


def orbit_c2w(theta: float, phi: float, radius: float, target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """OpenGL-convention (3, 4) c2w on an orbit around `target`. theta:
    azimuth about +z (rad); phi: elevation from the xy-plane (rad). The JS
    c2w() in _HTML computes the same matrix."""
    target = np.asarray(target, np.float64)
    eye = target + radius * np.array([
        np.cos(phi) * np.cos(theta), np.cos(phi) * np.sin(theta), np.sin(phi)])
    z = eye - target
    z = z / np.linalg.norm(z)
    x = np.cross(np.array([0.0, 0.0, 1.0]), z)
    n = np.linalg.norm(x)
    x = np.array([1.0, 0.0, 0.0]) if n < 1e-8 else x / n  # straight up or down
    y = np.cross(z, x)
    return np.stack([x, y, z, eye], axis=1).astype(np.float32)


def default_image_format() -> str:
    """"jpeg" where PIL imports, else "png"."""
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return "png"
    return "jpeg"


class ViewerSession:
    """Holds the trained state and renders poses on demand."""

    OUTPUTS = ("rgb", "depth", "accumulation")

    def __init__(self, model_params, cams: cam_lib.Cameras, occ_state, model_config,
                 appearance_id: int = 0, resolutions=(96, 384), chunk: int = 4096,
                 image_format: str | None = None):
        """`cams` lives on the device the renders run on, with the params
        and the grid; `image_format` "jpeg" or "png" (default: jpeg where
        PIL imports)."""
        self.model_params = model_params
        self.occ_state = occ_state
        self.config = model_config
        self.appearance_id = int(appearance_id)
        self.chunk = chunk
        self.resolutions = tuple(sorted(int(r) for r in resolutions))
        self.image_format = image_format or default_image_format()
        if self.image_format not in ("jpeg", "png"):
            raise ValueError(f"unknown image format {self.image_format!r}")
        self._cams = {r: scaled_cameras(cams, r) for r in self.resolutions}
        self._lock = threading.Lock()

        # initial pose: train camera 0; the orbit's target is the point on
        # its axis nearest the centroid of all camera positions
        c2w_all = cams.camera_to_worlds.detach().cpu().double().numpy()
        c2w0, centers = c2w_all[0], c2w_all[:, :, 3]
        fwd = -c2w0[:, 2]
        t = float(np.dot(centers.mean(0) - c2w0[:, 3], fwd))
        self.radius = max(t, 0.25 * float(np.abs(centers).max() + 1e-6))
        self.target = (c2w0[:, 3] + self.radius * fwd).tolist()
        self.init_c2w = c2w0.astype(np.float32)

    def _pick_res(self, max_dim: int) -> int:
        for r in self.resolutions:
            if r >= max_dim:
                return r
        return self.resolutions[-1]

    def info(self) -> dict:
        full = self._cams[self.resolutions[-1]]
        return {
            "resolutions": list(self.resolutions),
            "width": full.width, "height": full.height,
            "outputs": list(self.OUTPUTS),
            "init_c2w": self.init_c2w.tolist(),
            "target": self.target,
            "radius": self.radius,
            "appearance_id": self.appearance_id,
            "image_format": self.image_format,
        }

    def render(self, c2w, max_dim: int, output: str = "rgb", appearance_id=None) -> np.ndarray:
        """Render one pose -> (h, w, 3) uint8."""
        if output not in self.OUTPUTS:
            raise ValueError(f"unknown output {output!r}")
        cams = self._cams[self._pick_res(max_dim)]
        app = self.appearance_id if appearance_id is None else int(appearance_id)
        with self._lock:
            out = renderer.render_image(
                self.model_params, cams, 0, self.occ_state, self.config, appearance_id=app,
                chunk=self.chunk, c2w_override=np.asarray(c2w, np.float32))
        if output == "rgb":
            img = np.clip(np.asarray(out["rgb"], np.float32), 0.0, 1.0)
        elif output == "depth":
            img = eval_lib.apply_depth_colormap(out["depth"], out["accumulation"])
        else:
            img = eval_lib.apply_colormap(out["accumulation"])
        return (img * 255.0 + 0.5).astype(np.uint8)

    def encode(self, arr: np.ndarray, quality: int = 88) -> tuple[bytes, str]:
        """(image bytes, Content-Type) of an (h, w, 3) uint8 array."""
        if self.image_format == "png":
            return encode_png(arr), "image/png"
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
        return buf.getvalue(), "image/jpeg"

    def warmup(self):
        """Render each resolution once, so that the first browser request
        does not wait on loading the kernels."""
        for r in self.resolutions:
            self.render(self.init_c2w, r)


def make_server(session: ViewerSession, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """HTTP server bound to (host, port). Routes: GET / -> the orbit page,
    GET /info -> the session's metadata as JSON, POST /render {c2w, max_dim,
    output, appearance_id, seq} -> the image (X-Render-Ms, X-Seq headers)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body: bytes, ctype: str, extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, _HTML.encode(), "text/html; charset=utf-8")
            elif self.path == "/info":
                self._send(200, json.dumps(session.info()).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/render":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", "0"))
            try:
                req = json.loads(self.rfile.read(n))
                t0 = time.perf_counter()
                body, ctype = session.encode(session.render(
                    req["c2w"], int(req.get("max_dim", 256)), req.get("output", "rgb"),
                    req.get("appearance_id")))
                ms = (time.perf_counter() - t0) * 1e3
                self._send(200, body, ctype, extra=[("X-Render-Ms", f"{ms:.1f}"),
                                                    ("X-Seq", str(req.get("seq", 0)))])
            except Exception as e:  # noqa: BLE001 — reported to the page as a 400
                self._send(400, f"{type(e).__name__}: {e}".encode(), "text/plain")

    return ThreadingHTTPServer((host, port), Handler)


def serve(session: ViewerSession, host="127.0.0.1", port=7007, warmup=True) -> None:
    srv = make_server(session, host, port)
    if warmup:
        print("[viewer] warming up the renderer...", flush=True)
        session.warmup()
    print(f"[viewer] http://{host}:{srv.server_address[1]}/", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


_HTML = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>lsenerf_tpu_torch viewer</title>
<style>
  body{margin:0;background:#111;color:#ddd;font:13px system-ui,sans-serif;
       display:flex;flex-direction:column;height:100vh}
  #bar{padding:6px 10px;display:flex;gap:12px;align-items:center;
       background:#1c1c1c;border-bottom:1px solid #333}
  #view{flex:1;display:flex;align-items:center;justify-content:center;
        overflow:hidden}
  img{max-width:100%;max-height:100%;image-rendering:auto;cursor:grab}
  select,input{background:#222;color:#ddd;border:1px solid #444;
               border-radius:3px;padding:2px 5px}
  #stat{margin-left:auto;color:#888}
</style></head><body>
<div id="bar">
  <b>lsenerf_tpu_torch</b>
  <label>output <select id="out"></select></label>
  <label>appearance <input id="app" type="number" value="0"
         style="width:4em"></label>
  <span>drag orbit &middot; shift-drag pan &middot; wheel dolly &middot;
        R reset</span>
  <span id="stat"></span>
</div>
<div id="view"><img id="img" draggable="false"></div>
<script>
let S=null, theta=0, phi=0, radius=1, target=[0,0,0];
let seq=0, shown=-1, inflight=false, queued=null, settleTimer=null;

function c2w(){
  const e=[target[0]+radius*Math.cos(phi)*Math.cos(theta),
           target[1]+radius*Math.cos(phi)*Math.sin(theta),
           target[2]+radius*Math.sin(phi)];
  let z=[e[0]-target[0],e[1]-target[1],e[2]-target[2]];
  const nz=Math.hypot(...z); z=z.map(v=>v/nz);
  let x=[-z[1],z[0],0]; const nx=Math.hypot(...x);
  x = nx<1e-8 ? [1,0,0] : x.map(v=>v/nx);
  const y=[z[1]*x[2]-z[2]*x[1], z[2]*x[0]-z[0]*x[2], z[0]*x[1]-z[1]*x[0]];
  return [[x[0],y[0],z[0],e[0]],[x[1],y[1],z[1],e[1]],[x[2],y[2],z[2],e[2]]];
}
function fromC2w(m){
  const e=[m[0][3],m[1][3],m[2][3]], z=[m[0][2],m[1][2],m[2][2]];
  target=[e[0]-radius*z[0], e[1]-radius*z[1], e[2]-radius*z[2]];
  phi=Math.asin(Math.max(-1,Math.min(1,z[2])));
  theta=Math.atan2(z[1],z[0]);
}
async function request(maxDim){
  const body={c2w:c2w(), max_dim:maxDim,
              output:document.getElementById('out').value,
              appearance_id:+document.getElementById('app').value, seq:++seq};
  if(inflight){queued=body; return}
  inflight=true;
  try{
    const r=await fetch('/render',{method:'POST',body:JSON.stringify(body)});
    if(r.ok){
      const rseq=+r.headers.get('X-Seq');
      if(rseq>shown){
        shown=rseq;
        const img=document.getElementById('img');
        const old=img.src; img.src=URL.createObjectURL(await r.blob());
        if(old) URL.revokeObjectURL(old);
        document.getElementById('stat').textContent=
          r.headers.get('X-Render-Ms')+' ms @'+body.max_dim;
      }
    } else document.getElementById('stat').textContent=await r.text();
  } finally{
    inflight=false;
    if(queued){const b=queued; queued=null; seq--; request(b.max_dim);}
  }
}
function interact(){           // preview now, full res once idle
  request(S.resolutions[0]);
  clearTimeout(settleTimer);
  settleTimer=setTimeout(()=>request(S.resolutions[S.resolutions.length-1]),
                         350);
}
const img=document.getElementById('img');
let drag=null;
img.addEventListener('pointerdown',e=>{
  drag={x:e.clientX,y:e.clientY,pan:e.shiftKey}; img.setPointerCapture(e.pointerId);});
img.addEventListener('pointermove',e=>{
  if(!drag) return;
  const dx=e.clientX-drag.x, dy=e.clientY-drag.y; drag.x=e.clientX; drag.y=e.clientY;
  if(drag.pan){
    const m=c2w(), s=0.0015*radius;
    target=[target[0]-s*(dx*m[0][0]-dy*m[0][1]),
            target[1]-s*(dx*m[1][0]-dy*m[1][1]),
            target[2]-s*(dx*m[2][0]-dy*m[2][1])];
  } else {
    theta-=dx*0.008;
    phi=Math.max(-1.55,Math.min(1.55,phi+dy*0.008));
  }
  interact();
});
img.addEventListener('pointerup',()=>{drag=null});
document.addEventListener('wheel',e=>{
  radius*=Math.exp(e.deltaY*0.0012); interact();},{passive:true});
document.addEventListener('keydown',e=>{
  if(e.key==='r'||e.key==='R'){fromC2w(S.init_c2w); radius=S.radius;
    target=[...S.target]; interact();}});
document.getElementById('out').addEventListener('change',interact);
document.getElementById('app').addEventListener('change',interact);
fetch('/info').then(r=>r.json()).then(s=>{
  S=s; radius=s.radius; target=[...s.target];
  const sel=document.getElementById('out');
  s.outputs.forEach(o=>{const e=document.createElement('option');
    e.textContent=o; sel.appendChild(e);});
  document.getElementById('app').value=s.appearance_id;
  fromC2w(s.init_c2w);
  request(s.resolutions[s.resolutions.length-1]);
});
</script></body></html>
"""
