"""Interactive HTML replay of a recorded closed-loop run (port of
``tools/replay_html.py``).

Loads a stats directory in the reference's six-array schema, rebuilds the
robot's joint positions of every kept frame with this package's forward
kinematics (``dynamics/kinematics.py::joint_frames``, on ``--device``),
and writes ONE self-contained HTML file: a 3-D stick-figure animation with
the commanded figure-8, the achieved end-effector trace, play/pause/scrub
and drag-to-orbit, viewable in any browser with no server.  The page and
its embedded data have the layout of the TPU package's tool, so the two
replays of one recording agree (positions rounded to 4 places).

Usage: python3 -m indy7_mpc_tpu_torch.tools.replay_html STATS_DIR
           [--stem HHMMSS] [--every 4] [--out replay.html] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np
import torch

from ..dynamics.kinematics import joint_frames
from ..examples import protocol
from ..models import indy7

TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>indy7-mpc-tpu replay</title>
<style>
 body {{ margin:0; background:#14171c; color:#cfd6e1;
        font:13px system-ui, sans-serif; }}
 #hud {{ position:fixed; top:10px; left:12px; }}
 #bar {{ position:fixed; bottom:10px; left:12px; right:12px;
        display:flex; gap:10px; align-items:center; }}
 #scrub {{ flex:1; }}
 canvas {{ display:block; width:100vw; height:100vh; }}
 button {{ background:#2a3140; color:#cfd6e1; border:1px solid #3c4557;
          border-radius:4px; padding:4px 12px; cursor:pointer; }}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">{title}<br><span id="t"></span></div>
<div id="bar"><button id="play">pause</button>
<input id="scrub" type="range" min="0" max="{maxframe}" value="0"></div>
<script>
const DATA = {data};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let frame = 0, playing = true, yaw = -0.9, pitch = 0.35, dist = 2.2;
const center = [0, 0.25, 0.45];
function resize() {{ cv.width = innerWidth; cv.height = innerHeight; }}
addEventListener('resize', resize); resize();
let dragging = false, px = 0, py = 0;
cv.addEventListener('mousedown', e => {{ dragging = true; px = e.clientX; py = e.clientY; }});
addEventListener('mouseup', () => dragging = false);
addEventListener('mousemove', e => {{
  if (!dragging) return;
  yaw += (e.clientX - px) * 0.008; pitch += (e.clientY - py) * 0.008;
  pitch = Math.max(-1.4, Math.min(1.4, pitch)); px = e.clientX; py = e.clientY;
}});
cv.addEventListener('wheel', e => {{ dist *= Math.exp(e.deltaY * 0.001); }});
function proj(p) {{
  const x = p[0] - center[0], y = p[1] - center[1], z = p[2] - center[2];
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x1 = cy * x + sy * y, y1 = -sy * x + cy * y;
  const y2 = cp * y1 - sp * z, z2 = sp * y1 + cp * z;
  const s = Math.min(cv.width, cv.height) / dist;
  return [cv.width / 2 + x1 * s, cv.height / 2 - z2 * s, y2];
}}
function polyline(pts, color, width, closeAlpha) {{
  ctx.strokeStyle = color; ctx.lineWidth = width; ctx.beginPath();
  for (let i = 0; i < pts.length; i++) {{
    const q = proj(pts[i]);
    if (i === 0) ctx.moveTo(q[0], q[1]); else ctx.lineTo(q[0], q[1]);
  }}
  ctx.globalAlpha = closeAlpha ?? 1; ctx.stroke(); ctx.globalAlpha = 1;
}}
function draw() {{
  ctx.clearRect(0, 0, cv.width, cv.height);
  // ground grid
  for (let i = -5; i <= 5; i++) {{
    polyline([[i * 0.2, -1, 0], [i * 0.2, 1, 0]], '#232a36', 1);
    polyline([[-1, i * 0.2, 0], [1, i * 0.2, 0]], '#232a36', 1);
  }}
  polyline(DATA.ref, '#5aa9e6', 1.5, 0.8);          // commanded figure-8
  polyline(DATA.ee.slice(0, frame + 1), '#f2a65a', 1.5, 0.9); // achieved
  const links = DATA.links[frame];
  polyline(links, '#e8edf5', 4);
  for (const p of links) {{
    const q = proj(p); ctx.fillStyle = '#9fb4d0';
    ctx.beginPath(); ctx.arc(q[0], q[1], 4, 0, 7); ctx.fill();
  }}
  const ee = proj(DATA.ee[frame]); ctx.fillStyle = '#f2a65a';
  ctx.beginPath(); ctx.arc(ee[0], ee[1], 6, 0, 7); ctx.fill();
  const rf = proj(DATA.refpt[frame]); ctx.strokeStyle = '#5aa9e6';
  ctx.beginPath(); ctx.arc(rf[0], rf[1], 7, 0, 7); ctx.stroke();
  document.getElementById('t').textContent =
    't = ' + (frame * DATA.dt).toFixed(2) + ' s   tracking err = ' +
    DATA.err[frame].toFixed(3) + ' m';
  document.getElementById('scrub').value = frame;
}}
function tick() {{
  if (playing) frame = (frame + 1) % DATA.links.length;
  draw(); requestAnimationFrame(tick);
}}
document.getElementById('play').onclick = function () {{
  playing = !playing; this.textContent = playing ? 'pause' : 'play';
}};
document.getElementById('scrub').oninput = function () {{
  frame = +this.value; playing = false;
  document.getElementById('play').textContent = 'play';
}};
tick();
</script></body></html>
"""


def replay_data(stats_dir: str, stem: str, every: int, device) -> dict:
    """The page's data: every ``every``-th frame's link points (the base
    and the six joint origins), EE, reference point and tracking error,
    the reference path (at most ~600 points) and the frame period."""
    def load(name):
        return np.load(os.path.join(stats_dir, f"{stem}_{name}.npy"))

    q = load("joint_positions")[::every]
    ee = load("ee_positions")[::every]
    ref = load("ee_ref_positions")[::every]
    err = load("tracking_errors")[::every]
    dt = float(np.mean(load("dts"))) * every

    model = indy7(torch.float32, device)
    _, p = joint_frames(model, torch.as_tensor(q, dtype=torch.float32, device=device))
    p = p.cpu().numpy()
    links = np.concatenate([np.zeros((p.shape[0], 1, 3), np.float32), p], axis=1)

    r4 = lambda a: np.round(np.asarray(a, float), 4).tolist()
    return {"dt": dt, "links": r4(links), "ee": r4(ee), "refpt": r4(ref),
            "ref": r4(ref[:: max(1, len(ref) // 600)]), "err": r4(err)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stats_dir")
    ap.add_argument("--stem", default=None)
    ap.add_argument("--every", type=int, default=4,
                    help="keep every k-th tick (4 -> 25 fps at 100 Hz)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = protocol.device(args.device)

    stems = sorted(os.path.basename(f).split("_")[0]
                   for f in glob.glob(os.path.join(args.stats_dir, "*_dts.npy")))
    if not stems:
        sys.exit(f"no recordings in {args.stats_dir}")
    stem = args.stem or stems[-1]
    data = replay_data(args.stats_dir, stem, args.every, dev)
    n = len(data["links"])
    out = args.out or os.path.join(args.stats_dir, f"{stem}_replay.html")
    title = (f"indy7-mpc-tpu replay — {os.path.basename(args.stats_dir)}"
             f"/{stem} ({n} frames, every {args.every} ticks)")
    with open(out, "w") as f:
        f.write(TEMPLATE.format(data=json.dumps(data), title=title, maxframe=n - 1))
    print(f"wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
