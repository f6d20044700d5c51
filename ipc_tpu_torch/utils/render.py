"""Headless surface-mesh rendering: PNG frames + animated GIF.

The port's own copy of ipc_tpu/utils/render.py. PIL is imported only when
a frame is drawn (`--gif`), so a machine without it runs everything else.

The reference couples an interactive libigl viewer with a public-domain GIF
encoder (reference: src/Utils/GIF.hpp, viewer loop main.cpp:183-438,
screenshots/GIF frames per step). This TPU build is headless, so the
equivalent observability artifact is an offline software render of the
surface mesh per saved step and an animated GIF per run.

Pure numpy + PIL painter's renderer: orthographic projection, Lambertian
flat shading, back-to-front triangle sort. Deliberately dependency-light —
matplotlib 3D would be ~10x slower per frame on the scenes that matter.
"""

import numpy as np

__all__ = ["render_frame", "write_gif", "RunRecorder"]


def _look_at(eye, center, up):
    f = center - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, up)
    r = r / np.maximum(np.linalg.norm(r), 1e-30)
    u = np.cross(r, f)
    return np.stack([r, u, -f])  # rows: camera basis


def render_frame(x, tris, size=512, eye_dir=(1.0, 0.6, 1.2), up=(0, 1, 0),
                 bounds=None, color=(168, 196, 230), bg=(255, 255, 255)):
    """Render surface (V,3) + (S,3) to an (size,size,3) uint8 image.

    bounds: optional (lo (3,), hi (3,)) world box fixed across frames so
    animations don't rescale per frame."""
    from PIL import Image, ImageDraw

    x = np.asarray(x, np.float64)
    tris = np.asarray(tris, np.int64)
    if bounds is None:
        lo, hi = x.min(axis=0), x.max(axis=0)
    else:
        lo, hi = np.asarray(bounds[0]), np.asarray(bounds[1])
    center = 0.5 * (lo + hi)
    radius = max(float(np.linalg.norm(hi - lo)) * 0.5, 1e-12)

    eye_dir = np.asarray(eye_dir, np.float64)
    eye = center + eye_dir / np.linalg.norm(eye_dir) * (3.0 * radius)
    R = _look_at(eye, center, np.asarray(up, np.float64))
    xc = (x - eye) @ R.T  # camera frame; -z into the screen

    scale = size * 0.45 / radius
    px = xc[:, 0] * scale + size / 2
    py = -xc[:, 1] * scale + size / 2
    depth = xc[:, 2]

    v0, v1, v2 = x[tris[:, 0]], x[tris[:, 1]], x[tris[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    nn = np.linalg.norm(n, axis=1)
    n = n / np.maximum(nn, 1e-30)[:, None]
    light = np.array([0.4, 0.8, 0.45])
    light = light / np.linalg.norm(light)
    shade = 0.35 + 0.65 * np.abs(n @ light)
    col = (np.asarray(color, np.float64)[None, :] * shade[:, None]).astype(np.uint8)

    zc = depth[tris].mean(axis=1)
    order = np.argsort(zc)  # back (most negative z is far? -z into screen:
    # farther = more negative x_cam z... camera looks along -z, so depth
    # decreases with distance; paint ascending depth = far first
    img = Image.new("RGB", (size, size), bg)
    draw = ImageDraw.Draw(img)
    P = np.stack([px, py], axis=1)
    for ti in order:
        a, b, c = tris[ti]
        draw.polygon(
            [tuple(P[a]), tuple(P[b]), tuple(P[c])],
            fill=tuple(int(v) for v in col[ti]),
        )
    return np.asarray(img)


def write_gif(frames, path, fps=20):
    """Encode uint8 frames into an animated GIF (reference GifWriter role)."""
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    if not imgs:
        return
    imgs[0].save(
        path, save_all=True, append_images=imgs[1:],
        duration=max(1, int(1000 / fps)), loop=0,
    )


class RunRecorder:
    """Accumulates per-step frames with a fixed world box; writes the GIF
    at the end of the run (sim.py --gif)."""

    def __init__(self, x0, tris, size=512, pad=0.6):
        self.tris = np.asarray(tris)
        lo, hi = np.asarray(x0).min(axis=0), np.asarray(x0).max(axis=0)
        c, r = 0.5 * (lo + hi), 0.5 * (hi - lo)
        r = np.maximum(r, r.max() * 0.2)
        self.bounds = (c - (1 + pad) * r, c + (1 + pad) * r)
        self.size = size
        self.frames = []

    def add(self, x):
        self.frames.append(
            render_frame(x, self.tris, size=self.size, bounds=self.bounds)
        )

    def save(self, path, fps=20):
        write_gif(self.frames, path, fps=fps)
