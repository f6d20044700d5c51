"""Seeded rigid placement of one body: a horizontal offset and a turn about
the vertical axis through the body's centre, at rest.

params: body (index in the configuration's body list), offset (largest
offset on x and on z), yaw_deg (largest turn, degrees). The offsets and
the turn are uniform in [-max, max]."""

import math

import numpy as np


def apply(scene, params, rng):
    x = scene.x_rest.cpu().numpy().copy()
    lo, hi = scene.bodies[params["body"]]
    dx, dz = rng.uniform(-params["offset"], params["offset"], size=2)
    yaw = math.radians(rng.uniform(-params["yaw_deg"], params["yaw_deg"]))
    c, s = math.cos(yaw), math.sin(yaw)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    p = x[lo:hi]
    ctr = 0.5 * (p.min(axis=0) + p.max(axis=0))
    x[lo:hi] = (p - ctr) @ R.T + ctr + np.array([dx, 0.0, dz])
    return x, np.zeros_like(x)
