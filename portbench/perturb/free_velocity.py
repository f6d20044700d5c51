"""Seeded smooth initial velocity on the free (unscripted) vertices, at
rest positions: one plane wave v(X) = a * d * sin(2 pi k.X + phi) with a
random unit direction d, integer wave numbers k (1 to kmax on each
horizontal axis), a random phase phi and the amplitude a (m/s) of the
parameters; zero on the scripted handles.

params: amplitude, kmax."""

import numpy as np


def apply(scene, params, rng):
    x = scene.x_rest.cpu().numpy().copy()
    d = rng.normal(size=3)
    d /= np.linalg.norm(d)
    k = np.array([rng.integers(1, params["kmax"] + 1), 0, rng.integers(1, params["kmax"] + 1)])
    phi = rng.uniform(0.0, 2.0 * np.pi)
    v = params["amplitude"] * np.sin(2.0 * np.pi * (x @ k) + phi)[:, None] * d[None, :]
    v[scene.dbc.cpu().numpy()] = 0.0
    return x, v
