"""Point-triangle and edge-edge CCD cases, shared by the port's CCD tests
(imports no JAX, so the card's tests can use them).

The hand-made cases and the corpus generators of tests/test_ccd.py and
tests/test_ccd_corpus.py, rebuilt in numpy (head-on, grazing, moving
triangle, parallel motion, crossing and near-parallel edges, separating
motion, no motion, impacts at known t*, a tilted resting slide,
degenerate stencils), and `fuzz`, a vectorized seeded mix of every kind
for large counts. Stencils are (N,4,3) float64 arrays: x4 and its motion p4.
"""

import numpy as np

TRI = [[-1.0, 0, -1], [1, 0, -1], [0, 0, 1.5]]


def pt(p, dp, tri=TRI, dtri=None):
    x4 = np.vstack([p, tri]).astype(float)
    p4 = np.vstack([dp, np.zeros((3, 3)) if dtri is None else dtri]).astype(float)
    return x4, p4


def tilted_slide(tilt_deg):
    th = np.radians(tilt_deg)
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    tri = np.array(TRI) @ R.T
    nrm = np.cross(tri[1] - tri[0], tri[2] - tri[0])
    nrm /= np.linalg.norm(nrm)
    p0 = np.array([0.0, 0.0, 0.1]) @ R.T + 1e-3 * nrm
    slide = (tri[1] - tri[0]) / np.linalg.norm(tri[1] - tri[0])
    return pt(p0, slide * 0.5, tri)


def pt_cases():
    z = np.zeros((4, 3))
    cases = [
        pt([0, 1.0, 0], [0, -2.0, 0]),  # head-on
        pt([1.2, 1.0, 0], [0, -2.0, 0]),  # grazing
        pt([0, 0.5, 0.2], [0, 0, 0], TRI, [[0, 1.0, 0]] * 3),  # triangle rises
        pt([0, 1.0, 0], [1.0, 0, 0], TRI, [[1.0, 0, 0]] * 3),  # parallel motion
        pt([0, 0.5, 0.1], [0, 2.0, 0]),  # separating
        pt([0, 0.5, 0.1], [0, 0, 0]),  # no motion
        (z.copy(), z.copy()),  # all coincident, no motion
        (z.copy(), np.array([[1.0, 0, 0]] * 4)),  # coincident, rigid motion
        (np.array([[0, 1.0, 0], [-1, 0, 0], [0, 0, 0], [1, 0, 0]]),
         np.array([[0, -2.0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0]])),  # zero-area tri
        pt([0, 0.0, 0.2], [0, 1.0, 0]),  # in the plane, moving away
    ]
    cases += [pt([0, 1.0, 0], [0, -1.0 / t, 0]) for t in (0.25, 0.5, 0.9)]  # known t*
    cases += [tilted_slide(d) for d in (0.0, 15.0, 40.0)]
    return cases


def ee_cases():
    z = np.zeros((4, 3))
    arr = np.array
    return [
        (arr([[-1, 1.0, 0], [1, 1.0, 0], [0, 0, -1], [0, 0, 1]]),
         arr([[0, -2.0, 0], [0, -2.0, 0], [0, 0, 0], [0, 0, 0]])),  # crossing
        (arr([[-1, 0.5, 0], [1, 0.5, 0.01], [-1, 0, 0], [1, 0, 0]]),
         arr([[0, -1.0, 0], [0, -1.0, 0], [0, 0, 0], [0, 0, 0]])),  # near-parallel
        (arr([[-1, 0.5, 0], [1, 0.5, 0], [0, 0, -1], [0, 0, 1]]),
         arr([[0, 1.0, 0], [0, 1.0, 0], [0, 0, 0], [0, 0, 0]])),  # separating
        (z.copy(), z.copy()),
        (arr([[-1, 0, 0], [1, 0, 0], [0, 1.0, 0], [0, 1.0, 0]]),
         arr([[0, 0, 0], [0, 0, 0], [0, -2.0, 0], [0, -2.0, 0]])),  # zero-length edge
        (arr([[-1, 0, 0], [1, 0, 0], [-1, 0.5, 0], [1, 0.5, 0]]),
         arr([[0, 0, 0], [0, 0, 0], [0, -1.0, 0], [0, -1.0, 0]])),  # parallel, closing
        (arr([[-2, 0, 0], [-1, 0, 0], [1, 0, 0], [2, 0, 0]]),
         arr([[1.5, 0, 0], [1.5, 0, 0], [0, 0, 0], [0, 0, 0]])),  # collinear, end to end
    ]


def random_pt_cases(rng, n):
    """Aimed impacts, grazers and wild motion across five decades of scale
    (tests/test_ccd_corpus.py's generator)."""
    X, P = [], []
    for i in range(n):
        scale = 10.0 ** rng.uniform(-3, 2)
        tri = rng.normal(0, 1, (3, 3)) * scale
        while np.linalg.norm(np.cross(tri[1] - tri[0], tri[2] - tri[0])) < 1e-8 * scale**2:
            tri = rng.normal(0, 1, (3, 3)) * scale
        nrm = np.cross(tri[1] - tri[0], tri[2] - tri[0])
        nrm /= np.linalg.norm(nrm)
        target = rng.dirichlet([1.0, 1.0, 1.0]) @ tri
        p0 = target + 10.0 ** rng.uniform(-3, 0) * scale * nrm
        if i % 3 == 0:
            dp, dt = (target - p0) * rng.uniform(1.2, 3.0), rng.normal(0, 0.05 * scale, (3, 3))
        elif i % 3 == 1:
            out = target + (tri[i % 3] - target) * rng.uniform(1.01, 1.3)
            dp, dt = (out - p0) * rng.uniform(1.0, 2.0), rng.normal(0, 0.02 * scale, (3, 3))
        else:
            dp, dt = rng.normal(0, scale, 3), rng.normal(0, scale, (3, 3))
        X.append(np.vstack([p0, tri]))
        P.append(np.vstack([dp, dt]))
    return np.stack(X), np.stack(P)


def random_ee_cases(rng, n):
    X, P = [], []
    for i in range(n):
        scale = 10.0 ** rng.uniform(-3, 2)
        a0, a1 = rng.normal(0, 1, (2, 3)) * scale
        b0, b1 = rng.normal(0, 1, (2, 3)) * scale
        if i % 3 == 0:
            d = (0.5 * (a0 + a1) - 0.5 * (b0 + b1)) * rng.uniform(1.2, 3.0)
            p4 = np.vstack([np.zeros((2, 3)), np.tile(d, (2, 1))])
        elif i % 3 == 1:
            b0 = a0 + np.array([0, 1, 0]) * 0.3 * scale + rng.normal(0, 1e-4 * scale, 3)
            b1 = a1 + np.array([0, 1, 0]) * 0.3 * scale + rng.normal(0, 1e-4 * scale, 3)
            p4 = np.vstack([np.zeros((2, 3)), np.tile(np.array([0, -1.0, 0]) * scale, (2, 1))])
        else:
            p4 = rng.normal(0, scale, (4, 3))
        X.append(np.vstack([a0, a1, b0, b1]))
        P.append(p4)
    return np.stack(X), np.stack(P)


def _unit(v):
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.where(n > 0, n, 1.0)


FUZZ_KINDS = ("wild", "aimed", "near_parallel", "coincident", "degenerate", "no_motion",
              "rigid", "slow")


def fuzz(kind, n, seed):
    """(X, P, k): n seeded stencils of family `kind` ("pt" or "ee") across
    five decades of scale, of the FUZZ_KINDS k = i % 8: wild motion; aimed
    (PT: the point through a point of the triangle, EE: the second edge
    through the first's midpoint, from 1e-3-1 of the scale away); near-
    parallel (PT: the point sliding 1e-4 of the scale above the triangle's
    plane and sinking, EE: parallel edges 0.3 apart up to 1e-4 of noise,
    closing); coincident (all four points at one place, moving apart); a
    zero-area triangle or a zero-length edge, aimed; no motion; rigid motion
    (one displacement for all four points); slow motion (1e-3 of the
    scale: t reaches t_max)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4, 3))
    P = rng.normal(size=(n, 4, 3))
    k = np.arange(n) % 8
    h = 10.0 ** rng.uniform(-3, 0, (n, 1))
    speed = rng.uniform(1.2, 3.0, (n, 1))
    if kind == "pt":
        tri = X[:, 1:]
        nrm = _unit(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]))
        target = np.einsum("nk,nkj->nj", rng.dirichlet([1.0, 1.0, 1.0], n), tri)
        m = k == 1
        X[m, 0] = target[m] + h[m] * nrm[m]
        P[m, 0] = (target[m] - X[m, 0]) * speed[m]
        P[m, 1:] *= 0.05
        m = k == 2
        X[m, 0] = target[m] + 1e-4 * nrm[m]
        tang = _unit(tri[:, 1] - tri[:, 0])
        P[m, 0] = tang[m] - 2e-4 * rng.uniform(0.0, 1.0, (n, 1))[m] * nrm[m]
        P[m, 1:] = 0.0
        m = k == 4
        X[m, 3] = 0.5 * (X[m, 1] + X[m, 2])
        P[m, 0] = (X[m, 1] - X[m, 0]) * speed[m]
        P[m, 1:] = 0.0
    else:
        mid_a, mid_b = 0.5 * (X[:, 0] + X[:, 1]), 0.5 * (X[:, 2] + X[:, 3])
        m = k == 1
        u = _unit(rng.normal(size=(n, 3)))
        X[m, 2:] += (mid_a + h * u - mid_b)[m][:, None]
        P[m, :2] = 0.0
        P[m, 2:] = (-h * u * speed)[m][:, None]
        m = k == 2
        off = 0.3 * _unit(np.cross(X[:, 1] - X[:, 0], rng.normal(size=(n, 3))))
        X[m, 2] = X[m, 0] + off[m] + 1e-4 * rng.normal(size=(n, 3))[m]
        X[m, 3] = X[m, 1] + off[m] + 1e-4 * rng.normal(size=(n, 3))[m]
        P[m, :2] = 0.0
        P[m, 2:] = (-off * rng.uniform(0.5, 2.0, (n, 1)))[m][:, None]
        m = k == 4
        X[m, 1] = X[m, 0]
        P[m, :2] = 0.0
        P[m, 2:] = ((X[:, 0] - mid_b) * speed)[m][:, None]
    m = k == 3
    X[m] = X[m, :1]
    m = k == 5
    P[m] = 0.0
    m = k == 6
    P[m] = P[m, :1]
    m = k == 7
    P[m] *= 1e-3
    s = 10.0 ** rng.uniform(-3, 2, (n, 1, 1))
    return X * s, P * s, k
