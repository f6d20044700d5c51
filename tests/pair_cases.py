"""Stencils for the active pairs' barrier terms (contact/pair_terms.py and
csrc/pair_terms.cu), imported by tests/test_torch_pair_terms_kernel.py and
ipc_tpu_torch's timing tools' tests. No JAX.

`pt_cases` / `ee_cases`: hand-made stencils of every closest-point type
(7 PT codes, 9 EE codes) at a gap inside dHat, nearly parallel EE pairs
whose mollifier is active, and pairs at and beyond dHat. `fuzz`: a seeded
soup near dHat of each family, with its mollifier thresholds.
"""

import numpy as np

DHAT = 1e-2  # squared: the gap is sqrt(DHAT) = 0.1
H = 0.05  # the hand-made cases' gap

# point p above the triangle (0,0,0), (1,0,0), (0,1,0), by dtype_PT code
_PT_P = {6: (0.25, 0.25), 3: (0.5, -0.05), 4: (0.55, 0.55), 5: (-0.05, 0.5),
         0: (-0.05, -0.05), 1: (1.05, -0.03), 2: (-0.03, 1.05)}
_TRI = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])

# edge a on the x axis, edge b along y at height H, by dtype_EE code
_A_MID = ((-0.5, 0.0, 0.0), (0.5, 0.0, 0.0))
_A_A0 = ((0.05, 0.0, 0.0), (1.05, 0.0, 0.0))  # the lines cross before a0
_A_A1 = ((-1.05, 0.0, 0.0), (-0.05, 0.0, 0.0))  # after a1
_B_MID = ((0.0, -0.5, H), (0.0, 0.5, H))
_B_B0 = ((0.0, 0.05, H), (0.0, 1.05, H))
_B_B1 = ((0.0, -1.05, H), (0.0, -0.05, H))
_EE = {8: (_A_MID, _B_MID), 2: (_A_A0, _B_MID), 5: (_A_A1, _B_MID), 6: (_A_MID, _B_B0),
       7: (_A_MID, _B_B1), 0: (_A_A0, _B_B0), 1: (_A_A0, _B_B1), 3: (_A_A1, _B_B0),
       4: (_A_A1, _B_B1)}


def eps_x(X):
    """Mollifier thresholds 1e-3 |a1 - a0|^2 |b1 - b0|^2 (ops/distance.eps_x_ee)
    of EE stencils X (N,4,3), the stencils standing for their rest shape."""
    ea = X[:, 0] - X[:, 1]
    eb = X[:, 2] - X[:, 3]
    return 1e-3 * (ea * ea).sum(-1) * (eb * eb).sum(-1)


def pt_cases():
    """[(name, stencil (4,3), code or None)]: one per code inside dHat, then
    at and beyond dHat (no code asserted: their terms are exact zeros)."""
    out = []
    for code, (px, py) in sorted(_PT_P.items()):
        out.append((f"code{code}", np.vstack([[px, py, H], _TRI]), code))
    for name, h in (("at_dhat", np.sqrt(DHAT)), ("beyond", 0.2), ("far", 3.0)):
        out.append((name, np.vstack([[0.25, 0.25, h], _TRI]), None))
    return out


def ee_cases():
    """[(name, stencil (4,3), code or None, eps_x)]: one per code inside dHat,
    nearly parallel pairs whose mollifier is active, then at and beyond dHat."""
    out = []
    for code, (a, b) in sorted(_EE.items()):
        X = np.array([*a, *b])
        out.append((f"code{code}", X, code, float(eps_x(X[None])[0])))
    for k, (dy, dz) in enumerate(((1e-3, H), (-2e-3, 0.08), (5e-4, 0.02))):
        X = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.2, dy, dz], [0.8, 0.0, dz]])
        out.append((f"mollified{k}", X, None, float(eps_x(X[None])[0])))
    for name, h in (("at_dhat", np.sqrt(DHAT)), ("beyond", 0.2)):
        X = np.array([*_A_MID, (0.0, -0.5, h), (0.0, 0.5, h)])
        out.append((name, X, None, float(eps_x(X[None])[0])))
    return out


def fuzz(kind, n, seed):
    """(X (n,4,3), eps (n,)) float64: a seeded soup of `kind` ("pt" / "ee")
    stencils with gaps of 0.05-1.3 sqrt(DHAT) in every region; a third of
    the EE pairs nearly parallel, and their thresholds 10x the rest shape's
    so that many are mollified (eps is zeros for "pt")."""
    rng = np.random.default_rng(seed)
    s = np.sqrt(DHAT)
    gap = s * rng.uniform(0.05, 1.3, n) * rng.choice([-1.0, 1.0], n)
    if kind == "pt":
        t = rng.normal(size=(n, 3, 3))
        nrm = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        bc = rng.uniform(-0.6, 1.4, (n, 3))
        norm = rng.random(n) < 0.5
        bc[norm] /= bc[norm].sum(axis=1, keepdims=True)
        p = np.einsum("nk,nkj->nj", bc, t) + nrm * gap[:, None]
        return np.concatenate([p[:, None], t], axis=1), np.zeros(n)
    a0 = rng.normal(size=(n, 3))
    a1 = a0 + rng.normal(size=(n, 3))
    par = rng.random(n) < 0.3
    d = np.where(par[:, None], (a1 - a0) + 1e-3 * rng.normal(size=(n, 3)),
                 rng.normal(size=(n, 3)))
    off = rng.normal(size=(n, 3))
    off /= np.linalg.norm(off, axis=1, keepdims=True)
    t = rng.uniform(-0.5, 1.5, n)
    b0 = (a0 + t[:, None] * (a1 - a0) + off * np.abs(gap)[:, None]
          - d * rng.uniform(0.0, 1.2, n)[:, None])
    X = np.stack([a0, a1, b0, b0 + d], axis=1)
    return X, 10.0 * eps_x(X)
