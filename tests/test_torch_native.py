"""The port's native C++ host runtime (ipc_tpu_torch/native) against the
JAX package's (ipc_tpu/native) and the port's own Python paths, as
tests/test_native.py holds the JAX one: .msh parsing against
io_mesh.read_msh, boundary faces against mesh._boundary_faces, and the
grid broad phase against a brute-force AABB sweep, each also equal to
ipc_tpu.native's output. Skips without a toolchain (g++), as
tests/test_native.py does."""

import os

import numpy as np
import pytest

from ipc_tpu import native as jax_native
from ipc_tpu_torch import native
from ipc_tpu_torch.io_mesh import read_msh, write_msh
from ipc_tpu_torch.mesh import _boundary_faces, build_mesh
from ipc_tpu_torch.models.primitives import cube, mat

pytestmark = pytest.mark.skipif(not (native.available() and jax_native.available()),
                                reason="no native toolchain")


def test_library_is_built_under_build_not_beside_the_source():
    assert os.path.exists(native.LIB_PATH)
    assert os.sep.join(("build", "native")) in native.LIB_PATH
    assert not os.path.exists(os.path.join(os.path.dirname(native.__file__),
                                           "libipc_native.so"))


def test_parse_msh_matches_python_and_jax(tmp_path):
    V, T = cube(2)
    p = str(tmp_path / "m.msh")
    write_msh(p, V, T)
    Vn, Tn = native.parse_msh(p)
    Vp, Tp = read_msh(p)
    np.testing.assert_allclose(Vn, Vp)
    np.testing.assert_array_equal(Tn, Tp)
    Vj, Tj = jax_native.parse_msh(p)
    np.testing.assert_array_equal(Vn, Vj)
    np.testing.assert_array_equal(Tn, Tj)


def test_boundary_faces_matches_python_and_jax():
    V, T = cube(3)
    Fp = _boundary_faces(np.asarray(T, np.int64))
    Fn = native.boundary_faces(T)
    assert len(Fn) == len(Fp)
    # the same oriented faces; the order may differ
    assert set(map(tuple, Fn)) == set(map(tuple, Fp))
    np.testing.assert_array_equal(Fn, jax_native.boundary_faces(T))


def test_grid_candidates_finds_close_pairs():
    V, T = mat(6)
    X = np.asarray(V)
    F = _boundary_faces(np.asarray(T, np.int64)).astype(np.int32)
    pts = np.arange(len(X), dtype=np.int32)[:, None]
    gap = 0.05
    pairs, total = native.grid_candidates(X, pts, F, cell_size=0.2, gap=gap, cap=200000)
    assert total == len(pairs)
    lo = X[F].min(axis=1) - gap
    hi = X[F].max(axis=1) + gap
    expect = set()
    for i in range(len(X)):
        pmin, pmax = X[i] - gap, X[i] + gap
        overlap = np.all(pmin[None, :] <= hi, axis=1) & np.all(lo <= pmax[None, :], axis=1)
        for j in np.nonzero(overlap)[0]:
            if i not in F[j]:
                expect.add((i, int(j)))
    assert set(map(tuple, np.asarray(pairs, dtype=int))) == expect
    jp, jt = jax_native.grid_candidates(X, pts, F, cell_size=0.2, gap=gap, cap=200000)
    np.testing.assert_array_equal(pairs, jp)
    assert jt == total


def test_grid_candidates_ee_upper_only():
    V, T = cube(2)
    mesh, _ = build_mesh(V, T, device="cpu")
    X = np.asarray(V)
    E = mesh.surf_edges.numpy().astype(np.int32)
    pairs, total = native.grid_candidates(X, E, E, cell_size=0.5, gap=0.01, upper_only=True,
                                          cap=100000)
    assert total == len(pairs) > 0
    assert np.all(pairs[:, 0] < pairs[:, 1])
    for a, b in pairs:
        assert not set(E[a]) & set(E[b])
    jp, _ = jax_native.grid_candidates(X, E, E, cell_size=0.5, gap=0.01, upper_only=True,
                                       cap=100000)
    np.testing.assert_array_equal(pairs, jp)


def test_small_cap_reports_the_true_count():
    V, T = mat(6)
    X = np.asarray(V)
    F = _boundary_faces(np.asarray(T, np.int64)).astype(np.int32)
    pts = np.arange(len(X), dtype=np.int32)[:, None]
    full, total = native.grid_candidates(X, pts, F, cell_size=0.2, gap=0.05, cap=200000)
    part, total2 = native.grid_candidates(X, pts, F, cell_size=0.2, gap=0.05, cap=10)
    assert total2 == total > 10 and len(part) == 10
