"""The diagnostic and mesh-processing CLIs of the port against the JAX
package's (ipc_tpu/diagnostic.py, ipc_tpu/meshproc.py), on the CPU.

* Every diagnostic mode passes with --device cpu, the dtype modes in
  float64 and float32, and its printed error agrees with the JAX mode's on
  the same seed: the solver residual, the EE distance and the CCD times
  to 4 significant digits, the finite-difference errors (set by the
  differences' rounding, 1e-10-1e-9) within 10x, dtype_fuzz's worst
  slack (the JAX tool prints only its sample count, so the test computes
  JAX's slack from the same samples with the JAX distance functions)
  within 1e-15. JAX's dist_derivs runs
  with its distance kernels jitted (eager, it retraces `lax.switch` on
  every call: ~3 minutes).
* grad_check on a scene file written to tmp_path (two cubes in contact
  range over the ground, so the barrier terms are in the gradient).
* meshproc gen (box, mat, rod), surf, info and nodele2msh: the port writes
  the files the JAX tool writes, byte for byte, and prints the same lines.
"""

import re
import textwrap

import jax
import numpy as np
import pytest

from ipc_tpu import diagnostic as JD
from ipc_tpu import meshproc as JMP
from ipc_tpu.ops import distance as JDIST
from ipc_tpu_torch import diagnostic as PD
from ipc_tpu_torch import meshproc as PMP

NUM = r"([-+0-9.eE]+)"


def _number(out, pattern):
    m = re.search(pattern, out)
    assert m, (pattern, out)
    return float(m.group(1))


def _same(p, j, sig=4):
    np.testing.assert_allclose(p, j, rtol=10.0 ** -sig)


def _within_10x(p, j):
    assert j / 10.0 <= p <= 10.0 * j, (p, j)


# mode: (pattern of the printed error, comparison)
ERRORS = {
    "sigma_derivs": (r"max rel err " + NUM, _within_10x),
    "dist_derivs": (r"max rel err " + NUM, _within_10x),
    "dtype_fuzz": (r"worst slack " + NUM, lambda p, j: np.testing.assert_allclose(
        p, j, rtol=1e-4, atol=1e-15)),
    "ee_dist": (r"d=" + NUM + ",", _same),
    "ccd_probe": (r"PT head-on: toi=" + NUM, _same),
    "solver_check": (r"residual " + NUM, _same),
}


def _jax_mode(name, monkeypatch):
    if name == "dist_derivs":
        for fn in ("stencil_dist2", "stencil_dist2_grad"):
            monkeypatch.setattr(JDIST, fn, jax.jit(getattr(JDIST, fn), static_argnums=0))
    return JD.MODES[name]()


def _jax_dtype_fuzz_slack(n=2000):
    """JAX's dtype_fuzz samples (its seed), and the worst slack of its
    region-aware distances over the smallest reduced candidate."""
    import jax.numpy as jnp

    X = jnp.asarray(np.random.default_rng(2).uniform(-1, 1, (n, 4, 3)))
    D = JDIST

    @jax.jit
    @jax.vmap
    def slack(x):
        m_pt = jnp.stack([D.d_PP(x[0], x[1]), D.d_PP(x[0], x[2]), D.d_PP(x[0], x[3]),
                          D.point_edge_dist2(x[0], x[1], x[2]),
                          D.point_edge_dist2(x[0], x[2], x[3]),
                          D.point_edge_dist2(x[0], x[3], x[1])]).min()
        m_ee = jnp.stack([D.point_edge_dist2(x[0], x[2], x[3]),
                          D.point_edge_dist2(x[1], x[2], x[3]),
                          D.point_edge_dist2(x[2], x[0], x[1]),
                          D.point_edge_dist2(x[3], x[0], x[1])]).min()
        return jnp.maximum(D.point_triangle_dist2(x[0], x[1], x[2], x[3]) - m_pt,
                           D.edge_edge_dist2(x[0], x[1], x[2], x[3]) - m_ee)

    return float(slack(X).max())


@pytest.mark.parametrize("name", list(PD.MODES))
def test_diagnostic_mode_matches_jax(name, capsys, monkeypatch):
    assert _jax_mode(name, monkeypatch)
    jax_out = capsys.readouterr().out
    assert PD.main([name, "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert "PASS" in port_out and "FAIL" not in port_out
    pattern, compare = ERRORS[name]
    jax_err = _jax_dtype_fuzz_slack() if name == "dtype_fuzz" else _number(jax_out, pattern)
    compare(_number(port_out, pattern), jax_err)
    if name == "ccd_probe":
        ee = r"EE head-on: toi=" + NUM
        _same(_number(port_out, ee), _number(jax_out, ee))
    if name in PD.DTYPE_MODES:
        assert PD.main([name, "--device", "cpu", "--dtype", "float32"]) == 0
        assert "PASS" in capsys.readouterr().out


def test_diagnostic_all_and_errors(capsys):
    assert PD.main(["all", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("PASS") == len(PD.MODES) + len(PD.DTYPE_MODES) and "FAIL" not in out
    assert PD.main(["no_such_mode", "--device", "cpu"]) == 2


GRAD_SCENE = """
shapes input 2
{msh} 0 0.01 0  0 0 0  1 1 1
{msh} 0 1.012 0  0 0 0  1 1 1
time 0.1 0.025
selfCollisionOn
halfSpace  0 0 0  0 1 0  0  0
"""


def test_grad_check_on_a_scene(tmp_path, capsys):
    from ipc_tpu_torch.io_mesh import write_msh
    from ipc_tpu_torch.models.primitives import box_grid

    msh = tmp_path / "box.msh"
    write_msh(str(msh), *box_grid(2, 2, 2))
    scene = tmp_path / "grad.txt"
    scene.write_text(textwrap.dedent(GRAD_SCENE.format(msh=msh)))
    assert PD.main(["grad_check", str(scene), "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PASS" in out and _number(out, r"max rel err " + NUM) < 1e-3


@pytest.mark.parametrize("cmd", [["box", "3", "2", "2", "--size", "1", "2", "3"],
                                 ["mat", "4"], ["rod", "5"]])
def test_meshproc_matches_jax(cmd, tmp_path, capsys):
    files = {}
    for who, tool in (("jax", JMP), ("port", PMP)):
        d = tmp_path / who
        d.mkdir()
        gen = cmd[:]
        gen.insert(4 if cmd[0] == "box" else 2, str(d / "m.msh"))
        tool.cmd_gen(gen)
        tool.cmd_surf([str(d / "m.msh"), str(d / "m.obj")])
        tool.cmd_info([str(d / "m.msh")] + (["--device", "cpu"] if tool is PMP else []))
        # the .node/.ele pair of the same mesh, back to .msh
        V, T = _read_msh(d / "m.msh")
        _write_node_ele(d / "t", V, T)
        tool.cmd_nodele2msh([str(d / "t"), str(d / "n.msh")])
        files[who] = {f: (d / f).read_bytes() for f in ("m.msh", "m.obj", "n.msh")}
        files[who]["stdout"] = capsys.readouterr().out.replace(str(d), "<dir>").encode()
    assert files["port"] == files["jax"]


def _read_msh(path):
    from ipc_tpu_torch.io_mesh import read_msh

    return read_msh(str(path))


def _write_node_ele(prefix, V, T):
    with open(f"{prefix}.node", "w") as f:
        f.write(f"{len(V)} 3 0 0\n")
        for i, v in enumerate(V):
            f.write(f"{i} " + " ".join(repr(float(c)) for c in v) + "\n")
    with open(f"{prefix}.ele", "w") as f:
        f.write(f"{len(T)} 4 0\n")
        for i, t in enumerate(T):
            f.write(f"{i} {t[0]} {t[1]} {t[2]} {t[3]}\n")


def test_meshproc_info_device(tmp_path, capsys, monkeypatch):
    """info builds the mesh on the card unless --device names another
    device: without a card (simulated) it raises, with --device cpu it runs."""
    import torch

    msh = str(tmp_path / "m.msh")
    PMP.main(["gen", "box", "2", "2", "2", msh])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PMP.main(["info", msh])
    capsys.readouterr()
    assert PMP.main(["info", msh, "--device", "cpu"]) == 0
    assert PMP.main(["info", "--device", "cpu", msh]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("verts 27  tets 48") and out[:4] == out[4:]


def test_meshproc_main(capsys):
    assert PMP.main([]) == 0
    assert PMP.main(["nope"]) == 2
    assert "unknown command" in capsys.readouterr().out
