"""Per-tet Hessian-vector product, accumulated per vertex.

Replaces ipc_tpu/ops/pallas_hv.py (the TPU window kernel) plus the
`gsum_hv` gather-sum behind it (ipc_tpu/jit_step.py:464-474):

    out[v] = sum over (tet t, corner c) incidences of v of
             H_t[3c:3c+3, :] . [v_i0; v_i1; v_i2; v_i3]

`tet_hv` launches the CUDA kernel (csrc/tet_hv.cu) for CUDA tensors and
counts each call in `tet_hv.launches` (ops/launch_counts: a call made
while a CUDA graph is captured counts at each replay of the graph). The
kernel runs in two device launches: pass A writes the per-corner rows
H_t . v4_t to a (4T,3) scratch (row 4t + c, the layout of the plain
version's `hv.reshape(-1, 3)`), pass B sums each vertex's rows in the
table's order. One call is one operator application, so `launches` counts
calls, not device launches. For CPU tensors, and only there, it computes
the same sum with `tet_hv_reference`, the plain PyTorch version (the JAX
package's jnp route: gather, einsum, gather-sum). A CUDA tensor never
reaches the plain version: the kernel launches or the call raises.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ipc_tpu_torch.ops.launch_counts import count_launch, register
from ipc_tpu_torch.ops.scatter import gather_table, make_gather_sum

__all__ = ["TetHvTable", "make_tet_hv_table", "tet_hv", "tet_hv_reference", "tet_rows_reference"]

# The kernel's bulk copies move H and tets in 16-byte units.
_ALIGN = 16


@dataclass(frozen=True)
class TetHvTable:
    """Static topology of the product, built once per mesh on the host.

    tets  (T,4) int64  — the mesh's tets (plain version's gather)
    tets32 (T,4) int32 — the same, as the kernel declares it
    inc   (V,D) int32  — per vertex, the flat incidences 4*t + c in
                         ascending order, padded with 4T (the gather-sum
                         table of make_gather_sum(tets.reshape(-1), V))
    gsum  callable     — that gather-sum, for the plain version
    """

    tets: torch.Tensor
    tets32: torch.Tensor
    inc: torch.Tensor
    gsum: object

    @property
    def n_verts(self):
        return int(self.inc.shape[0])


def make_tet_hv_table(tets, n_verts, device="cpu"):
    tets_np = np.asarray(tets).astype(np.int64)
    ids = tets_np.reshape(-1)
    return TetHvTable(
        tets=torch.as_tensor(tets_np, device=device),
        tets32=torch.as_tensor(tets_np.astype(np.int32), device=device),
        inc=torch.as_tensor(gather_table(ids, n_verts).astype(np.int32), device=device),
        gsum=make_gather_sum(ids, n_verts, device),
    )


def tet_rows_reference(H, tets, v):
    """Plain version of pass A: the (4T,3) per-corner rows, row 4t + c =
    H_t[3c:3c+3, :] . v4_t."""
    v4 = v[tets].reshape(-1, 12)
    return torch.einsum("cij,cj->ci", H, v4).reshape(-1, 3)


def tet_hv_reference(H, tets, v, gsum):
    """Plain version: v[tets] -> per-tet 12x12 matvec -> gather-sum."""
    return gsum(tet_rows_reference(H, tets, v))


def _check(H, v, table):
    T = int(table.tets.shape[0])
    V = table.n_verts
    if H.shape != (T, 12, 12) or v.shape != (V, 3):
        raise ValueError(f"tet_hv: H {tuple(H.shape)} / v {tuple(v.shape)} do not "
                         f"match the table's (T,12,12)=({T},12,12) / (V,3)=({V},3)")
    if H.dtype != v.dtype or H.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tet_hv: H {H.dtype} and v {v.dtype} must share float32 or float64")
    if H.device != v.device:
        raise ValueError(f"tet_hv: H on {H.device}, v on {v.device}")


def _launch_args(H, v, table):
    """The kernel's size arguments (n_tets, n_verts, D) and its rows scratch,
    (4T,3) like H. Raises for inputs the kernel does not take: tables on
    another device, non-contiguous H or v, H or tets not 16-byte aligned."""
    for name, t in (("tets32", table.tets32), ("inc", table.inc)):
        if t.device != H.device:
            raise ValueError(f"tet_hv: table.{name} on {t.device}, H on {H.device}")
    if not (H.is_contiguous() and v.is_contiguous()):
        raise ValueError("tet_hv: H and v must be contiguous")
    for name, t in (("H", H), ("tets32", table.tets32)):
        if t.data_ptr() % _ALIGN:
            raise ValueError(f"tet_hv: {name} must be {_ALIGN}-byte aligned for the bulk copies")
    n_tets = int(table.tets32.shape[0])
    V, D = table.inc.shape
    rows = torch.empty((4 * n_tets, 3), dtype=H.dtype, device=H.device)
    return (n_tets, int(V), int(D)), rows


def tet_hv(H, v, table):
    """(V,3) per-vertex sum of the per-tet products H_t . v4_t.

    H (T,12,12) and v (V,3) share one dtype (float32 or float64) and one
    device; `table` comes from make_tet_hv_table for the same mesh."""
    _check(H, v, table)
    if H.device.type == "cpu":
        return tet_hv_reference(H, table.tets, v, table.gsum)
    if H.device.type != "cuda":
        raise ValueError(f"tet_hv: unsupported device {H.device}")
    (n_tets, n_verts, D), rows = _launch_args(H, v, table)
    from ipc_tpu_torch.build import load_kernels

    lib = load_kernels()
    fn = lib.ipc_tet_hv_f32 if H.dtype == torch.float32 else lib.ipc_tet_hv_f64
    out = torch.empty_like(v)
    err = fn(H.data_ptr(), v.data_ptr(), table.tets32.data_ptr(), table.inc.data_ptr(),
             n_tets, n_verts, D, rows.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(H.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tet_hv: CUDA launch failed with error {err}")
    count_launch(tet_hv)
    return out


register(tet_hv)
