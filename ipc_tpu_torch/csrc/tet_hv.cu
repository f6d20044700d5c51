// Per-tet Hessian-vector product, assembled per vertex, for Hopper (sm_90a).
//
// Replaces ipc_tpu/ops/pallas_hv.py::_make_kernel (the TPU window kernel
// `tet_hv_window_kernel`) together with the `gsum_hv` gather-sum that turns
// its per-corner rows into per-vertex values (ipc_tpu/jit_step.py:464-474):
//
//   out[v] = sum over the (tet t, corner c) incidences of v, in the fixed
//            order of the vertex -> (tet, corner) table that
//            make_gather_sum(tets.reshape(-1), V) builds, of
//            H_t[3c:3c+3, :] . [v_i0; v_i1; v_i2; v_i3]
//
// What bounds it on the card: device-memory bytes. Each tet's 144 H values
// are read once per call (at 96,000 tets that is 55 MB in f32, 111 MB in
// f64, beside 2 flops per value), more than the 50 MB L2 holds.
//
// Design: three threads per vertex, one per output component. Each walks
// the vertex's incidence row of the table in order, reads the 12-value row
// slab of H_t it needs (the three threads of a vertex read one contiguous
// 3x12 slab), gathers the tet's 4 vertex rows of v, and accumulates in a
// register. The vertex-centric walk re-reads the small v gathers about 4x
// (once per corner of each tet) instead of scattering: it needs no float
// atomics and writes no per-corner intermediate, so the result is bitwise
// the same from run to run. H is read in its natural (T,12,12) layout: the
// TPU kernel's 1024-tet blocks, 48x128 DMA window and one-hot MXU gather
// were TPU-only devices and are not carried over.
//
// Interface: plain C, bound with ctypes (ipc_tpu_torch/ops/tet_hv.py). Every
// entry launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 192;  // 64 vertices x 3 components, 6 warps

template <typename T>
__global__ void __launch_bounds__(kThreads)
tet_hv_kernel(const T* __restrict__ H,         // (T,12,12)
              const T* __restrict__ v,         // (V,3)
              const int32_t* __restrict__ tets,  // (T,4)
              const int32_t* __restrict__ inc,   // (V,D) tet*4+corner, pad >= n_rows
              int n_verts, int D, int n_rows,
              T* __restrict__ out) {             // (V,3)
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)n_verts * 3) return;
  const int vert = (int)(gid / 3);
  const int k = (int)(gid - (long long)vert * 3);
  const int32_t* row = inc + (long long)vert * D;
  T acc = T(0);
  for (int d = 0; d < D; ++d) {
    const int i = __ldg(row + d);
    if (i >= n_rows) break;  // padding fills the end of each row
    const int t = i >> 2;
    const int c = i & 3;
    const T* Hr = H + (long long)t * 144 + (3 * c + k) * 12;
    const int32_t* tv = tets + (long long)t * 4;
    T s = T(0);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const T* vm = v + (long long)__ldg(tv + m) * 3;
      s += __ldg(Hr + 3 * m + 0) * __ldg(vm + 0);
      s += __ldg(Hr + 3 * m + 1) * __ldg(vm + 1);
      s += __ldg(Hr + 3 * m + 2) * __ldg(vm + 2);
    }
    acc += s;
  }
  out[gid] = acc;
}

template <typename T>
int launch(const void* H, const void* v, const void* tets, const void* inc,
           int n_verts, int D, int n_rows, void* out, void* stream) {
  const long long total = (long long)n_verts * 3;
  if (total > 0) {
    const int blocks = (int)((total + kThreads - 1) / kThreads);
    tet_hv_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)H, (const T*)v, (const int32_t*)tets, (const int32_t*)inc,
        n_verts, D, n_rows, (T*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ipc_tet_hv_f32(const void* H, const void* v, const void* tets,
                              const void* inc, int n_verts, int D, int n_rows,
                              void* out, void* stream) {
  return launch<float>(H, v, tets, inc, n_verts, D, n_rows, out, stream);
}

extern "C" int ipc_tet_hv_f64(const void* H, const void* v, const void* tets,
                              const void* inc, int n_verts, int D, int n_rows,
                              void* out, void* stream) {
  return launch<double>(H, v, tets, inc, n_verts, D, n_rows, out, stream);
}
