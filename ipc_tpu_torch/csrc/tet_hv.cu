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
// Design: two passes, one launch each, on the caller's stream.
//
//   Pass A, tet-major (tet_rows_kernel). Persistent blocks, as many per SM
//   as fit (4 in f32, 5 in f64: the grid is the SM count times the
//   occupancy), walk tiles of B tets (tile = blockIdx.x + k * gridDim.x).
//   A tile of H is contiguous in the (T,12,12) layout, 18,432 bytes in
//   both types (f32: B = 32; f64: B = 16), and so is its (B,4) slice of
//   tets: thread 0 brings both in with two TMA 1-D bulk copies
//   (cp.async.bulk ... mbarrier::complete_tx::bytes) into a two-stage
//   shared-memory ring, one tile ahead of the one being computed. With
//   several blocks per SM, one block's arithmetic and L2 gathers overlap
//   the others' copies, so the H stream keeps going. Per tile, the block
//   gathers the tile's vertex rows of v into shared memory (one L2 load per
//   thread: 12 threads per tet, thread r loads component r%3 of vertex
//   r/3), then each thread computes one output row, H_t[r,:] . v4_t,
//   reading its H row (48 bytes in f32, threads 48 bytes apart: no bank
//   conflicts) as 16-byte loads, and writes it to rows[12 t + r], i.e. rows
//   (4T,3) laid out as the plain version's hv.reshape(-1, 3). Neighbouring
//   threads write neighbouring addresses. The rows scratch (4.6 MB in f32
//   at 96,000 tets) stays in L2 for pass B.
//
//   Pass B, vertex-major (vertex_sum_kernel). One thread per (vertex,
//   component) sums that vertex's rows listed in inc[v,:], in the table's
//   ascending order, the order of the plain version's gather-sum table.
//   No float atomics: the result is
//   bitwise the same from run to run. Pass B is a programmatic dependent
//   launch: its blocks start while pass A's last tiles run, load their
//   indices (up to 32 at once; the table does not depend on pass A), and
//   only then wait (griddepcontrol.wait) for pass A's rows.
//
// The last tile is ragged (a tet is 576 or 1,152 bytes, a multiple of 16,
// so its bulk copy is legal); H and tets must be 16-byte aligned, which the
// wrapper checks. The TPU kernel's 1024-tet blocks, 48x128 DMA window and
// one-hot MXU gather were TPU-only devices and are not carried over; H's
// symmetry is not used (it is symmetric only to rounding after the SPD
// projection).
//
// Interface: plain C, bound with ctypes (ipc_tpu_torch/ops/tet_hv.py). Every
// entry launches both passes on the caller's stream, allocates nothing (the
// caller passes the rows scratch and the output), and returns
// cudaGetLastError() right after the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSumThreads = 256;   // pass B block
constexpr int kSumChunk = 32;      // pass B indices held in registers

template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int B = 32, S = 2; };
template <> struct Tile<double> { static constexpr int B = 16, S = 2; };

template <typename T>
struct Layout {
  static constexpr int B = Tile<T>::B, S = Tile<T>::S;
  static constexpr int kThreads = 12 * B;
  static constexpr int kHBytes = B * 144 * (int)sizeof(T);  // 18,432 in both types
  static constexpr int kTetBytes = B * 4 * 4;
  static constexpr int kH = 0;                              // S x (B,12,12)
  static constexpr int kTets = kH + S * kHBytes;            // S x (B,4) int32
  static constexpr int kV4 = kTets + S * kTetBytes;         // (B,12)
  static constexpr int kBar = kV4 + B * 12 * (int)sizeof(T);  // S mbarriers
  static constexpr int kBytes = kBar + S * 8;
  static_assert(kBytes <= 48 * 1024, "the ring fits the default dynamic shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ bool bar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Thread 0 only: arm `bar` for `bytes_h + bytes_t` bytes and start the two
// bulk copies that complete it.
__device__ __forceinline__ void load_tile(uint64_t* bar, void* dst_h, const void* src_h,
                                          uint32_t bytes_h, void* dst_t, const void* src_t,
                                          uint32_t bytes_t) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes_h + bytes_t)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst_h)), "l"(src_h), "r"(bytes_h), "r"(smem_addr(bar))
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst_t)), "l"(src_t), "r"(bytes_t), "r"(smem_addr(bar))
      : "memory");
}

template <typename T>
__global__ void __launch_bounds__(Layout<T>::kThreads)
tet_rows_kernel(const T* __restrict__ H,            // (T,12,12)
                const T* __restrict__ v,            // (V,3)
                const int32_t* __restrict__ tets,   // (T,4)
                int n_tets,
                T* __restrict__ rows) {             // (4T,3) == (T,12)
  using L = Layout<T>;
  constexpr int B = L::B, S = L::S;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sH = reinterpret_cast<T*>(smem + L::kH);
  int32_t* sTets = reinterpret_cast<int32_t*>(smem + L::kTets);
  T* sV4 = reinterpret_cast<T*>(smem + L::kV4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);

  const int tid = threadIdx.x;
  const int n_tiles = (n_tets + B - 1) / B;
  const int my_tiles = blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  auto issue = [&](int k) {  // thread 0: local tile k into stage k % S
    const int tile = blockIdx.x + k * gridDim.x;
    const int stage = k % S;
    const int n = min(B, n_tets - tile * B);
    load_tile(&bars[stage], sH + (size_t)stage * B * 144, H + (size_t)tile * B * 144,
              (uint32_t)(n * 144 * sizeof(T)), sTets + stage * B * 4,
              tets + (size_t)tile * B * 4, (uint32_t)(n * 16));
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) bar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < S && k < my_tiles; ++k) issue(k);
  }
  __syncthreads();

  const int t_local = tid / 12;  // this thread's tet within the tile
  const int r = tid - 12 * t_local;  // and its output row
  for (int k = 0; k < my_tiles; ++k) {
    const int tile = blockIdx.x + k * gridDim.x;
    const int stage = k % S;
    const int n = min(B, n_tets - tile * B);
    const bool live = t_local < n;
    if (k == my_tiles - 1) asm volatile("griddepcontrol.launch_dependents;");
    while (!bar_try_wait(&bars[stage], (uint32_t)((k / S) & 1))) {
    }
    if (live) {
      const int vert = sTets[stage * B * 4 + t_local * 4 + r / 3];
      sV4[tid] = __ldg(v + (size_t)vert * 3 + (r % 3));
    }
    __syncthreads();  // sV4 complete
    if (live) {
      const T* h = sH + (size_t)stage * B * 144 + (size_t)tid * 12;  // row r of tet t_local
      const T* x = sV4 + t_local * 12;
      T hr[12], xr[12];
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float4 a = reinterpret_cast<const float4*>(h)[q];
          const float4 b = reinterpret_cast<const float4*>(x)[q];
          hr[4 * q + 0] = a.x; hr[4 * q + 1] = a.y; hr[4 * q + 2] = a.z; hr[4 * q + 3] = a.w;
          xr[4 * q + 0] = b.x; xr[4 * q + 1] = b.y; xr[4 * q + 2] = b.z; xr[4 * q + 3] = b.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const double2 a = reinterpret_cast<const double2*>(h)[q];
          const double2 b = reinterpret_cast<const double2*>(x)[q];
          hr[2 * q + 0] = a.x; hr[2 * q + 1] = a.y;
          xr[2 * q + 0] = b.x; xr[2 * q + 1] = b.y;
        }
      }
      T s = T(0);
#pragma unroll
      for (int j = 0; j < 12; ++j) s += hr[j] * xr[j];
      rows[(size_t)tile * B * 12 + tid] = s;
    }
    __syncthreads();  // stage and sV4 free again
    if (tid == 0 && k + S < my_tiles) issue(k + S);
  }
}

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
vertex_sum_kernel(const T* __restrict__ rows,       // (4T,3), written by pass A
                  const int32_t* __restrict__ inc,  // (V,D) tet*4+corner, pad >= n_rows
                  int n_verts, int D, int n_rows,
                  T* __restrict__ out) {            // (V,3)
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)n_verts * 3) return;
  const int vert = (int)(gid / 3);
  const int k = (int)(gid - (long long)vert * 3);
  const int32_t* row = inc + (size_t)vert * D;
  // The table does not depend on pass A: load the first kSumChunk indices
  // while pass A finishes, then wait for its rows.
  int idx[kSumChunk];
#pragma unroll
  for (int u = 0; u < kSumChunk; ++u) idx[u] = u < D ? __ldg(row + u) : n_rows;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // Rows are read with ld.global.ca, not through the read-only (.nc) path,
  // whose contract is data unchanged for the grid's lifetime: pass A writes
  // them while this grid is already resident. griddepcontrol.wait makes
  // those writes visible, and L1 still serves the four corner rows of a tet
  // that share a sector.
  T val[kSumChunk];
#pragma unroll
  for (int u = 0; u < kSumChunk; ++u)
    val[u] = idx[u] < n_rows ? __ldca(rows + (size_t)idx[u] * 3 + k) : T(0);
  T acc = T(0);
#pragma unroll
  for (int u = 0; u < kSumChunk; ++u)
    if (idx[u] < n_rows) acc += val[u];
  // Degrees above kSumChunk (none in a box grid, D = 24): one at a time.
  // Padding fills the end of each row.
  for (int d = kSumChunk; d < D && idx[kSumChunk - 1] < n_rows; ++d) {
    const int i = __ldg(row + d);
    if (i >= n_rows) break;
    acc += __ldca(rows + (size_t)i * 3 + k);
  }
  out[gid] = acc;
}

template <typename T>
int launch(const void* H, const void* v, const void* tets, const void* inc, int n_tets,
           int n_verts, int D, void* rows, void* out, void* stream) {
  using L = Layout<T>;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (n_tets + L::B - 1) / L::B;
  if (n_tiles > 0) {
    // Size the persistent grid once per device: every block that fits.
    static int ready_dev = -1, grid_cap = 0;
    int dev = 0;
    cudaGetDevice(&dev);
    if (ready_dev != dev) {
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tet_rows_kernel<T>, L::kThreads,
                                                    L::kBytes);
      grid_cap = sms * (per_sm > 0 ? per_sm : 1);
      ready_dev = dev;
    }
    const int grid = n_tiles < grid_cap ? n_tiles : grid_cap;
    tet_rows_kernel<T><<<grid, L::kThreads, L::kBytes, st>>>(
        (const T*)H, (const T*)v, (const int32_t*)tets, n_tets, (T*)rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long total = (long long)n_verts * 3;
  if (total > 0) {
    // Programmatic dependent launch: pass B's blocks may start once every
    // pass A block has begun its last tile; griddepcontrol.wait in pass B
    // then waits for all of pass A and its writes.
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((total + kSumThreads - 1) / kSumThreads));
    cfg.blockDim = dim3(kSumThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, vertex_sum_kernel<T>, (const T*)rows, (const int32_t*)inc, n_verts,
                       D, 4 * n_tets, (T*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ipc_tet_hv_f32(const void* H, const void* v, const void* tets, const void* inc,
                              int n_tets, int n_verts, int D, void* rows, void* out,
                              void* stream) {
  return launch<float>(H, v, tets, inc, n_tets, n_verts, D, rows, out, stream);
}

extern "C" int ipc_tet_hv_f64(const void* H, const void* v, const void* tets, const void* inc,
                              int n_tets, int n_verts, int D, void* rows, void* out,
                              void* stream) {
  return launch<double>(H, v, tets, inc, n_tets, n_verts, D, rows, out, stream);
}
