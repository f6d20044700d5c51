// The grid broad phase's walk, one warp per query primitive, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's grid broad phase
// (ipc_tpu/contact/spatial_hash.py::fused_candidates) is an XLA path over a
// fixed-K bucket table. The port's plain version, `_Family.keys` with
// `_run_plain` in ipc_tpu_torch/contact/spatial_hash.py, expands every
// (query cell, target) row of the registry to exact size in eager PyTorch
// (repeat_interleave, about twenty gathers and compares per row, chunks of
// 2^25 rows) and keeps a few per cent of them. This kernel walks the same
// rows without writing any of them out: a warp holds one query primitive in
// registers and its lanes stride the registry range of each of its query
// cells, testing each row as the plain version does.
//
// Semantics, exactly the plain version's. A row (q, t) of query cell c is
// kept when
//   1. c is the pair's canonical cell: c == max(i0(q), i0(t)) on every axis
//      (every overlapping pair lies in both boxes' cells, so it is kept once);
//   2. the swept AABBs overlap, compared in the working dtype;
//   3. the family's validity holds: no shared vertex, not both all-DBC, and
//      for edge-edge pairs q < t;
//   4. broadphase.reach_ok holds, in float32: box_dist(raw boxes)^2 <=
//      ((gap + |u_q - u_t| + w_q + w_t) (1 + 1e-5))^2.
// Its key is q * n_t + t.
//
// Two passes of the same walk, one launch each: the count pass writes each
// query's kept count; the caller scans them (exclusive), reads the totals
// back once, and the write pass writes the keys at those offsets, placed
// within a warp by ballot and popc, with no atomics: the order of the keys
// is the same in every run. The caller sorts the kept keys once.
//
// Rounding: reach_ok is the only arithmetic. Every product, sum and root is
// an _rn intrinsic in the order the plain version writes out (sums as
// (v0 + v1) + v2, `dot_ordered`; roots rounded to nearest, `sqrt_rn`,
// ops/distance.py), so nvcc contracts nothing into a multiply-add and the
// kernel, the plain version on the card and on the CPU keep the same pairs.
// The other tests are exact compares.
//
// What bounds it on this card: the rows it tests, not the bytes it reads
// once. A row reads its target id (8 B, coalesced), the target's cell key
// (8 B) and, for the rows in the canonical cell, its box (24 B f32, 48 B
// f64); the target arrays of a 303,750-tet mat fit in the 50 MB L2, so the
// rows are read from L2. Only the few rows whose boxes overlap read the
// topology and motion columns.
//
// Interface: plain C, bound with ctypes (ipc_tpu_torch/contact/spatial_hash.py).
// Every entry launches one grid on the caller's stream (none for zero
// queries), allocates nothing and returns cudaGetLastError() right after
// the launch. `write` names the pass: 0, the count pass, writes `counts`
// and reads neither `offsets` nor `keys`; 1, the write pass, reads
// `offsets` and writes `keys` (at most their sum, so a pass whose queries
// keep nothing writes nothing) and leaves `counts` alone. The pointers a
// pass does not use may be null.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // query primitives per block
constexpr int kThreads = 32 * kWarps;
constexpr int kBits = 21;  // per-axis bits of a cell key (spatial_hash._BITS)
constexpr int64_t kMask = (int64_t(1) << kBits) - 1;
constexpr float kInfl = static_cast<float>(1.0 + 1e-5);  // reach_ok's inflation

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(double v) { return __double2float_rn(v); }

// torch.maximum and torch.clamp(min=0): a NaN operand propagates
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
__device__ __forceinline__ float clamp0(float v) { return v != v ? v : (v < 0.0f ? 0.0f : v); }

// dot_ordered: (x + y) + z
__device__ __forceinline__ float dot3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

template <typename T>
struct Walk {
  const int64_t* q_i0;   // (nq, 3) cell of each query box's lower corner
  const int64_t* lo;     // (nq, 8) first registry row of each query cell
  const int64_t* n;      // (nq, 8) registry rows of each query cell (0: not walked)
  const int64_t* prims;  // the registry's targets, sorted by cell key
  const int64_t* t_key;  // (nt,) key of each target's lower cell
  const T* q_box;        // (nq, 2, 3) swept, gap-inflated AABBs
  const T* t_box;
  const T* q_rb;         // (nq, 2, 3) position AABBs, u (nq, 3), w (nq,)
  const T* q_u;
  const T* q_w;
  const T* t_rb;
  const T* t_u;
  const T* t_w;
  const int64_t* q_v;    // (nq, KQ) / (nt, KT) vertex ids
  const int64_t* t_v;
  const uint8_t* q_dbc;  // all-DBC bits, or null (no DBC test)
  const uint8_t* t_dbc;
  int64_t nq;
  int64_t n_t;
  float gap;
  bool write;              // the write pass (else the count pass)
  int64_t* counts;         // count pass: (nq,) kept pairs per query
  const int64_t* offsets;  // write pass: (nq,) exclusive scan of counts
  int64_t* keys;           // write pass: q * n_t + t of the kept pairs
};

template <typename T, int KQ, int KT, bool kOrdered>
__global__ void __launch_bounds__(kThreads) grid_walk(Walk<T> w) {
  const int lane = threadIdx.x & 31;
  const int64_t q = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (q >= w.nq) return;  // the whole warp: q is the warp's
  const int64_t qx = w.q_i0[3 * q], qy = w.q_i0[3 * q + 1], qz = w.q_i0[3 * q + 2];
  T blo[3], bhi[3];
  float rlo[3], rhi[3], u[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    blo[d] = w.q_box[6 * q + d];
    bhi[d] = w.q_box[6 * q + 3 + d];
    rlo[d] = f32(w.q_rb[6 * q + d]);
    rhi[d] = f32(w.q_rb[6 * q + 3 + d]);
    u[d] = f32(w.q_u[3 * q + d]);
  }
  const float wq = f32(w.q_w[q]);
  int64_t qv[KQ];
#pragma unroll
  for (int i = 0; i < KQ; ++i) qv[i] = w.q_v[KQ * q + i];
  const bool qd = w.q_dbc != nullptr && w.q_dbc[q] != 0;
  const bool write = w.write;
  const unsigned below = (1u << lane) - 1u;
  int64_t out = write ? w.offsets[q] : 0;
  for (int c = 0; c < 8; ++c) {
    const int64_t rows = w.n[8 * q + c];  // the same for every lane
    if (rows == 0) continue;
    const int64_t base = w.lo[8 * q + c];
    const int64_t cx = qx + ((c >> 2) & 1), cy = qy + ((c >> 1) & 1), cz = qz + (c & 1);
    for (int64_t j = 0; j < rows; j += 32) {
      const int64_t r = j + lane;
      int64_t t = 0;
      bool keep = false;
      if (r < rows) {
        t = w.prims[base + r];
        const int64_t tk = w.t_key[t];
        const int64_t tx = tk >> (2 * kBits), ty = (tk >> kBits) & kMask, tz = tk & kMask;
        keep = (qx > tx ? qx : tx) == cx && (qy > ty ? qy : ty) == cy &&
               (qz > tz ? qz : tz) == cz;
        if (keep) {
#pragma unroll
          for (int d = 0; d < 3; ++d)
            keep = keep && !(blo[d] > w.t_box[6 * t + 3 + d]) && !(w.t_box[6 * t + d] > bhi[d]);
        }
        if (keep) {
          if (kOrdered) keep = q < t;
#pragma unroll
          for (int i = 0; i < KQ; ++i)
#pragma unroll
            for (int k = 0; k < KT; ++k) keep = keep && qv[i] != w.t_v[KT * t + k];
          if (qd && w.t_dbc[t] != 0) keep = false;
        }
        if (keep) {
          float g[3], du[3];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            g[d] = clamp0(maximum(__fsub_rn(rlo[d], f32(w.t_rb[6 * t + 3 + d])),
                                  __fsub_rn(f32(w.t_rb[6 * t + d]), rhi[d])));
            du[d] = __fsub_rn(u[d], f32(w.t_u[3 * t + d]));
          }
          const float d2 = dot3(g[0], g[1], g[2]);
          const float rel = __fadd_rn(__fadd_rn(__fsqrt_rn(dot3(du[0], du[1], du[2])), wq),
                                      f32(w.t_w[t]));
          const float reach = __fmul_rn(__fadd_rn(w.gap, rel), kInfl);
          keep = d2 <= __fmul_rn(reach, reach);
        }
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (write && keep) w.keys[out + __popc(ballot & below)] = q * w.n_t + t;
      out += __popc(ballot);
    }
  }
  if (!write && lane == 0) w.counts[q] = out;
}

template <typename T, int KQ, int KT, bool kOrdered>
int launch(const int64_t* q_i0, const int64_t* lo, const int64_t* n, const int64_t* prims,
           const int64_t* t_key, const void* q_box, const void* t_box, const void* q_rb,
           const void* q_u, const void* q_w, const void* t_rb, const void* t_u,
           const void* t_w, const int64_t* q_v, const int64_t* t_v, const uint8_t* q_dbc,
           const uint8_t* t_dbc, int64_t nq, int64_t n_t, double gap, int write,
           int64_t* counts, const int64_t* offsets, int64_t* keys, cudaStream_t stream) {
  Walk<T> w{q_i0, lo, n, prims, t_key,
            static_cast<const T*>(q_box), static_cast<const T*>(t_box),
            static_cast<const T*>(q_rb), static_cast<const T*>(q_u),
            static_cast<const T*>(q_w), static_cast<const T*>(t_rb),
            static_cast<const T*>(t_u), static_cast<const T*>(t_w),
            q_v, t_v, q_dbc, t_dbc, nq, n_t,
            static_cast<float>(gap),  // torch.tensor(gap, dtype=float32): to nearest
            write != 0, counts, offsets, keys};
  if (nq > 0) {
    const int64_t blocks = (nq + kWarps - 1) / kWarps;
    grid_walk<T, KQ, KT, kOrdered><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define IPC_GRID_ENTRY(name, T, KQ, KT, ORDERED)                                             \
  extern "C" int name(const int64_t* q_i0, const int64_t* lo, const int64_t* n,            \
                      const int64_t* prims, const int64_t* t_key, const void* q_box,       \
                      const void* t_box, const void* q_rb, const void* q_u,                \
                      const void* q_w, const void* t_rb, const void* t_u, const void* t_w, \
                      const int64_t* q_v, const int64_t* t_v, const uint8_t* q_dbc,         \
                      const uint8_t* t_dbc, int64_t nq, int64_t n_t, double gap,           \
                      int write, int64_t* counts, const int64_t* offsets, int64_t* keys,   \
                      cudaStream_t stream) {                                               \
    return launch<T, KQ, KT, ORDERED>(q_i0, lo, n, prims, t_key, q_box, t_box, q_rb, q_u,  \
                                      q_w, t_rb, t_u, t_w, q_v, t_v, q_dbc, t_dbc, nq,     \
                                      n_t, gap, write, counts, offsets, keys, stream);     \
  }

// point-triangle: a surface vertex against triangles
IPC_GRID_ENTRY(ipc_grid_pt_f32, float, 1, 3, false)
IPC_GRID_ENTRY(ipc_grid_pt_f64, double, 1, 3, false)
// edge-edge: an edge against the edges of higher id
IPC_GRID_ENTRY(ipc_grid_ee_f32, float, 2, 2, true)
IPC_GRID_ENTRY(ipc_grid_ee_f64, double, 2, 2, true)
// edge-triangle
IPC_GRID_ENTRY(ipc_grid_et_f32, float, 2, 3, false)
IPC_GRID_ENTRY(ipc_grid_et_f64, double, 2, 3, false)
