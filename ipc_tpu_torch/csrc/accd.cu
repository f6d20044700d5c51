// Additive CCD (ACCD), one thread per stencil, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs ACCD as a `fori_loop` of
// max_iter passes under XLA (ipc_tpu/contact/ccd.py). The port's plain
// version, `_accd` in ipc_tpu_torch/contact/ccd.py, runs those passes as
// eager PyTorch over every stencil at once: each pass evaluates the
// closest-point classifier and every branch distance and selects with
// `torch.where`, some 150-250 launches a pass, 64 passes a call, while all
// but a few per cent of the pairs are already done. This kernel does the
// same arithmetic for one stencil per thread, in registers, and a thread
// leaves its loop when its pair is done: one launch per call and family.
//
// Semantics, exactly the plain version's. Per pair: centre p4 on its mean;
// the norms of the four displacements; l_p, the larger of the point-
// triangle and the edge-edge bounds; d0 at t = 0, the preserved gap g =
// slackness * d0, no_motion = l_p <= 0, l_safe, d0_floor. Then for
// k < max_iter: stop if done; d at x4 + t * p4 (region-aware squared
// distance: classify with the precedence of dtype_PT / dtype_EE, including
// the dtype-aware near-parallel threshold, then evaluate the selected
// branch only); step = 0.9 (d - g) / l_safe; t_new = min(t + step, t_max);
// done = step <= d0_floor or t >= t_max (from the old t); t = t_new. Last,
// no_motion gives t_max and t is clamped at 0. A done pair keeps its t and
// done never clears, so leaving the loop changes no result.
//
// Rounding: every product, sum, quotient and root is an _rn intrinsic in
// the plain version's order, so nvcc fuses no multiply-add that ATen's
// separate kernels do not (the library's flags stay as they are; tet_hv.cu
// shares them). The plain version writes its sums out in one order on
// every device, and the kernel takes it: a dot product or a norm as
// (v0 + v1) + v2 (`dot_ordered`, ops/distance.py, which ATen's CPU sum
// matches and its CUDA sum, (v0 + v2) + v1, does not), the mean of the four
// displacements as ((v0 + v1) + v2) + v3, times 1/4. So the kernel, the
// plain version on the card and the plain version on the CPU agree bit for
// bit, and with them a CCD-clamped scripted step.
//
// What bounds it on this card: not bytes. A pair reads 96 B in f32 (192 B
// in f64: x4 and p4) and writes t (and, when asked, its live-pass count);
// the rest is the arithmetic of the passes the pair is live for, about 300
// flops a pass. A warp runs as long as its slowest pair, so one pair that
// takes all max_iter passes holds 31 finished lanes.
//
// Interface: plain C, bound with ctypes (ipc_tpu_torch/contact/ccd.py).
// Every entry launches one grid on the caller's stream, allocates nothing
// and returns cudaGetLastError() right after the launch. `live` may be
// null; otherwise it receives per pair the passes it began not done (the
// plain version's max_iter less the passes it began done).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename T> struct R;
template <> struct R<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static constexpr double kParaEps = 1e-6;
};
template <> struct R<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static constexpr double kParaEps = 1e-20;
};

template <typename T> struct V3 { T x, y, z; };

template <typename T>
__device__ __forceinline__ V3<T> vsub(V3<T> a, V3<T> b) {
  return {R<T>::sub(a.x, b.x), R<T>::sub(a.y, b.y), R<T>::sub(a.z, b.z)};
}

// dot_ordered: (x + y) + z
template <typename T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
  return R<T>::add(R<T>::add(R<T>::mul(a.x, b.x), R<T>::mul(a.y, b.y)), R<T>::mul(a.z, b.z));
}

template <typename T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return {R<T>::sub(R<T>::mul(a.y, b.z), R<T>::mul(a.z, b.y)),
          R<T>::sub(R<T>::mul(a.z, b.x), R<T>::mul(a.x, b.z)),
          R<T>::sub(R<T>::mul(a.x, b.y), R<T>::mul(a.y, b.x))};
}

template <typename T>
__device__ __forceinline__ T safe_div(T num, T den) {
  return den > T(0) ? R<T>::div(num, den) : T(0);
}

// torch.maximum and torch.clamp: a NaN operand propagates
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) { return v != v ? v : (v < lo ? lo : v); }
template <typename T>
__device__ __forceinline__ T clamp_max(T v, T hi) { return v != v ? v : (v > hi ? hi : v); }

template <typename T>
__device__ __forceinline__ T d_pp(V3<T> a, V3<T> b) {
  V3<T> d = vsub(a, b);
  return dot(d, d);
}

template <typename T>
__device__ __forceinline__ T d_pe(V3<T> p, V3<T> e0, V3<T> e1) {
  V3<T> e = vsub(e1, e0);
  V3<T> c = cross(e, vsub(p, e0));
  return safe_div(dot(c, c), dot(e, e));
}

// squared distance to the plane of (a, b, c) / of the lines' common normal
template <typename T>
__device__ __forceinline__ T d_plane(V3<T> p, V3<T> o, V3<T> n) {
  T q = dot(vsub(p, o), n);
  return safe_div(R<T>::mul(q, q), dot(n, n));
}

// (t, s) of p against edge (e0, e1) of a triangle with normal n
template <typename T>
__device__ __forceinline__ void edge_region(V3<T> p, V3<T> e0, V3<T> e1, V3<T> n, T& t, T& s) {
  V3<T> e = vsub(e1, e0);
  V3<T> out = cross(e, n);
  V3<T> r = vsub(p, e0);
  t = safe_div(dot(r, e), dot(e, e));
  s = safe_div(dot(r, out), dot(out, out));
}

// point_triangle_dist2: dtype_PT's precedence, then its branch alone
template <typename T>
__device__ T pt_dist2(V3<T> p, V3<T> t0, V3<T> t1, V3<T> t2) {
  V3<T> n = cross(vsub(t1, t0), vsub(t2, t0));
  T ta, sa, tb, sb, tc, sc;
  edge_region(p, t0, t1, n, ta, sa);
  edge_region(p, t1, t2, n, tb, sb);
  edge_region(p, t2, t0, n, tc, sc);
  const T zero(0), one(1);
  if (ta > zero && ta < one && sa >= zero) return d_pe(p, t0, t1);
  if (tb > zero && tb < one && sb >= zero) return d_pe(p, t1, t2);
  if (tc > zero && tc < one && sc >= zero) return d_pe(p, t2, t0);
  if (ta <= zero && tc >= one) return d_pp(p, t0);
  if (tb <= zero && ta >= one) return d_pp(p, t1);
  if (tc <= zero && tb >= one) return d_pp(p, t2);
  return d_plane(p, t0, n);
}

// edge_edge_dist2: dtype_EE's precedence, then its branch alone
template <typename T>
__device__ T ee_dist2(V3<T> a0, V3<T> a1, V3<T> b0, V3<T> b1) {
  V3<T> u = vsub(a1, a0), v = vsub(b1, b0), w = vsub(a0, b0);
  T a = dot(u, u), b = dot(u, v), c = dot(v, v), d = dot(u, w), e = dot(v, w);
  T D = R<T>::sub(R<T>::mul(a, c), R<T>::mul(b, b));
  T sN = R<T>::sub(R<T>::mul(b, e), R<T>::mul(c, d));
  T tN_mid = R<T>::sub(R<T>::mul(a, e), R<T>::mul(b, d));
  V3<T> uxv = cross(u, v);
  const T zero(0);
  bool para = dot(uxv, w) == zero ||
              dot(uxv, uxv) < R<T>::mul(R<T>::mul(a, T(R<T>::kParaEps)), c);
  bool mid_deflect = tN_mid > zero && tN_mid < D && para;
  bool mid_low = mid_deflect && sN < R<T>::mul(D, T(0.5));
  int case_s = sN <= zero ? 0 : sN >= D ? 1 : mid_low ? 0 : mid_deflect ? 1 : 2;
  T tN = case_s == 0 ? e : case_s == 1 ? R<T>::add(e, b) : tN_mid;
  T tD = case_s == 2 ? D : c;
  int code;
  if (tN <= zero) {
    T nd = -d;
    code = nd <= zero ? 0 : nd >= a ? 3 : 6;
  } else if (tN >= tD) {
    T nd = R<T>::add(-d, b);
    code = nd <= zero ? 1 : nd >= a ? 4 : 7;
  } else {
    code = case_s == 0 ? 2 : case_s == 1 ? 5 : 8;
  }
  switch (code) {
    case 0: return d_pp(a0, b0);
    case 1: return d_pp(a0, b1);
    case 2: return d_pe(a0, b0, b1);
    case 3: return d_pp(a1, b0);
    case 4: return d_pp(a1, b1);
    case 5: return d_pe(a1, b0, b1);
    case 6: return d_pe(b0, a0, a1);
    case 7: return d_pe(b1, a0, a1);
    default: return d_plane(a0, b0, uxv);
  }
}

template <typename T, bool kEE>
__device__ __forceinline__ T dist(const T (&y)[12]) {
  V3<T> q0{y[0], y[1], y[2]}, q1{y[3], y[4], y[5]}, q2{y[6], y[7], y[8]},
      q3{y[9], y[10], y[11]};
  T d2 = kEE ? ee_dist2(q0, q1, q2, q3) : pt_dist2(q0, q1, q2, q3);
  return R<T>::sqrt(clamp_min(d2, T(0)));
}

// One pair's safe step; *live = the passes it began not done.
template <typename T, bool kEE>
__device__ T accd_pair(const T* __restrict__ xg, const T* __restrict__ pg, T slackness,
                       int max_iter, T t_max, int* live) {
  T x[12], p[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    x[k] = xg[k];
    p[k] = pg[k];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    T m = R<T>::mul(R<T>::add(R<T>::add(R<T>::add(p[j], p[3 + j]), p[6 + j]), p[9 + j]),
                    T(0.25));
#pragma unroll
    for (int i = 0; i < 4; ++i) p[3 * i + j] = R<T>::sub(p[3 * i + j], m);
  }
  T nrm[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    V3<T> q{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
    nrm[i] = R<T>::sqrt(dot(q, q));
  }
  T l_p = R<T>::add(clamp_min(nrm[0], T(0)), maximum(maximum(nrm[1], nrm[2]), nrm[3]));
  T l_p_ee = R<T>::add(maximum(nrm[0], nrm[1]), maximum(nrm[2], nrm[3]));
  l_p = maximum(l_p, l_p_ee);
  const T d0 = dist<T, kEE>(x);
  const T g = R<T>::mul(d0, slackness);
  const bool no_motion = l_p <= T(0);
  const T l_safe = clamp_min(l_p, T(1e-30));
  const T d0_floor = R<T>::mul(clamp_min(d0, T(1e-30)), T(1e-6));
  T t(0);
  bool done = no_motion;
  int n_live = 0;
  for (int k = 0; k < max_iter; ++k) {
    if (done) break;
    ++n_live;
    T y[12];
#pragma unroll
    for (int q = 0; q < 12; ++q) y[q] = R<T>::add(x[q], R<T>::mul(t, p[q]));
    T d = dist<T, kEE>(y);
    T step = R<T>::div(R<T>::mul(R<T>::sub(d, g), T(0.9)), l_safe);
    T t_new = clamp_max(R<T>::add(t, step), t_max);
    done = step <= d0_floor || t >= t_max;
    t = t_new;
  }
  *live = n_live;
  if (no_motion) t = t_max;
  return clamp_min(t, T(0));
}

template <typename T, bool kEE>
__global__ void __launch_bounds__(kThreads)
accd_kernel(const T* __restrict__ x4, const T* __restrict__ p4, int n, T slackness,
            int max_iter, T t_max, T* __restrict__ t_out, int* __restrict__ live_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t off = 12 * int64_t(i);
  int live;
  t_out[i] = accd_pair<T, kEE>(x4 + off, p4 + off, slackness, max_iter, t_max, &live);
  if (live_out != nullptr) live_out[i] = live;
}

template <typename T, bool kEE>
int launch(const void* x4, const void* p4, int n, double slackness, int max_iter, double t_max,
           void* t, void* live, void* stream) {
  if (n <= 0) return 0;
  accd_kernel<T, kEE><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x4), static_cast<const T*>(p4), n, T(slackness), max_iter,
      T(t_max), static_cast<T*>(t), static_cast<int*>(live));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ipc_accd_pt_f32(const void* x4, const void* p4, int n, double slackness,
                               int max_iter, double t_max, void* t, void* live, void* stream) {
  return launch<float, false>(x4, p4, n, slackness, max_iter, t_max, t, live, stream);
}

extern "C" int ipc_accd_pt_f64(const void* x4, const void* p4, int n, double slackness,
                               int max_iter, double t_max, void* t, void* live, void* stream) {
  return launch<double, false>(x4, p4, n, slackness, max_iter, t_max, t, live, stream);
}

extern "C" int ipc_accd_ee_f32(const void* x4, const void* p4, int n, double slackness,
                               int max_iter, double t_max, void* t, void* live, void* stream) {
  return launch<float, true>(x4, p4, n, slackness, max_iter, t_max, t, live, stream);
}

extern "C" int ipc_accd_ee_f64(const void* x4, const void* p4, int n, double slackness,
                               int max_iter, double t_max, void* t, void* live, void* stream) {
  return launch<double, true>(x4, p4, n, slackness, max_iter, t_max, t, live, stream);
}
