// The active pairs' barrier terms, one thread per stencil, for Hopper (sm_90a):
// per-pair energies, gradients and PSD-projected 12x12 Hessian blocks of the
// point-triangle (PT) and edge-edge (EE) self-contact barrier.
//
// Replaces no Pallas kernel: the JAX package differentiates the pair energies
// with jax.grad / jax.hessian under vmap and projects the blocks with a
// batched eigh (ipc_tpu/contact/selfcollision.py, ipc_tpu/ops/spd.py). The
// port's plain version (contact/selfcollision.py, ops/spd.py) does the same
// with torch.func.vmap(grad / hessian) and torch.linalg.eigh: some 2,300-2,800
// dispatched ops a Hessian call, ~7,400 a Newton iteration. This file computes
// the same mathematics for one stencil per thread in one launch per call and
// family (contact/pair_terms.py routes CUDA tensors here).
//
// Per stencil (vids (N,4) rows of x (V,3)): subtract the centroid
// ((x0 + x1) + x2) + x3, times 1/4; classify the closest-point type with the
// precedence of dtype_PT / dtype_EE (ops/distance.py), every product, sum and
// quotient an _rn intrinsic in the plain version's order, its dot products
// summed (v0 + v2) + v1 as ATen's CUDA sum over 3 values does, so the code is
// the plain version's on the card; reduce the stencil through the slot table
// (contact/selfcollision.py PT_SLOTS / EE_SLOTS) to 2, 3 or 4 points; the
// squared distance d of the reduced type (PP, PE, plane of a triangle, lines
// of two edges) in closed form with its gradient and Hessian, written as a
// quotient N / M of polynomials in 1-3 difference vectors (MeshCollisionUtils'
// PP / PE / PT / EE distances); the C2 clamped log barrier b(d) (ops/barrier.py)
// and its chain b' grad d, b'' grad d grad d^T + b' hess d, exactly zero for
// d >= dHat or d <= 0. For EE the mollifier e(x) on the uncentered stencil
// (ops/distance.mollifier_ee) with its product rule. The result is scattered
// into the original stencil's 12 slots; the slots the reduced type leaves
// unused get exact zeros.
//
// PSD projection: the reduced 6x6, 9x9 or 12x12 block (12x12 where the
// mollifier is active: it reads all four points) is eigen-clamped before the
// scatter. A symmetric matrix bordered by zero rows and columns has the same
// nonzero eigenpairs, so this is make_psd's projection of the 12x12. Cyclic
// Jacobi rotations, run until a sweep finds every off-diagonal entry below
// 2 eps of its diagonal pair's magnitude or eps ||A||_F (at most kMaxSweeps
// sweeps), then Q max(w, 0) Q^T: the reference's makePD on the same block.
//
// Layout: the energy and gradient entries hold everything in registers. The
// blocks entry keeps each thread's packed upper triangle of A (78 values)
// and its eigenvectors (144) in shared memory, laid out [entry][thread] so a
// warp's threads touch 32 consecutive banks.
//
// Interface: plain C, bound with ctypes (contact/pair_terms.py). Every entry
// launches one grid on the caller's stream, allocates nothing and returns
// cudaGetLastError() right after the launch. `eps` (EE mollifier thresholds)
// is read by the EE entries only; kappa is *kappa_ptr where that is not null,
// else `kappa`; `code` and `sweeps` may be null, else they receive each
// stencil's dType code and the Jacobi sweeps its block took (0 where none ran).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pair_terms {

enum What { kEnergy = 0, kGrad = 1, kBlocks = 2 };

constexpr int kMaxSweeps = 16;
constexpr int kPacked = 78;  // packed upper triangle of a 12x12
constexpr int kSmemPerThread = kPacked + 144;

template <typename T> struct R;
template <> struct R<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ float log(float a) { return logf(a); }
  static __device__ float sqrt(float a) { return sqrtf(a); }
  static constexpr float kParaEps = 1e-6f;
  static constexpr float kEps = 1.1920929e-07f;
};
template <> struct R<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ double log(double a) { return ::log(a); }
  static __device__ double sqrt(double a) { return ::sqrt(a); }
  static constexpr double kParaEps = 1e-20;
  static constexpr double kEps = 2.220446049250313e-16;
};

template <typename T> struct V3 { T x, y, z; };

// --- the plain version's rounding: classification and the distance value ----

template <typename T>
__device__ inline V3<T> rsub(V3<T> a, V3<T> b) {
  return {R<T>::sub(a.x, b.x), R<T>::sub(a.y, b.y), R<T>::sub(a.z, b.z)};
}

// ATen's CUDA sum over a last axis of 3: (v0 + v2) + v1
template <typename T>
__device__ inline T rdot(V3<T> a, V3<T> b) {
  return R<T>::add(R<T>::add(R<T>::mul(a.x, b.x), R<T>::mul(a.z, b.z)), R<T>::mul(a.y, b.y));
}

template <typename T>
__device__ inline V3<T> rcross(V3<T> a, V3<T> b) {
  return {R<T>::sub(R<T>::mul(a.y, b.z), R<T>::mul(a.z, b.y)),
          R<T>::sub(R<T>::mul(a.z, b.x), R<T>::mul(a.x, b.z)),
          R<T>::sub(R<T>::mul(a.x, b.y), R<T>::mul(a.y, b.x))};
}

template <typename T>
__device__ inline T safe_div(T num, T den) {
  return den > T(0) ? R<T>::div(num, den) : T(0);
}

template <typename T>
__device__ inline void edge_region(V3<T> p, V3<T> e0, V3<T> e1, V3<T> n, T& t, T& s) {
  V3<T> e = rsub(e1, e0);
  V3<T> out = rcross(e, n);
  V3<T> r = rsub(p, e0);
  t = safe_div(rdot(r, e), rdot(e, e));
  s = safe_div(rdot(r, out), rdot(out, out));
}

// dtype_PT: 0-2 PP (t0|t1|t2), 3-5 PE (t0t1|t1t2|t2t0), 6 PT
template <typename T>
__device__ int classify_pt(V3<T> p, V3<T> t0, V3<T> t1, V3<T> t2) {
  V3<T> n = rcross(rsub(t1, t0), rsub(t2, t0));
  T ta, sa, tb, sb, tc, sc;
  edge_region(p, t0, t1, n, ta, sa);
  edge_region(p, t1, t2, n, tb, sb);
  edge_region(p, t2, t0, n, tc, sc);
  const T zero(0), one(1);
  if (ta > zero && ta < one && sa >= zero) return 3;
  if (tb > zero && tb < one && sb >= zero) return 4;
  if (tc > zero && tc < one && sc >= zero) return 5;
  if (ta <= zero && tc >= one) return 0;
  if (tb <= zero && ta >= one) return 1;
  if (tc <= zero && tb >= one) return 2;
  return 6;
}

// dtype_EE: 0 PP a0b0, 1 PP a0b1, 2 PE a0-b, 3 PP a1b0, 4 PP a1b1, 5 PE a1-b,
// 6 PE b0-a, 7 PE b1-a, 8 EE
template <typename T>
__device__ int classify_ee(V3<T> a0, V3<T> a1, V3<T> b0, V3<T> b1) {
  V3<T> u = rsub(a1, a0), v = rsub(b1, b0), w = rsub(a0, b0);
  T a = rdot(u, u), b = rdot(u, v), c = rdot(v, v), d = rdot(u, w), e = rdot(v, w);
  T D = R<T>::sub(R<T>::mul(a, c), R<T>::mul(b, b));
  T sN = R<T>::sub(R<T>::mul(b, e), R<T>::mul(c, d));
  T tN_mid = R<T>::sub(R<T>::mul(a, e), R<T>::mul(b, d));
  V3<T> uxv = rcross(u, v);
  const T zero(0);
  bool para = rdot(uxv, w) == zero ||
              rdot(uxv, uxv) < R<T>::mul(R<T>::mul(a, R<T>::kParaEps), c);
  bool mid_deflect = tN_mid > zero && tN_mid < D && para;
  bool mid_low = mid_deflect && sN < R<T>::mul(D, T(0.5));
  int case_s = sN <= zero ? 0 : sN >= D ? 1 : mid_low ? 0 : mid_deflect ? 1 : 2;
  T tN = case_s == 0 ? e : case_s == 1 ? R<T>::add(e, b) : tN_mid;
  T tD = case_s == 2 ? D : c;
  if (tN <= zero) {
    T nd = -d;
    return nd <= zero ? 0 : nd >= a ? 3 : 6;
  }
  if (tN >= tD) {
    T nd = R<T>::add(-d, b);
    return nd <= zero ? 1 : nd >= a ? 4 : 7;
  }
  return case_s == 0 ? 2 : case_s == 1 ? 5 : 8;
}

// reduced types (ctype): 0 PP, 1 PE, 2 PT (plane of a triangle), 3 EE (lines)
struct Slots { int8_t s[4]; int8_t ctype; int8_t npts; };

__device__ inline Slots slots_of(bool ee, int code) {
  // contact/selfcollision.py PT_SLOTS / EE_SLOTS; unused entries repeat slot 0
  switch (ee ? 16 + code : code) {
    case 0: return {{0, 1, 0, 0}, 0, 2};
    case 1: return {{0, 2, 0, 0}, 0, 2};
    case 2: return {{0, 3, 0, 0}, 0, 2};
    case 3: return {{0, 1, 2, 0}, 1, 3};
    case 4: return {{0, 2, 3, 0}, 1, 3};
    case 5: return {{0, 3, 1, 0}, 1, 3};
    case 6: return {{0, 1, 2, 3}, 2, 4};
    case 16: return {{0, 2, 0, 0}, 0, 2};
    case 17: return {{0, 3, 0, 0}, 0, 2};
    case 18: return {{0, 2, 3, 0}, 1, 3};
    case 19: return {{1, 2, 0, 0}, 0, 2};
    case 20: return {{1, 3, 0, 0}, 0, 2};
    case 21: return {{1, 2, 3, 0}, 1, 3};
    case 22: return {{2, 0, 1, 0}, 1, 3};
    case 23: return {{3, 0, 1, 0}, 1, 3};
    default: return {{0, 1, 2, 3}, 3, 4};
  }
}

// stencil_dist2 of a reduced stencil, in the plain version's rounding; also
// the rounded quotient's parts the derivatives reuse: M (PE: |e|^2; plane:
// |n|^2) and, for the planes, q = w . n
template <typename T>
__device__ T dist2(int ctype, const V3<T> (&y)[4], T& qv, T& Mv) {
  qv = T(0);
  Mv = T(0);
  if (ctype == 0) {
    V3<T> r = rsub(y[0], y[1]);
    return rdot(r, r);
  }
  if (ctype == 1) {
    V3<T> e = rsub(y[2], y[1]);
    V3<T> c = rcross(e, rsub(y[0], y[1]));
    Mv = rdot(e, e);
    return safe_div(rdot(c, c), Mv);
  }
  V3<T> n, w;
  if (ctype == 2) {
    n = rcross(rsub(y[2], y[1]), rsub(y[3], y[1]));
    w = rsub(y[0], y[1]);
  } else {
    n = rcross(rsub(y[1], y[0]), rsub(y[3], y[2]));
    w = rsub(y[0], y[2]);
  }
  qv = rdot(w, n);
  Mv = rdot(n, n);
  return safe_div(R<T>::mul(qv, qv), Mv);
}

// --- derivatives (plain arithmetic) ------------------------------------------

template <typename T>
__device__ inline V3<T> sub(V3<T> a, V3<T> b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
template <typename T>
__device__ inline T dot(V3<T> a, V3<T> b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
template <typename T>
__device__ inline V3<T> cross(V3<T> a, V3<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
template <typename T>
__device__ inline T comp(V3<T> a, int i) { return i == 0 ? a.x : i == 1 ? a.y : a.z; }

// h[3bi + r][3bj + c] += s a_r b_c
template <typename T, int N>
__device__ inline void add_outer(T (&h)[N][N], int bi, int bj, V3<T> a, V3<T> b, T s) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) h[3 * bi + r][3 * bj + c] += s * comp(a, r) * comp(b, c);
}
// h[3bi + r][3bj + c] += s [v]x_rc, [v]x w = v x w
template <typename T, int N>
__device__ inline void add_skew(T (&h)[N][N], int bi, int bj, V3<T> v, T s) {
  const int o = 3 * bi, p = 3 * bj;
  h[o + 0][p + 1] -= s * v.z; h[o + 0][p + 2] += s * v.y;
  h[o + 1][p + 0] += s * v.z; h[o + 1][p + 2] -= s * v.x;
  h[o + 2][p + 0] -= s * v.y; h[o + 2][p + 1] += s * v.x;
}
template <typename T, int N>
__device__ inline void add_eye(T (&h)[N][N], int bi, int bj, T s) {
#pragma unroll
  for (int r = 0; r < 3; ++r) h[3 * bi + r][3 * bj + r] += s;
}
template <typename T>
__device__ inline void put(T* g, int b, V3<T> v, T s) {
  g[3 * b] += s * v.x; g[3 * b + 1] += s * v.y; g[3 * b + 2] += s * v.z;
}

// |a x b|^2 with its gradient and Hessian over (a, b), written at blocks
// (ba, bb) of g / h (h only when kHess)
template <typename T, bool kHess, int N>
__device__ T cross_sq(V3<T> a, V3<T> b, int ba, int bb, T* g, T (&h)[N][N]) {
  V3<T> n = cross(a, b);
  put(g, ba, cross(b, n), T(2));
  put(g, bb, cross(n, a), T(2));
  if (kHess) {
    const T ab = dot(a, b);
    add_eye(h, ba, ba, T(2) * dot(b, b));
    add_outer(h, ba, ba, b, b, T(-2));
    add_eye(h, bb, bb, T(2) * dot(a, a));
    add_outer(h, bb, bb, a, a, T(-2));
    add_outer(h, ba, bb, a, b, T(2));
    add_eye(h, ba, bb, T(-2) * ab);
    add_skew(h, ba, bb, n, T(-2));
    add_outer(h, bb, ba, b, a, T(2));
    add_eye(h, bb, ba, T(-2) * ab);
    add_skew(h, bb, ba, n, T(2));
  }
  return dot(n, n);
}

// z_k = y[zP(ct, k)] - y[zM(ct, k)], k < zN(ct): the difference vectors each
// reduced type's distance is written in
__device__ constexpr int zN(int ct) { return ct == 0 ? 1 : ct == 1 ? 2 : 3; }
__device__ constexpr int zP(int ct, int k) {
  return ct == 0 ? 0 : ct == 1 ? (k == 0 ? 2 : 0) : ct == 2 ? (k == 0 ? 2 : k == 1 ? 3 : 0)
                                                            : (k == 0 ? 1 : k == 1 ? 3 : 0);
}
__device__ constexpr int zM(int ct, int k) { return ct == 3 ? (k == 0 ? 0 : 2) : 1; }

// one thread's matrices: packed upper triangle of A and full V, `stride` apart
template <typename T>
struct Mats {
  T* a;
  T* v;
  int stride;
  __device__ T& A(int i, int j) const {
    if (i > j) { int t = i; i = j; j = t; }
    return a[(i * 12 - (i * (i - 1)) / 2 + (j - i)) * stride];
  }
  __device__ T& V(int i, int j) const { return v[(i * 12 + j) * stride]; }
};

// The gradient gd over the reduced points y[0..npts) of the reduced squared
// distance of type CT, given d, q and M as the plain version rounds them, and, when
// kHess, coef x its Hessian added to the upper triangle of m.A. Internally
// over the difference vectors z (9 coordinates at most): d = N / M.
template <typename T, bool kHess, int CT>
__device__ void dist_derivs(const V3<T> (&y)[4], T d, T qv, T Mv, T coef, T (&gd)[12],
                       const Mats<T>& m) {
  constexpr int nz = zN(CT);
  // one 9x9 array live: the Hessian of N (PE) or of M (plane), then of d in place
  T gz[9] = {}, hz[9][9] = {};
  if (CT == 0) {
    put(gz, 0, sub(y[0], y[1]), T(2));
    if (kHess) add_eye(hz, 0, 0, T(2));
  } else if (CT == 1) {
    // d = N / M, N = |e x r|^2, M = |e|^2; e = y2 - y1, r = y0 - y1
    const V3<T> e = sub(y[2], y[1]), r = sub(y[0], y[1]);
    T gN[9] = {}, gM[9] = {};
    cross_sq<T, kHess>(e, r, 0, 1, gN, hz);
    put(gM, 0, e, T(2));
    const T inv = Mv > T(0) ? T(1) / Mv : T(0);
    // grad d = (gN - d gM) / M; hess d = (hN - d hM - gM gd^T - gd gM^T) / M, hM = 2 I (e, e)
#pragma unroll
    for (int i = 0; i < 9; ++i) gz[i] = (gN[i] - d * gM[i]) * inv;
    if (kHess) {
#pragma unroll
      for (int i = 0; i < 9; ++i)
#pragma unroll
        for (int j = 0; j < 9; ++j) hz[i][j] = (hz[i][j] - gM[i] * gz[j] - gz[i] * gM[j]) * inv;
      add_eye(hz, 0, 0, T(-2) * d * inv);
    }
  } else {
    // d = N / M, N = q^2, q = w . (u x v), M = |u x v|^2; PT (p, t0, t1, t2): u = t1 - t0,
    // v = t2 - t0, w = p - t0; EE (a0, a1, b0, b1): u = a1 - a0, v = b1 - b0, w = a0 - b0
    const V3<T> u = sub(y[zP(CT, 0)], y[zM(CT, 0)]);
    const V3<T> v = sub(y[zP(CT, 1)], y[zM(CT, 1)]);
    const V3<T> w = sub(y[zP(CT, 2)], y[zM(CT, 2)]);
    T gM[9] = {}, gq[9] = {};
    cross_sq<T, kHess>(u, v, 0, 1, gM, hz);
    const V3<T> n = cross(u, v);
    const T q = qv;
    put(gq, 0, cross(v, w), T(1));
    put(gq, 1, cross(w, u), T(1));
    put(gq, 2, n, T(1));
    const T inv = Mv > T(0) ? T(1) / Mv : T(0);
    // grad N = 2 q grad q, hess N = 2 grad q grad q^T + 2 q hess q (hess q: the skew blocks)
#pragma unroll
    for (int i = 0; i < 9; ++i) gz[i] = (T(2) * q * gq[i] - d * gM[i]) * inv;
    if (kHess) {
#pragma unroll
      for (int i = 0; i < 9; ++i)
#pragma unroll
        for (int j = 0; j < 9; ++j)
          hz[i][j] = (T(2) * gq[i] * gq[j] - d * hz[i][j] - gM[i] * gz[j] - gz[i] * gM[j]) * inv;
      const T s = T(2) * q * inv;
      add_skew(hz, 0, 1, w, -s);
      add_skew(hz, 1, 0, w, s);
      add_skew(hz, 0, 2, v, s);
      add_skew(hz, 2, 0, v, -s);
      add_skew(hz, 1, 2, u, -s);
      add_skew(hz, 2, 1, u, s);
    }
  }
  // map z -> the reduced points: d/dy[P] += d/dz, d/dy[M] -= d/dz
#pragma unroll
  for (int i = 0; i < 12; ++i) gd[i] = T(0);
#pragma unroll
  for (int k = 0; k < nz; ++k) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      gd[3 * zP(CT, k) + a] += gz[3 * k + a];
      gd[3 * zM(CT, k) + a] -= gz[3 * k + a];
    }
  }
  if (kHess) {
#pragma unroll
    for (int k = 0; k < nz; ++k)
#pragma unroll
      for (int l = 0; l < nz; ++l)
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            const T h = coef * hz[3 * k + a][3 * l + b];
            const int pk = 3 * zP(CT, k) + a, mk = 3 * zM(CT, k) + a;
            const int pl = 3 * zP(CT, l) + b, ml = 3 * zM(CT, l) + b;
            if (pk <= pl) m.A(pk, pl) += h;
            if (pk <= ml) m.A(pk, ml) -= h;
            if (mk <= pl) m.A(mk, pl) -= h;
            if (mk <= ml) m.A(mk, ml) += h;
          }
  }
}

template <typename T, bool kHess>
__device__ void dist_derivs(int ctype, const V3<T> (&y)[4], T d, T qv, T Mv, T coef, T (&gd)[12],
                       const Mats<T>& m) {
  switch (ctype) {
    case 0: dist_derivs<T, kHess, 0>(y, d, qv, Mv, coef, gd, m); break;
    case 1: dist_derivs<T, kHess, 1>(y, d, qv, Mv, coef, gd, m); break;
    case 2: dist_derivs<T, kHess, 2>(y, d, qv, Mv, coef, gd, m); break;
    default: dist_derivs<T, kHess, 3>(y, d, qv, Mv, coef, gd, m); break;
  }
}

// --- PSD projection ------------------------------------------------------------

template <typename T>
__device__ inline T absT(T v) { return v < T(0) ? -v : v; }

// A <- V diag(w) V^T by cyclic Jacobi on the leading K x K block; returns the
// sweeps made
template <typename T>
__device__ int jacobi(const Mats<T>& m, int K) {
  T fro2(0);
  for (int i = 0; i < K; ++i) {
    for (int j = 0; j < K; ++j) m.V(i, j) = i == j ? T(1) : T(0);
    for (int j = i; j < K; ++j) {
      const T a = m.A(i, j);
      fro2 += (i == j ? T(1) : T(2)) * a * a;
    }
  }
  const T floor_abs = R<T>::kEps * R<T>::sqrt(fro2);
  int sweep = 0;
  for (; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
    for (int p = 0; p < K - 1; ++p) {
      for (int q = p + 1; q < K; ++q) {
        const T apq = m.A(p, q);
        const T app = m.A(p, p), aqq = m.A(q, q);
        const T big = absT(app) > absT(aqq) ? absT(app) : absT(aqq);
        const T thr = T(2) * R<T>::kEps * big > floor_abs ? T(2) * R<T>::kEps * big : floor_abs;
        if (!(absT(apq) > thr)) continue;
        rotated = true;
        const T theta = (aqq - app) / (T(2) * apq);
        const T at = absT(theta);
        // t = sign(theta) / (|theta| + sqrt(theta^2 + 1)), 1 / (2 theta) when theta^2 overflows
        T t = at > T(1e15) ? T(1) / (T(2) * at) : T(1) / (at + R<T>::sqrt(at * at + T(1)));
        if (theta < T(0)) t = -t;
        const T c = T(1) / R<T>::sqrt(t * t + T(1));
        const T s = t * c;
        const T tau = s / (T(1) + c);
        m.A(p, p) = app - t * apq;
        m.A(q, q) = aqq + t * apq;
        m.A(p, q) = T(0);
        for (int k = 0; k < K; ++k) {
          if (k != p && k != q) {
            const T akp = m.A(k, p), akq = m.A(k, q);
            m.A(k, p) = akp - s * (akq + tau * akp);
            m.A(k, q) = akq + s * (akp - tau * akq);
          }
          const T vkp = m.V(k, p), vkq = m.V(k, q);
          m.V(k, p) = vkp - s * (vkq + tau * vkp);
          m.V(k, q) = vkq + s * (vkp - tau * vkq);
        }
      }
    }
    if (!rotated) break;
  }
  return sweep;
}

// A <- V max(w, 0) V^T, w the diagonal Jacobi left in A
template <typename T>
__device__ void rebuild_psd(const Mats<T>& m, int K) {
  T w[12];
  for (int k = 0; k < 12; ++k) w[k] = k < K && m.A(k, k) > T(0) ? m.A(k, k) : T(0);
  for (int i = 0; i < K; ++i)
    for (int j = i; j < K; ++j) {
      T s(0);
      for (int k = 0; k < K; ++k) s += m.V(i, k) * w[k] * m.V(j, k);
      m.A(i, j) = s;
    }
}

// --- one pair --------------------------------------------------------------------

template <typename T>
__device__ inline V3<T> load(const T* x, int64_t v) {
  return {x[3 * v], x[3 * v + 1], x[3 * v + 2]};
}

template <typename T>
__device__ inline void barrier(T d, T dHat, T& b, T& b1, T& b2) {
  // ops/barrier.py (C2): t = d - dHat, l = log(d / dHat), the quotient by the
  // host scalar dHat taken as ATen takes it on the card: d * (1 / dHat)
  const T t = R<T>::sub(d, dHat);
  const T l = R<T>::log(R<T>::mul(d, R<T>::div(T(1), dHat)));
  b = R<T>::mul(R<T>::mul(-t, t), l);
  b1 = -T(2) * t * l - t * t / d;
  b2 = -T(2) * l - T(4) * t / d + t * t / (d * d);
}

// the mollifier's (u = x1 - x0, v = x3 - x2) block and sign of stencil slot s
__device__ inline int moll_block(int s) { return s >> 1; }
__device__ inline int moll_sign(int s) { return (s & 1) ? 1 : -1; }

// Evaluate pair i into out (energy: out[i]; gradient: out[12 i ..]; blocks:
// out[144 i ..]); `m` is this thread's scratch for the blocks; returns the
// Jacobi sweeps made (0 when none ran).
template <typename T, bool kEE, int kWhat>
__device__ int eval_pair(int64_t i, const T* __restrict__ x, const int64_t* __restrict__ vids,
                    const T* __restrict__ eps, T dHat, T kappa, bool project,
                    T* __restrict__ out, int* __restrict__ code_out, const Mats<T>& m) {
  V3<T> xs[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) xs[k] = load(x, vids[4 * i + k]);
  V3<T> c;
  c.x = R<T>::mul(R<T>::add(R<T>::add(R<T>::add(xs[0].x, xs[1].x), xs[2].x), xs[3].x), T(0.25));
  c.y = R<T>::mul(R<T>::add(R<T>::add(R<T>::add(xs[0].y, xs[1].y), xs[2].y), xs[3].y), T(0.25));
  c.z = R<T>::mul(R<T>::add(R<T>::add(R<T>::add(xs[0].z, xs[1].z), xs[2].z), xs[3].z), T(0.25));
  V3<T> yc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) yc[k] = rsub(xs[k], c);
  const int code = kEE ? classify_ee(yc[0], yc[1], yc[2], yc[3])
                       : classify_pt(yc[0], yc[1], yc[2], yc[3]);
  if (code_out != nullptr) code_out[i] = code;
  const Slots sl = slots_of(kEE, code);
  int perm[4] = {sl.s[0], sl.s[1], sl.s[2], sl.s[3]};
  V3<T> y[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int s = perm[k];
    y[k] = s == 0 ? yc[0] : s == 1 ? yc[1] : s == 2 ? yc[2] : yc[3];
  }
  T qv, Mv;
  const T d = dist2(sl.ctype, y, qv, Mv);
  const bool active = d > T(0) && d < dHat;
  // mollifier e(x) on the uncentered stencil: c = |(a1 - a0) x (b1 - b0)|^2
  T e(1), cm(0), ex(1);
  bool moll = false;
  if (kEE) {
    ex = eps[i];
    V3<T> cr = rcross(rsub(xs[1], xs[0]), rsub(xs[3], xs[2]));
    cm = rdot(cr, cr);
    moll = cm < ex;
    if (moll) {
      const T r = R<T>::div(cm, ex);
      e = R<T>::mul(R<T>::sub(T(2), r), r);
    }
  }
  T b(0), b1(0), b2(0);
  if (active) barrier(d, dHat, b, b1, b2);
  if (kWhat == kEnergy) {
    out[i] = kEE ? R<T>::mul(e, b) : b;
    return 0;
  }
  constexpr int kOut = kWhat == kGrad ? 12 : 144;
  T* o = out + kOut * i;
  if (!active) {
    for (int k = 0; k < kOut; ++k) o[k] = T(0);
    return 0;
  }
  // local order: the reduced points, then (mollified EE: e reads all four)
  // the stencil's others
  int nloc = sl.npts;
  if (moll) {
    int used = 0;
    for (int k = 0; k < sl.npts; ++k) used |= 1 << perm[k];
    for (int s = 0; s < 4; ++s)
      if (!(used & (1 << s))) perm[nloc++] = s;
  }
  int used = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < nloc) used |= 1 << perm[k];
  const int K = 3 * nloc;
  constexpr bool kHess = kWhat == kBlocks;
  const T eb1 = e * b1;
  if (kHess) {
    for (int r = 0; r < K; ++r)
      for (int cc = r; cc < K; ++cc) m.A(r, cc) = T(0);
  }
  T gd[12];
  dist_derivs<T, kHess>(sl.ctype, y, d, qv, Mv, eb1, gd, m);
  // the mollifier's derivatives over the stencil, in local order
  T gc[12] = {}, ec(0), ecc(0);
  T hc[6][6] = {};
  if (moll) {
    T g6[6] = {};
    cross_sq<T, kHess>(sub(xs[1], xs[0]), sub(xs[3], xs[2]), 0, 1, g6, hc);
    ec = (T(2) - T(2) * cm / ex) / ex;
    ecc = -T(2) / (ex * ex);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = perm[k];
      const T sg = T(moll_sign(s));
#pragma unroll
      for (int a = 0; a < 3; ++a) gc[3 * k + a] = sg * (moll_block(s) ? g6[3 + a] : g6[a]);
    }
  }
  if (kWhat == kGrad) {
    // e b' grad d + b e' grad c
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= nloc) break;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        o[3 * perm[k] + a] = R<T>::mul(kappa, eb1 * gd[3 * k + a] + b * ec * gc[3 * k + a]);
    }
    for (int s = 0; s < 4; ++s)
      if (!(used & (1 << s)))
        for (int a = 0; a < 3; ++a) o[3 * s + a] = T(0);
    return 0;
  }
  // blocks: e (b'' gd gd^T + b' hess d) + b' (ge gd^T + gd ge^T) + b hess e, with
  // ge = e' gc and hess e = e'' gc gc^T + e' hess c (e b' hess d is in m.A)
  const T eb2 = e * b2, bec = b * ec, becc = b * ecc, b1ec = b1 * ec;
#pragma unroll
  for (int r = 0; r < 12; ++r) {
    if (r >= K) break;
#pragma unroll
    for (int cc = r; cc < 12; ++cc) {
      if (cc >= K) break;
      T h = eb2 * gd[r] * gd[cc];
      if (moll) {
        const int sr = perm[r / 3], sc = perm[cc / 3];
        const int br = moll_block(sr), bc = moll_block(sc);
        const T hrc = br ? (bc ? hc[3 + r % 3][3 + cc % 3] : hc[3 + r % 3][cc % 3])
                         : (bc ? hc[r % 3][3 + cc % 3] : hc[r % 3][cc % 3]);
        h += b1ec * (gc[r] * gd[cc] + gd[r] * gc[cc]) + becc * gc[r] * gc[cc] +
             bec * T(moll_sign(sr) * moll_sign(sc)) * hrc;
      }
      m.A(r, cc) += h;
    }
  }
  int sweeps = 0;
  if (project) {
    sweeps = jacobi(m, K);
    rebuild_psd(m, K);
  }
  if (nloc < 4) {
    for (int r = 0; r < 12; ++r)
      for (int cc = 0; cc < 12; ++cc)
        if (!((used >> (r / 3)) & (used >> (cc / 3)) & 1)) o[12 * r + cc] = T(0);
  }
#pragma unroll
  for (int r = 0; r < 12; ++r) {
    if (r >= K) break;
    const int gr = 3 * perm[r / 3] + r % 3;
#pragma unroll
    for (int cc = r; cc < 12; ++cc) {
      if (cc >= K) break;
      const int gcl = 3 * perm[cc / 3] + cc % 3;
      const T h = R<T>::mul(kappa, m.A(r, cc));
      o[12 * gr + gcl] = h;
      o[12 * gcl + gr] = h;
    }
  }
  return sweeps;
}

}  // namespace pair_terms

namespace {

using namespace pair_terms;

template <typename T> struct Launch;
template <> struct Launch<float> { static constexpr int kBlockThreads = 64; };
template <> struct Launch<double> { static constexpr int kBlockThreads = 32; };
constexpr int kThreads = 128;  // energy and gradient

template <typename T, bool kEE, int kWhat>
__global__ void __launch_bounds__(kWhat == kBlocks ? Launch<T>::kBlockThreads : kThreads)
pair_kernel(const T* __restrict__ x, const int64_t* __restrict__ vids,
            const T* __restrict__ eps, int n, T dHat, const T* __restrict__ kappa_ptr,
            T kappa_val, int project, T* __restrict__ out, int* __restrict__ code,
            int* __restrict__ sweeps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int threads = kWhat == kBlocks ? Launch<T>::kBlockThreads : kThreads;
  const int64_t i = int64_t(blockIdx.x) * threads + threadIdx.x;
  if (i >= n) return;
  const T kappa = kappa_ptr != nullptr ? *kappa_ptr : kappa_val;
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Mats<T> m{sm + threadIdx.x, sm + kPacked * threads + threadIdx.x, threads};
  const int made = eval_pair<T, kEE, kWhat>(i, x, vids, eps, dHat, kappa, project != 0, out,
                                            code, m);
  if (sweeps != nullptr) sweeps[i] = made;
}

template <typename T, bool kEE, int kWhat>
int launch(const void* x, const void* vids, const void* eps, int n, double dHat,
           const void* kappa_ptr, double kappa, int project, void* out, void* code,
           void* sweeps, void* stream) {
  if (n <= 0) return 0;
  const int threads = kWhat == kBlocks ? Launch<T>::kBlockThreads : kThreads;
  const size_t smem = kWhat == kBlocks ? sizeof(T) * kSmemPerThread * threads : 0;
  auto kern = pair_kernel<T, kEE, kWhat>;
  if (smem > 48 * 1024) {
    static bool opted = false;  // once per instantiation
    if (!opted) {
      cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      opted = true;
    }
  }
  kern<<<(n + threads - 1) / threads, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int64_t*>(vids), static_cast<const T*>(eps),
      n, T(dHat), static_cast<const T*>(kappa_ptr), T(kappa), project, static_cast<T*>(out),
      static_cast<int*>(code), static_cast<int*>(sweeps));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PAIR_ENTRY(name, T, EE, WHAT)                                                       \
  extern "C" int name(const void* x, const void* vids, const void* eps, int n, double dHat, \
                      const void* kappa_ptr, double kappa, int project, void* out,         \
                      void* code, void* sweeps, void* stream) {                            \
    return launch<T, EE, WHAT>(x, vids, eps, n, dHat, kappa_ptr, kappa, project, out, code, \
                               sweeps, stream);                                            \
  }

PAIR_ENTRY(ipc_pairs_pt_energy_f32, float, false, kEnergy)
PAIR_ENTRY(ipc_pairs_pt_energy_f64, double, false, kEnergy)
PAIR_ENTRY(ipc_pairs_ee_energy_f32, float, true, kEnergy)
PAIR_ENTRY(ipc_pairs_ee_energy_f64, double, true, kEnergy)
PAIR_ENTRY(ipc_pairs_pt_grad_f32, float, false, kGrad)
PAIR_ENTRY(ipc_pairs_pt_grad_f64, double, false, kGrad)
PAIR_ENTRY(ipc_pairs_ee_grad_f32, float, true, kGrad)
PAIR_ENTRY(ipc_pairs_ee_grad_f64, double, true, kGrad)
PAIR_ENTRY(ipc_pairs_pt_blocks_f32, float, false, kBlocks)
PAIR_ENTRY(ipc_pairs_pt_blocks_f64, double, false, kBlocks)
PAIR_ENTRY(ipc_pairs_ee_blocks_f32, float, true, kBlocks)
PAIR_ENTRY(ipc_pairs_ee_blocks_f64, double, true, kBlocks)

