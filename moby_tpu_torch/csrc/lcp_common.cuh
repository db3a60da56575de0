// lcp_common.cuh — device functions shared by the LCP kernels of this
// directory (ppm_lcp.cu, bpp_lcp.cu). Both run one thread block per problem
// with the whole problem in shared memory, in one layout:
//
//   Mp  (np x np)      the masked, padded matrix (identity on inactive slots)
//   A   (np x (np+1))  the working system; the right-hand side is column np
//   qv, zv, wv (np)    q with inert slots at +1; the iterate; a scratch vector
//   valid, nb, bas     int flags: active slots, nonbasic set, basic set
//
// np is n rounded up to a whole warp. The odd row stride of A keeps row and
// column walks free of bank conflicts.
//
// Reductions propagate NaN as jnp.min does (CUDA's fmin drops it): a
// first-minimum over a set that holds a NaN returns NaN and selects no index.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace lcp {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T> struct Lim;
template <> struct Lim<float> {
  static __device__ __forceinline__ float eps() { return 1.1920928955078125e-07f; }
  static __device__ __forceinline__ float sqrt_eps() { return 3.4526698300124393e-04f; }
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
  static __device__ __forceinline__ float nan() { return CUDART_NAN_F; }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double eps() { return 2.220446049250313e-16; }
  static __device__ __forceinline__ double sqrt_eps() { return 1.4901161193847656e-08; }
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
  static __device__ __forceinline__ double nan() { return CUDART_NAN; }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// First minimum of v[i] over the slots with sel[i] != 0, i < np: the least
// value and, among equal minima, the LOWEST index (np when nothing is
// selected). Called by all 32 lanes of one warp; every lane gets the result.
// NaN-propagating: if a selected value is NaN the minimum is NaN and no index
// is selected.
template <typename T>
__device__ __forceinline__ void first_min_warp(const T* v, const int* sel,
                                               int np, T& mn, int& idx) {
  const int lane = threadIdx.x & 31;
  T best = Lim<T>::inf();
  int bi = np;
  bool has_nan = false;
  for (int i = lane; i < np; i += 32) {
    if (sel[i]) {
      const T x = v[i];
      if (x != x) has_nan = true;
      else if (x < best || (x == best && i < bi)) { best = x; bi = i; }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ob < best || (ob == best && oi < bi)) { best = ob; bi = oi; }
  }
  if (__any_sync(0xffffffffu, has_nan)) { best = Lim<T>::nan(); bi = np; }
  mn = best;
  idx = bi;
}

template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int np) {
  // Mp (np x np), A (np x (np+1)), qv, zv, wv (np each); valid, nb, bas (int)
  return (size_t)(2 * np * np + 4 * np) * sizeof(T) + (size_t)3 * np * sizeof(int);
}

// The block's shared-memory arrays, carved out of one dynamic allocation.
template <typename T>
struct Smem {
  T* Mp; T* A; T* qv; T* zv; T* wv;
  int* valid; int* nb; int* bas;
  int np, ld;
  __device__ Smem(unsigned char* raw, int np_) : np(np_), ld(np_ + 1) {
    Mp = reinterpret_cast<T*>(raw);
    A = Mp + np * np;
    qv = A + np * ld;
    zv = qv + np;
    wv = zv + np;
    valid = reinterpret_cast<int*>(wv + np);
    nb = valid + np;
    bas = nb + np;
  }
};

// Active slots: valid[i] and qv[i] (padded and masked-out slots are inert,
// M_ii = 1 and q_i = 1). Returns the number of active slots; ends in a
// barrier.
template <typename T>
__device__ int load_active(const Smem<T>& s, const T* q,
                           const unsigned char* mask, int n) {
  const int tid = threadIdx.x;
  for (int i = tid; i < s.np; i += kThreads) {
    const int v = (i < n) && (mask[i] != 0);
    s.valid[i] = v;
    s.qv[i] = v ? q[i] : T(1);
  }
  __syncthreads();
  int m_active = 0;
  for (int i = 0; i < s.np; ++i) m_active += s.valid[i];
  return m_active;
}

// Mp = masked, padded M. Returns ‖M‖∞ over the active submatrix (the largest
// row sum of |M|, NaN-propagating); uses wv as scratch and ends in a barrier
// after which wv is free again.
template <typename T>
__device__ T load_matrix(const Smem<T>& s, const T* M, int n) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int np = s.np;
  for (int i = wid; i < np; i += kWarps) {
    T rs = T(0);
    for (int j = lane; j < np; j += 32) {
      T a;
      if (s.valid[i] && s.valid[j]) a = M[(size_t)i * n + j];
      else a = (i == j && !s.valid[j]) ? T(1) : T(0);
      s.Mp[i * np + j] = a;
      if (s.valid[i] && s.valid[j]) rs += fabs(a);
    }
    rs = warp_sum(rs);
    if (lane == 0) s.wv[i] = s.valid[i] ? rs : T(0);
  }
  __syncthreads();
  T norminf = T(0);
  for (int i = 0; i < np; ++i) {
    const T r = s.wv[i];
    if (r != r || r > norminf) norminf = r;   // NaN-propagating max
  }
  __syncthreads();   // wv is reused by the callers
  return norminf;
}

// Solve the nb-masked system M[nb,nb] z_nb = -q_nb by Gauss–Jordan and leave
// z in zv (0 off the nonbasic set) and the basic set valid & !nb in bas.
// A step whose |pivot| <= 1e-30 is skipped and leaves the system as it was.
// Basic rows and pivots are identity rows: their steps change nothing that z
// depends on, so only nonbasic pivots and rows are visited, and only the
// columns right of the pivot (the others are never read again). Ends in a
// barrier.
template <typename T>
__device__ void solve_nonbasic(const Smem<T>& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int np = s.np, ld = s.ld;
  T* A = s.A;
  const int* nb = s.nb;
  // working system: M on nonbasic x nonbasic, identity elsewhere; the
  // right-hand side -q on the nonbasic rows is column np
  for (int i = wid; i < np; i += kWarps) {
    const int nbi = nb[i];
    for (int j = lane; j < np; j += 32) {
      const int nbj = nb[j];
      A[i * ld + j] = (nbi && nbj) ? s.Mp[i * np + j]
                                    : ((i == j && !nbj) ? T(1) : T(0));
    }
    if (lane == 0) A[i * ld + np] = nbi ? -s.qv[i] : T(0);
  }
  __syncthreads();

  for (int k = 0; k < np; ++k) {
    if (!nb[k]) continue;
    const T pivot = A[k * ld + k];
    if (!(fabs(pivot) > T(1e-30))) continue;
    const T inv = T(1) / pivot;
    for (int j = k + 1 + tid; j <= np; j += kThreads) A[k * ld + j] *= inv;
    __syncthreads();
    for (int i = wid; i < np; i += kWarps) {
      if (i == k || !nb[i]) continue;
      const T f = A[i * ld + k];
      for (int j = k + 1 + lane; j <= np; j += 32)
        A[i * ld + j] -= f * A[k * ld + j];
    }
    __syncthreads();
  }

  for (int i = tid; i < np; i += kThreads) {
    s.zv[i] = nb[i] ? A[i * ld + np] : T(0);
    s.bas[i] = s.valid[i] && !nb[i];
  }
  __syncthreads();
}

// wv[i] = (Mp zv)[i] + qv[i] on the rows with sel[i] != 0, 0 elsewhere. Ends
// in a barrier.
template <typename T>
__device__ void residual_rows(const Smem<T>& s, const int* sel) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int np = s.np;
  for (int i = wid; i < np; i += kWarps) {
    T acc = T(0);
    if (sel[i]) {
      for (int j = lane; j < np; j += 32) acc += s.Mp[i * np + j] * s.zv[j];
      acc = warp_sum(acc);
    }
    if (lane == 0) s.wv[i] = sel[i] ? acc + s.qv[i] : T(0);
  }
  __syncthreads();
}

// First-minimum principal pivoting (Moby src/LCP.cpp:41) from the nonbasic
// set in nb: each pivot solves the nonbasic system, adds the first index
// with w < -ztol and drops the first with z < -ztol (possibly both), until
// neither exists or max_piv pivots are spent. Returns 1 when solved; the
// last iterate is in zv. `s_done` is one int of static shared memory.
template <typename T>
__device__ int ppm_pivot_loop(const Smem<T>& s, T ztol, int max_piv, int* s_done) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int np = s.np;
  int done = 0;
  for (int piv = 0; piv < max_piv && !done; ++piv) {
    solve_nonbasic(s);
    residual_rows(s, s.bas);
    if (wid == 0) {
      T minw, minz; int wi, zi;
      first_min_warp(s.wv, s.bas, np, minw, wi);
      first_min_warp(s.zv, s.nb, np, minz, zi);
      if (lane == 0) {
        const bool w_ok = minw > -ztol;
        const bool z_neg = minz < -ztol;
        const bool solved = w_ok && !z_neg;
        if (!solved) {
          if (!w_ok && wi < np) s.nb[wi] = 1;
          if (z_neg && zi < np) s.nb[zi] = 0;
        }
        *s_done = solved ? 1 : 0;
      }
    }
    __syncthreads();
    done = *s_done;
  }
  return done;
}

}  // namespace lcp
