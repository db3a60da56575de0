// lcp_common.cuh — device code shared by the LCP kernels of this directory
// (ppm_lcp.cu, bpp_lcp.cu). Each kernel has two paths, chosen by the wrapper
// from n and the dtype alone (hopper_lcp.launch_plan):
//
// GROUP PATH, n <= 32. A problem is a group of G lanes of one warp, G the
// smallest of 8, 16, 32 that is >= n; a warp holds 32/G problems and a block
// two warps (kGroupThreads), so B=1536 problems at G=8 are 192 blocks over
// the 132 SMs. Lane i keeps row i of the masked, padded M and of the working
// system [M_FF | -q_F] in registers. Elimination step k broadcasts row k with
// __shfl_sync(width G); the sets (active slots, nonbasic set F, violators)
// are G-bit masks in one register, built with __ballot_sync and read with
// __popc and the lowest set bit; first minima are (value, index) __shfl_xor reductions
// within the group. There is no shared memory and no __syncthreads. Groups
// of one warp finish after different numbers of iterations, so every loop
// that shuffles runs the warp's largest trip count with the full mask and a
// per-group predicate; a warp whose groups are all done leaves together.
//
// BLOCK PATH, n > 32. One block of kThreads per problem, the whole problem in
// shared memory, in one layout:
//
//   Mp  (np x np)      the masked, padded matrix (identity on inactive slots)
//   A   (np x (np+1))  the working system or the tableau; its last column
//                      is the right-hand side
//   qv, zv, wv (np)    q with inert slots at +1; the iterate; a scratch vector
//   valid, nb, bas     int flags: active slots, nonbasic set, basic set
//
// np is n rounded up to a whole warp. The odd row stride of A keeps row and
// column walks free of bank conflicts. The Gauss–Jordan leaves pivot rows
// unscaled and divides once at the end: one barrier per step. The PPM pivot
// loop keeps in A the principal pivot transform (Tucker's tableau) of
// [Mp | qv] on the current nonbasic set F,
//
//   [w_B; z_F] = T [z_B; w_F] + t,   t = (w_B, z_F) at z_B = 0, w_F = 0,
//
// so that an index entering or leaving F is one principal pivot, a rank-one
// update of the tableau (its first n rows and columns and its last column:
// nothing reads the padding), instead of a new elimination of the system.
// It re-solves from Mp every kRefresh updates, before it returns done, and
// whenever a pivot has |T_rr| <= 1e-30 (there the elimination skips a step).
//
// Reductions propagate NaN as jnp.min does (CUDA's fmin drops it): a
// first-minimum over a set that holds a NaN returns NaN and selects no index.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace lcp {

constexpr int kThreads = 256;        // block path: threads of a block
constexpr int kWarps = kThreads / 32;
constexpr int kGroupThreads = 64;    // group path: two warps a block
constexpr int kRefresh = 16;         // tableau updates between re-solves
constexpr unsigned kFull = 0xffffffffu;

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

// ============================================================ group path

// One problem's lanes: lane i of the group holds row i.
template <int G>
struct Group {
  int i;          // row of this lane
  int base;       // first lane of the group in the warp
  unsigned lanes; // the group's lanes, as bits of a warp ballot
  __device__ Group() {
    const int lane = threadIdx.x & 31;
    i = lane % G;
    base = lane - i;
    lanes = (G == 32) ? kFull : (((1u << G) - 1u) << base);
  }
  // the group's G-bit set {j : p holds in lane j}; all 32 lanes call it
  __device__ __forceinline__ unsigned bits(bool p) const {
    return (__ballot_sync(kFull, p) & lanes) >> base;
  }
  template <typename T>
  __device__ __forceinline__ T from(T v, int j) const {
    return __shfl_sync(kFull, v, j, G);
  }
};

// Largest of v over the group, NaN-propagating.
template <typename T, int G>
__device__ __forceinline__ T group_max(const Group<G>& g, T v) {
  const bool nan = v != v;
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const T ov = __shfl_xor_sync(kFull, v, o, G);
    if (ov > v) v = ov;
  }
  return g.bits(nan) ? Lim<T>::nan() : v;
}

// First minimum of v over the lanes with sel: the least value and, among
// equal minima, the lowest row (G when nothing is selected); NaN in a
// selected lane gives NaN and no row. Every lane of the group gets it.
template <typename T, int G>
__device__ __forceinline__ void group_first_min(const Group<G>& g, T v, bool sel,
                                                T& mn, int& idx) {
  T best = Lim<T>::inf();
  int bi = G;
  const bool nan = sel && (v != v);
  if (sel && !nan) { best = v; bi = g.i; }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const T ob = __shfl_xor_sync(kFull, best, o, G);
    const int oi = __shfl_xor_sync(kFull, bi, o, G);
    if (ob < best || (ob == best && oi < bi)) { best = ob; bi = oi; }
  }
  if (g.bits(nan)) { best = Lim<T>::nan(); bi = G; }
  mn = best;
  idx = bi;
}

// This lane's row of the problem: Mrow = row i of the masked, padded M (the
// identity row off the active set V), returns qv_i (q_i, 1 when inactive).
template <typename T, int G>
__device__ __forceinline__ T group_load(const Group<G>& g, const T* M,
                                        const T* q, int n, bool valid_i,
                                        unsigned V, T (&Mrow)[G]) {
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const bool vj = (V >> j) & 1u;
    Mrow[j] = (valid_i && vj) ? M[(size_t)g.i * n + j]
                              : ((j == g.i && !vj) ? T(1) : T(0));
  }
  return valid_i ? q[g.i] : T(1);
}

// ‖M‖∞ over the active block: the largest row sum of |M|, NaN-propagating.
template <typename T, int G>
__device__ __forceinline__ T group_norminf(const Group<G>& g, const T (&Mrow)[G],
                                          bool valid_i, unsigned V) {
  T rs = T(0);
#pragma unroll
  for (int j = 0; j < G; ++j)
    if ((V >> j) & 1u) rs += fabs(Mrow[j]);
  return group_max<T, G>(g, valid_i ? rs : T(0));
}

// Solve M[F,F] z_F = -q_F by Gauss–Jordan in registers and return this
// lane's z_i (0 off F). A step whose |pivot| <= 1e-30 is skipped and leaves
// the system as it was. F is the same in every lane of a group; steps no
// group of the warp takes are skipped by the whole warp.
template <typename T, int G>
__device__ __forceinline__ T group_solve(const Group<G>& g, const T (&Mrow)[G],
                                         T qi, unsigned F) {
  const bool in_i = (F >> g.i) & 1u;
  T A[G + 1];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const bool in_j = (F >> j) & 1u;
    A[j] = (in_i && in_j) ? Mrow[j] : ((j == g.i && !in_j) ? T(1) : T(0));
  }
  A[G] = in_i ? -qi : T(0);
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const bool in_k = (F >> k) & 1u;
    if (!__any_sync(kFull, in_k)) continue;
    const T pivot = g.from(A[k], k);
    const bool step = in_k && fabs(pivot) > T(1e-30);
    const T inv = T(1) / pivot;
    if (step && g.i == k) {
#pragma unroll
      for (int j = k + 1; j <= G; ++j) A[j] *= inv;
    }
    const T f = A[k];
    const bool upd = step && in_i && g.i != k;
#pragma unroll
    for (int j = k + 1; j <= G; ++j) {
      const T akj = g.from(A[j], k);
      if (upd) A[j] = fma(-f, akj, A[j]);
    }
  }
  return in_i ? A[G] : T(0);
}

// (Mp z)_i + qv_i for this lane's row; z_j comes from lane j.
template <typename T, int G>
__device__ __forceinline__ T group_residual(const Group<G>& g, const T (&Mrow)[G],
                                            T qi, T zi) {
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < G; ++j) acc = fma(Mrow[j], g.from(zi, j), acc);
  return acc + qi;
}

// First-minimum principal pivoting on the group: from the nonbasic set F,
// each pivot solves the system, adds the first index with w < -ztol and drops
// the first with z < -ztol, until neither exists or max_piv pivots are
// spent. Groups with `done` set take no part but keep the warp's shuffles
// company. Leaves z_i (this lane's last iterate) and sets done where solved.
template <typename T, int G>
__device__ __forceinline__ void group_ppm(const Group<G>& g, const T (&Mrow)[G],
                                         T qi, bool valid_i, unsigned F,
                                         T ztol, int max_piv, bool& done, T& zi) {
  for (int piv = 0; piv < max_piv; ++piv) {
    if (__all_sync(kFull, done)) break;
    const bool in_i = (F >> g.i) & 1u;
    const T zs = group_solve<T, G>(g, Mrow, qi, F);
    const T w = group_residual<T, G>(g, Mrow, qi, zs);
    T minw, minz;
    int wi, zidx;
    group_first_min<T, G>(g, w, valid_i && !in_i, minw, wi);
    group_first_min<T, G>(g, zs, in_i, minz, zidx);
    if (!done) {
      zi = zs;
      const bool w_ok = minw > -ztol;
      const bool z_neg = minz < -ztol;
      if (w_ok && !z_neg) {
        done = true;
      } else {
        if (!w_ok && wi < G) F |= 1u << wi;
        if (z_neg && zidx < G) F &= ~(1u << zidx);
      }
    }
  }
}

// ============================================================ block path

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// First minimum of v[i·stride] over the slots with sel[i] != 0, i < np: the
// least value and, among equal minima, the LOWEST index (np when nothing is
// selected). Called by all 32 lanes of one warp; every lane gets the result.
// NaN-propagating: if a selected value is NaN the minimum is NaN and no index
// is selected.
template <typename T>
__device__ __forceinline__ void first_min_warp(const T* v, int stride,
                                               const int* sel, int np, T& mn,
                                               int& idx) {
  const int lane = threadIdx.x & 31;
  T best = Lim<T>::inf();
  int bi = np;
  bool has_nan = false;
  for (int i = lane; i < np; i += 32) {
    if (sel[i]) {
      const T x = v[i * stride];
      if (x != x) has_nan = true;
      else if (x < best || (x == best && i < bi)) { best = x; bi = i; }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T ob = __shfl_xor_sync(kFull, best, o);
    const int oi = __shfl_xor_sync(kFull, bi, o);
    if (ob < best || (ob == best && oi < bi)) { best = ob; bi = oi; }
  }
  if (__any_sync(kFull, has_nan)) { best = Lim<T>::nan(); bi = np; }
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
  int n, np, ld;
  __device__ Smem(unsigned char* raw, int n_, int np_) : n(n_), np(np_), ld(np_ + 1) {
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

// The pivot loop's scalars, in static shared memory.
template <typename T>
struct PivotShared {
  T t_r;          // last-column entry of the copied pivot row
  int solved;     // the decision of the current iteration
  int enter, leave;
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
// columns right of the pivot (the others are never read again). Pivot rows
// stay unscaled: step k reads row k and column k, which it does not write,
// so one barrier a step; each z_i is divided by its pivot at the end (a
// pivot is never written after its own step). Ends in a barrier.
template <typename T>
__device__ void solve_nonbasic(const Smem<T>& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int np = s.np, ld = s.ld;
  T* A = s.A;
  const int* nb = s.nb;
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
    for (int i = wid; i < np; i += kWarps) {
      if (i == k || !nb[i]) continue;
      const T f = A[i * ld + k] * inv;
      for (int j = k + 1 + lane; j <= np; j += 32)
        A[i * ld + j] = fma(-f, A[k * ld + j], A[i * ld + j]);
    }
    __syncthreads();
  }

  for (int i = tid; i < np; i += kThreads) {
    const T d = A[i * ld + i];
    const T b = A[i * ld + np];
    s.zv[i] = nb[i] ? ((fabs(d) > T(1e-30)) ? b / d : b) : T(0);
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

// Copy row r of the tableau into zv (and its last entry into sh->t_r) and
// column r into wv, by the threads first..first+count-1 of the block. Only
// the first n rows and columns of the tableau and its last column are kept:
// every active slot is below n, so nothing reads the others.
template <typename T>
__device__ __forceinline__ void copy_pivot(const Smem<T>& s, int r,
                                           PivotShared<T>* sh, int first,
                                           int count) {
  const int t = threadIdx.x - first;
  const int np = s.np, ld = s.ld;
  for (int j = t; j < s.n; j += count) {
    s.zv[j] = s.A[r * ld + j];
    s.wv[j] = s.A[j * ld + r];
  }
  if (t == 0) sh->t_r = s.A[r * ld + np];
}

// One principal pivot of the tableau on r, from the copies of copy_pivot
// (made before the last barrier): T_rr -> 1/T_rr, row r -> -T_rj/T_rr,
// column r -> T_ir/T_rr, the rest T_ij - T_ir·(T_rj/T_rr). The caller has
// checked |T_rr| > 1e-30. Ends in a barrier.
template <typename T>
__device__ void pivot_update(const Smem<T>& s, int r, const PivotShared<T>* sh) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int n = s.n, np = s.np, ld = s.ld;
  const T inv = T(1) / s.wv[r];
  for (int i = wid; i < n; i += kWarps) {
    const T ci = s.wv[i];
    for (int jj = lane; jj <= n; jj += 32) {
      const int j = jj < n ? jj : np;      // the last column
      const T rj = -((j < np ? s.zv[j] : sh->t_r) * inv);
      T& a = s.A[i * ld + j];
      if (i == r) a = (j == r) ? inv : rj;
      else if (j == r) a = ci * inv;
      else a = fma(ci, rj, a);
    }
  }
  __syncthreads();
}

// The tableau of [Mp | qv] on the nonbasic set nb: one principal pivot per
// nonbasic index, in ascending order (copy, barrier, update, barrier).
// Returns 0, with the tableau unfinished, at a pivot with |T_kk| <= 1e-30.
template <typename T>
__device__ int build_tableau(const Smem<T>& s, PivotShared<T>* sh) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int n = s.n, np = s.np, ld = s.ld;
  for (int i = wid; i < n; i += kWarps) {
    for (int j = lane; j < n; j += 32) s.A[i * ld + j] = s.Mp[i * np + j];
    if (lane == 0) s.A[i * ld + np] = s.qv[i];
  }
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    if (!s.nb[k]) continue;
    copy_pivot(s, k, sh, 0, kThreads);
    __syncthreads();
    if (!(fabs(s.wv[k]) > T(1e-30))) return 0;
    pivot_update(s, k, sh);
  }
  return 1;
}

// The pivot decision of one iteration by warp 0, from z over nb and w over
// bas read at (zsrc, zstride) and (wsrc, wstride): sh->solved, sh->enter and
// sh->leave (np for none). Does not end in a barrier.
template <typename T>
__device__ __forceinline__ void ppm_decide(const Smem<T>& s, const T* zsrc,
                                           const T* wsrc, int stride, T ztol,
                                           PivotShared<T>* sh) {
  const int np = s.np;
  T minw, minz;
  int wi, zi;
  first_min_warp(wsrc, stride, s.bas, np, minw, wi);
  first_min_warp(zsrc, stride, s.nb, np, minz, zi);
  if ((threadIdx.x & 31) == 0) {
    const bool w_ok = minw > -ztol;
    const bool z_neg = minz < -ztol;
    sh->solved = w_ok && !z_neg;
    sh->enter = (!w_ok && wi < np) ? wi : np;
    sh->leave = (z_neg && zi < np) ? zi : np;
  }
}

// First-minimum principal pivoting (Moby src/LCP.cpp:41) from the nonbasic
// set in nb: each pivot adds the first index with w < -ztol and drops the
// first with z < -ztol (possibly both), until neither exists or max_piv
// pivots are spent. z_F and w_B are read from the tableau's last column;
// each entering or leaving index is one principal pivot of the tableau. The
// tableau is rebuilt from Mp when it has taken kRefresh updates; a "solved"
// read from an updated tableau is checked again on a fresh solve
// (solve_nonbasic), and pivoting goes on from that solve if it disagrees; a
// build that meets a pivot |T_kk| <= 1e-30 is replaced by solve_nonbasic,
// which skips that step, and a tiny update pivot invalidates the tableau.
// Returns 1 when solved, with z in zv.
template <typename T>
__device__ int ppm_pivot_loop(const Smem<T>& s, T ztol, int max_piv,
                              PivotShared<T>* sh) {
  const int tid = threadIdx.x;
  const int wid = tid >> 5;
  const int np = s.np, ld = s.ld;
  for (int i = tid; i < np; i += kThreads) s.bas[i] = s.valid[i] && !s.nb[i];
  __syncthreads();
  const T* t = s.A + np;      // the tableau's last column, stride ld
  int tab_ok = 0, since = 0;
  for (int piv = 0; piv < max_piv; ++piv) {
    bool fresh = false;
    if (!tab_ok || since >= kRefresh) {
      tab_ok = build_tableau(s, sh);
      since = 0;
      fresh = true;
      if (!tab_ok) {
        solve_nonbasic(s);
        residual_rows(s, s.bas);
      }
    }
    if (wid == 0) {
      if (tab_ok) ppm_decide(s, t, t, ld, ztol, sh);
      else ppm_decide(s, s.zv, s.wv, 1, ztol, sh);
    }
    __syncthreads();
    if (sh->solved && !fresh) {
      // re-check on a fresh solve before returning done
      solve_nonbasic(s);
      residual_rows(s, s.bas);
      if (wid == 0) ppm_decide(s, s.zv, s.wv, 1, ztol, sh);
      __syncthreads();
      if (!sh->solved) tab_ok = 0;   // pivot on from the fresh values
      else return 1;
    }
    if (sh->solved) {
      if (tab_ok) {
        for (int i = tid; i < np; i += kThreads)
          s.zv[i] = s.nb[i] ? t[i * ld] : T(0);
        __syncthreads();
      }
      return 1;
    }
    const int enter = sh->enter, leave = sh->leave;
    const int pivots[2] = {enter, leave};
    for (int p = 0; p < 2; ++p) {
      const int r = pivots[p];
      if (r >= np || !tab_ok) continue;
      copy_pivot(s, r, sh, 0, kThreads);
      __syncthreads();
      if (fabs(s.wv[r]) > T(1e-30)) {
        pivot_update(s, r, sh);
        ++since;
      } else {
        tab_ok = 0;
      }
    }
    if (tid == 0) {
      if (enter < np) { s.nb[enter] = 1; s.bas[enter] = 0; }
      if (leave < np) { s.nb[leave] = 0; s.bas[leave] = s.valid[leave]; }
    }
    __syncthreads();
  }
  return 0;
}

}  // namespace lcp
