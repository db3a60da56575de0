// ppm_lcp.cu — principal-pivoting LCP solver, one thread block per problem.
//
// Replaces the TPU kernel `_ppm_kernel_impl` of moby_tpu/solvers/pallas_lcp.py
// (entries `ppm_lcp_one`, warm-started, and `ppm_lcp_batched`, cold). It
// computes the same function: first-minimum principal pivoting (Moby
// src/LCP.cpp:41) on w = M z + q, z >= 0, w >= 0, z'w = 0, started from
// |z0| >= ztol when a warm start is given, returning z and a `done` flag
// that the caller verifies.
//
// What bounds it. Each pivot is a Gauss–Jordan solve of the nonbasic system:
// up to n dependent elimination steps, each a rank-1 update that must finish
// before the next pivot element can be read. The kernel is bound by that
// serial depth (two block barriers per elimination step), not by the card's
// memory or arithmetic rate. What the design does about it:
//   * one block per problem, so every problem runs exactly its own number of
//     pivots and an already-solved problem (all-false mask) leaves before it
//     loads anything;
//   * M (padded, masked) and the working matrix stay in shared memory for the
//     whole solve: device memory is read once and written once;
//   * elimination visits only nonbasic rows and pivots and only the columns
//     right of the pivot (the columns left of it are never read again), which
//     leaves the values of z unchanged and cuts the work per step;
//   * n is padded to a multiple of 32 (a warp), not to a 128-lane tile, and
//     the working matrix has an odd row stride (np + 1, the right-hand side
//     rides as its last column) so that row and column walks are free of
//     bank conflicts.
//
// Reductions propagate NaN as jnp.min does (CUDA's fmin drops it): a
// first-minimum over a set that holds a NaN returns NaN and selects no index,
// so a singular sub-solve that poisons z stalls the pivoting and the problem
// comes back with done = 0, exactly as in the plain version.
//
// Plain C interface (no PyTorch headers): built by nvcc into a shared library
// and loaded with ctypes by moby_tpu_torch/solvers/hopper_lcp.py.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T> struct Lim;
template <> struct Lim<float> {
  static __device__ __forceinline__ float eps() { return 1.1920928955078125e-07f; }
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
  static __device__ __forceinline__ float nan() { return CUDART_NAN_F; }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double eps() { return 2.220446049250313e-16; }
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
ppm_lcp_kernel(const T* __restrict__ Mg, const T* __restrict__ qg,
               const unsigned char* __restrict__ maskg,
               const T* __restrict__ z0g, T* __restrict__ zg,
               unsigned char* __restrict__ okg,
               int n, int np, int max_piv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = np + 1;
  T* Mp = reinterpret_cast<T*>(smem_raw);
  T* A = Mp + np * np;
  T* qv = A + np * ld;
  T* zv = qv + np;
  T* wv = zv + np;
  int* valid = reinterpret_cast<int*>(wv + np);
  int* nb = valid + np;
  int* bas = nb + np;
  __shared__ T s_mn;
  __shared__ int s_idx;
  __shared__ int s_done;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const size_t prob = blockIdx.x;
  const T* M = Mg + prob * n * n;
  const T* q = qg + prob * n;
  const unsigned char* mask = maskg + prob * n;
  T* z = zg + prob * n;

  // ---- active slots; padded and masked-out slots are inert (M_ii=1, q_i=1)
  for (int i = tid; i < np; i += kThreads) {
    const int v = (i < n) && (mask[i] != 0);
    valid[i] = v;
    qv[i] = v ? q[i] : T(1);
  }
  __syncthreads();
  int m_active = 0;
  for (int i = 0; i < np; ++i) m_active += valid[i];
  if (m_active == 0) {
    // min over an empty set is +inf > -ztol: trivial. This is the early exit
    // the cascade relies on for problems that an earlier stage solved.
    for (int i = tid; i < n; i += kThreads) z[i] = T(0);
    if (tid == 0) okg[prob] = 1;
    return;
  }

  // ---- Mp = masked, padded M; row sums of |M| over the active submatrix
  for (int i = wid; i < np; i += kWarps) {
    T rs = T(0);
    for (int j = lane; j < np; j += 32) {
      T a;
      if (valid[i] && valid[j]) a = M[(size_t)i * n + j];
      else a = (i == j && !valid[j]) ? T(1) : T(0);
      Mp[i * np + j] = a;
      if (valid[i] && valid[j]) rs += fabs(a);
    }
    rs = warp_sum(rs);
    if (lane == 0) wv[i] = valid[i] ? rs : T(0);
  }
  __syncthreads();
  T norminf = T(0);
  for (int i = 0; i < np; ++i) {
    const T r = wv[i];
    if (r != r || r > norminf) norminf = r;   // NaN-propagating max
  }
  const T ztol = T(m_active) * norminf * Lim<T>::eps();
  __syncthreads();   // wv is reused below

  // ---- start basis: the first minimum of q, or the warm start's support
  if (wid == 0) {
    T mn; int idx;
    first_min_warp(qv, valid, np, mn, idx);
    if (lane == 0) { s_mn = mn; s_idx = idx; }
  }
  __syncthreads();
  const bool trivial = s_mn > -ztol;
  if (trivial) {
    // decided by the cold rule even when a warm start is given
    for (int i = tid; i < n; i += kThreads) z[i] = T(0);
    if (tid == 0) okg[prob] = 1;
    return;
  }
  const int idx0 = s_idx;
  int warm_any = 0;
  for (int i = tid; i < np; i += kThreads) {
    int wm = 0;
    if (z0g != nullptr && i < n && valid[i])
      wm = fabs(z0g[prob * n + i]) >= ztol;
    bas[i] = wm;          // scratch: warm support
    warm_any |= wm;
  }
  warm_any = __syncthreads_or(warm_any);
  for (int i = tid; i < np; i += kThreads)
    nb[i] = warm_any ? bas[i] : (i == idx0);
  if (tid == 0) s_done = 0;
  __syncthreads();

  // ---- pivot loop: this block's own pivot count
  int done = 0;
  for (int piv = 0; piv < max_piv && !done; ++piv) {
    // working system: M on nonbasic x nonbasic, identity elsewhere; the
    // right-hand side -q on the nonbasic rows is column np
    for (int i = wid; i < np; i += kWarps) {
      const int nbi = nb[i];
      for (int j = lane; j < np; j += 32) {
        const int nbj = nb[j];
        A[i * ld + j] = (nbi && nbj) ? Mp[i * np + j]
                                      : ((i == j && !nbj) ? T(1) : T(0));
      }
      if (lane == 0) A[i * ld + np] = nbi ? -qv[i] : T(0);
    }
    __syncthreads();

    // Gauss–Jordan. A step whose |pivot| <= 1e-30 is skipped and leaves the
    // system as it was. Basic rows and pivots are identity rows: their steps
    // change nothing that z depends on, so they are not visited.
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
      zv[i] = nb[i] ? A[i * ld + np] : T(0);
      bas[i] = valid[i] && !nb[i];
    }
    __syncthreads();
    // w = M z + q on the basic rows
    for (int i = wid; i < np; i += kWarps) {
      T s = T(0);
      if (bas[i]) {
        for (int j = lane; j < np; j += 32) s += Mp[i * np + j] * zv[j];
        s = warp_sum(s);
      }
      if (lane == 0) wv[i] = bas[i] ? s + qv[i] : T(0);
    }
    __syncthreads();
    if (wid == 0) {
      T minw, minz; int wi, zi;
      first_min_warp(wv, bas, np, minw, wi);
      first_min_warp(zv, nb, np, minz, zi);
      if (lane == 0) {
        const bool w_ok = minw > -ztol;
        const bool z_neg = minz < -ztol;
        const bool solved = w_ok && !z_neg;
        if (!solved) {
          // add the first index with w < -ztol, drop the first with
          // z < -ztol; possibly both in one iteration
          if (!w_ok && wi < np) nb[wi] = 1;
          if (z_neg && zi < np) nb[zi] = 0;
        }
        s_done = solved ? 1 : 0;
      }
    }
    __syncthreads();
    done = s_done;
  }

  for (int i = tid; i < n; i += kThreads)
    z[i] = (done && valid[i]) ? zv[i] : T(0);
  if (tid == 0) okg[prob] = done ? 1 : 0;
}

template <typename T>
int launch(const void* M, const void* q, const void* mask, const void* z0,
           void* z, void* ok, int B, int n, int np, int max_piv, void* stream) {
  const size_t smem = smem_bytes<T>(np);
  cudaError_t e = cudaFuncSetAttribute(
      ppm_lcp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ppm_lcp_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(M), static_cast<const T*>(q),
      static_cast<const unsigned char*>(mask), static_cast<const T*>(z0),
      static_cast<T*>(z), static_cast<unsigned char*>(ok), n, np, max_piv);
  return (int)cudaGetLastError();
}

}  // namespace

// M (B,n,n), q (B,n), z0 (B,n) or null, z (B,n): contiguous, of the named
// type; mask (B,n) and ok (B,): one byte each, 0 or 1 (torch.bool). np: n rounded up to a multiple of 32.
// Launches on `stream`, does not synchronise, allocates nothing. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ppm_lcp_f32(const void* M, const void* q, const void* mask,
                           const void* z0, void* z, void* ok, int B, int n,
                           int np, int max_piv, void* stream) {
  return launch<float>(M, q, mask, z0, z, ok, B, n, np, max_piv, stream);
}

extern "C" int ppm_lcp_f64(const void* M, const void* q, const void* mask,
                           const void* z0, void* z, void* ok, int B, int n,
                           int np, int max_piv, void* stream) {
  return launch<double>(M, q, mask, z0, z, ok, B, n, np, max_piv, stream);
}

// Dynamic shared memory one block needs, for elements of `elem_size` bytes.
extern "C" long long ppm_lcp_smem_bytes(int np, int elem_size) {
  return (long long)(elem_size == 8 ? smem_bytes<double>(np)
                                    : smem_bytes<float>(np));
}

extern "C" const char* ppm_lcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
