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
// The shared-memory layout, the masked Gauss–Jordan, the first-minimum
// reduction and the pivot loop are in lcp_common.cuh, shared with bpp_lcp.cu.
//
// Plain C interface (no PyTorch headers): built by nvcc into a shared library
// and loaded with ctypes by moby_tpu_torch/solvers/hopper_lcp.py.

#include "lcp_common.cuh"

namespace {

using namespace lcp;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ppm_lcp_kernel(const T* __restrict__ Mg, const T* __restrict__ qg,
               const unsigned char* __restrict__ maskg,
               const T* __restrict__ z0g, T* __restrict__ zg,
               unsigned char* __restrict__ okg,
               int n, int np, int max_piv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> s(smem_raw, np);
  __shared__ T s_mn;
  __shared__ int s_idx;
  __shared__ int s_done;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const size_t prob = blockIdx.x;
  T* z = zg + prob * n;

  const int m_active = load_active(s, qg + prob * n, maskg + prob * n, n);
  if (m_active == 0) {
    // min over an empty set is +inf > -ztol: trivial. This is the early exit
    // the cascade relies on for problems that an earlier stage solved.
    for (int i = tid; i < n; i += kThreads) z[i] = T(0);
    if (tid == 0) okg[prob] = 1;
    return;
  }
  const T norminf = load_matrix(s, Mg + prob * n * n, n);
  const T ztol = T(m_active) * norminf * Lim<T>::eps();

  // ---- start basis: the first minimum of q, or the warm start's support
  if (wid == 0) {
    T mn; int idx;
    first_min_warp(s.qv, s.valid, np, mn, idx);
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
    if (z0g != nullptr && i < n && s.valid[i])
      wm = fabs(z0g[prob * n + i]) >= ztol;
    s.bas[i] = wm;          // scratch: warm support
    warm_any |= wm;
  }
  warm_any = __syncthreads_or(warm_any);
  for (int i = tid; i < np; i += kThreads)
    s.nb[i] = warm_any ? s.bas[i] : (i == idx0);
  __syncthreads();

  // ---- pivot loop: this block's own pivot count
  const int done = ppm_pivot_loop(s, ztol, max_piv, &s_done);

  for (int i = tid; i < n; i += kThreads)
    z[i] = (done && s.valid[i]) ? s.zv[i] : T(0);
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
  return (long long)(elem_size == 8 ? lcp::smem_bytes<double>(np)
                                    : lcp::smem_bytes<float>(np));
}

extern "C" const char* ppm_lcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
