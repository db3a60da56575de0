// bpp_lcp.cu — block principal pivoting LCP solver with a principal-pivoting
// second stage and a built-in complementarity check, one thread block per
// problem.
//
// Replaces the TPU kernel body `_bpp_kernel_body` of
// moby_tpu/solvers/pallas_lcp.py behind both of its entries: `bpp_lcp_one`
// (one problem, lifted to a batch by vmap) and `bpp_lcp_batched` (grid over
// the batch). It computes the same function on w = M z + q, z >= 0, w >= 0,
// z'w = 0:
//
//   1. Júdice–Pires block pivoting from the warm start's support (|z0| >=
//      ztol) or, without one, from {q < -ztol}: each iteration solves the
//      system of the nonbasic set F and flips every violator at once (z < -ztol
//      in F leaves, w < -ztol outside F enters). When the number of violators
//      has not strictly improved for 3 iterations in a row, only the violator
//      of least index is flipped (Murty's rule, finite for P-matrices). At
//      most max_bpp iterations.
//   2. If that did not finish: first-minimum principal pivoting (Moby
//      src/LCP.cpp:41) from the block stage's last set, at most max_piv
//      pivots.
//   3. The check the caller would otherwise make: z >= -tol, w >= -tol and
//      |z w| <= tol on the active slots with tol = m·‖M‖∞·sqrt(eps). `ok` is
//      "finished and checked", or "nothing to do" (empty start set, which
//      includes an all-false mask); z is 0 unless finished.
//
// What bounds it. The same as ppm_lcp.cu: the serial depth of the eliminations
// (up to n dependent steps with two block barriers each per iteration), not
// the card's memory or arithmetic rate. What the design does about it:
//   * one block per problem, so each runs exactly its own iterations, and one
//     launch stands for a whole "batched BPP loop + verification" pair, which
//     in plain PyTorch costs one host synchronisation and some hundred small
//     launches per iteration;
//   * a problem with nothing to do leaves after reading its mask (all-false
//     mask: a problem an earlier stage solved) or its q and z0;
//   * M and the working matrix stay in shared memory; elimination visits only
//     the nonbasic rows and the columns right of the pivot (lcp_common.cuh).
//
// NaN. CUDA's comparisons with NaN are false, as jnp's are, so a NaN iterate
// has no violator and the block stage calls itself finished; the check then
// fails on it (every test of step 3 is written as "all of x_i >= -tol", which
// a NaN fails exactly as a NaN-propagating minimum does), and ok = 0.
//
// Plain C interface (no PyTorch headers): built by nvcc into a shared library
// and loaded with ctypes by moby_tpu_torch/solvers/hopper_lcp.py.

#include "lcp_common.cuh"

namespace {

using namespace lcp;

constexpr int kBudget = 3;   // non-improving block iterations before Murty

template <typename T>
__global__ void __launch_bounds__(kThreads)
bpp_lcp_kernel(const T* __restrict__ Mg, const T* __restrict__ qg,
               const unsigned char* __restrict__ maskg,
               const T* __restrict__ z0g, T* __restrict__ zg,
               unsigned char* __restrict__ okg,
               int n, int np, int max_bpp, int max_piv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> s(smem_raw, np);
  __shared__ int s_ninf;
  __shared__ int s_first;
  __shared__ int s_done;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const size_t prob = blockIdx.x;
  T* z = zg + prob * n;

  const int m_active = load_active(s, qg + prob * n, maskg + prob * n, n);
  if (m_active == 0) {
    for (int i = tid; i < n; i += kThreads) z[i] = T(0);
    if (tid == 0) okg[prob] = 1;
    return;
  }
  const T norminf = load_matrix(s, Mg + prob * n * n, n);
  const T ztol = T(m_active) * norminf * Lim<T>::eps();
  const T check_tol = T(m_active) * norminf * Lim<T>::sqrt_eps();

  // ---- start set: the warm start's support if it has any, else {q < -ztol}
  int warm_any = 0;
  for (int i = tid; i < np; i += kThreads) {
    int wm = 0;
    if (z0g != nullptr && s.valid[i])
      wm = fabs(z0g[prob * n + i]) >= ztol;
    s.bas[i] = wm;          // scratch: warm support
    warm_any |= wm;
  }
  warm_any = __syncthreads_or(warm_any);
  int any_f = 0;
  for (int i = tid; i < np; i += kThreads) {
    const int f = warm_any ? s.bas[i] : (s.valid[i] && s.qv[i] < -ztol);
    s.nb[i] = f;
    any_f |= f;
  }
  any_f = __syncthreads_or(any_f);
  if (!any_f) {
    // nothing to do: z = 0 is taken as the solution without a check
    for (int i = tid; i < n; i += kThreads) z[i] = T(0);
    if (tid == 0) okg[prob] = 1;
    return;
  }

  // ---- stage 1: block pivoting, this block's own iteration count
  int done = 0;
  int best = np + 1;
  int budget = kBudget;
  for (int it = 0; it < max_bpp && !done; ++it) {
    solve_nonbasic(s);
    residual_rows(s, s.bas);
    // violators: 1 = in F with z < -ztol (leaves), 2 = outside with
    // w < -ztol (enters); kept in bas, which the next solve rebuilds
    for (int i = tid; i < np; i += kThreads) {
      int v = 0;
      if (s.nb[i]) v = (s.zv[i] < -ztol) ? 1 : 0;
      else if (s.bas[i]) v = (s.wv[i] < -ztol) ? 2 : 0;
      s.bas[i] = v;
    }
    __syncthreads();
    if (wid == 0) {
      int cnt = 0, first = np;
      for (int i = lane; i < np; i += 32)
        if (s.bas[i]) { ++cnt; if (i < first) first = i; }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
        first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
      }
      if (lane == 0) { s_ninf = cnt; s_first = first; }
    }
    __syncthreads();
    const int ninf = s_ninf;
    if (ninf == 0) {
      done = 1;
    } else {
      const bool improved = ninf < best;
      const int next = improved ? kBudget : budget - 1;
      const bool block = next > 0;
      const int first = s_first;
      for (int i = tid; i < np; i += kThreads) {
        const int v = s.bas[i];
        if (v && (block || i == first)) s.nb[i] = (v == 2);
      }
      if (improved) best = ninf;
      budget = next > 0 ? next : 0;
      __syncthreads();
    }
  }

  // ---- stage 2: principal pivoting from the block stage's last set
  if (!done) done = ppm_pivot_loop(s, ztol, max_piv, &s_done);

  // ---- stage 3: the check, on the z that is returned
  for (int i = tid; i < np; i += kThreads)
    if (!(done && s.valid[i])) s.zv[i] = T(0);
  __syncthreads();
  residual_rows(s, s.valid);
  int good = 1;
  for (int i = tid; i < np; i += kThreads) {
    if (!s.valid[i]) continue;
    const T zi = s.zv[i], wi = s.wv[i];
    good &= (zi >= -check_tol) && (wi >= -check_tol) && (fabs(zi * wi) <= check_tol);
  }
  good = __syncthreads_and(good);
  for (int i = tid; i < n; i += kThreads) z[i] = s.zv[i];
  if (tid == 0) okg[prob] = (done && good) ? 1 : 0;
}

template <typename T>
int launch(const void* M, const void* q, const void* mask, const void* z0,
           void* z, void* ok, int B, int n, int np, int max_bpp, int max_piv,
           void* stream) {
  const size_t smem = smem_bytes<T>(np);
  cudaError_t e = cudaFuncSetAttribute(
      bpp_lcp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  bpp_lcp_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(M), static_cast<const T*>(q),
      static_cast<const unsigned char*>(mask), static_cast<const T*>(z0),
      static_cast<T*>(z), static_cast<unsigned char*>(ok), n, np, max_bpp,
      max_piv);
  return (int)cudaGetLastError();
}

}  // namespace

// M (B,n,n), q (B,n), z0 (B,n) or null, z (B,n): contiguous, of the named
// type; mask (B,n) and ok (B,): one byte each, 0 or 1 (torch.bool). np: n
// rounded up to a multiple of 32. Launches on `stream`, does not synchronise,
// allocates nothing. Returns the cudaError_t of the launch (0 on success).
extern "C" int bpp_lcp_f32(const void* M, const void* q, const void* mask,
                           const void* z0, void* z, void* ok, int B, int n,
                           int np, int max_bpp, int max_piv, void* stream) {
  return launch<float>(M, q, mask, z0, z, ok, B, n, np, max_bpp, max_piv, stream);
}

extern "C" int bpp_lcp_f64(const void* M, const void* q, const void* mask,
                           const void* z0, void* z, void* ok, int B, int n,
                           int np, int max_bpp, int max_piv, void* stream) {
  return launch<double>(M, q, mask, z0, z, ok, B, n, np, max_bpp, max_piv, stream);
}

// Dynamic shared memory one block needs, for elements of `elem_size` bytes.
extern "C" long long bpp_lcp_smem_bytes(int np, int elem_size) {
  return (long long)(elem_size == 8 ? lcp::smem_bytes<double>(np)
                                    : lcp::smem_bytes<float>(np));
}

extern "C" const char* bpp_lcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
