// bpp_lcp.cu — block principal pivoting LCP solver with a principal-pivoting
// second stage and a built-in complementarity check.
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
//      |z w| <= tol on the active slots with tol = m·‖M‖∞·sqrt(eps), or the
//      caller's per-problem tolerance where one is given. `ok` is "finished
//      and checked", or "nothing to do": an all-false mask, or an empty
//      start set when no tolerance is given (with one, z = 0 is checked like
//      any other answer, so a NaN in M gives ok = 0). z is 0 unless finished.
//
// What bounds it. Not bytes or operations: the serial depth of the pivot
// chain. Each block iteration is a solve of up to n dependent elimination
// steps, each a rank-1 update that must finish before the next pivot can be
// read, then a product M z, a count of violators and a set update. On the
// MPC path (n=8, B=1536, one or two iterations a problem) the work per
// problem is a few hundred multiply-adds, so what a design can cut is the
// latency of each dependent step. What each path does about it:
//
//   * n <= 32 (the group path, lcp_common.cuh): a problem is G = 8, 16 or 32
//     lanes of one warp; each step of the elimination is a warp shuffle and
//     a register fma, the violator sets are ballots counted with __popc, the
//     least violator is the lowest set bit, and the check is one more
//     ballot: no shared memory and no block barrier. An all-false mask
//     leaves after reading its mask; a warp leaves when all its groups have.
//   * n > 32 (the block path): one block per problem with M and the working
//     system in shared memory; the block stage re-solves each iteration with
//     a Gauss–Jordan of one barrier per step over the nonbasic rows only, and
//     the PPM stage keeps a tableau that each pivot updates by one rank-one
//     update (ppm_pivot_loop).
//   * either way, one launch stands for a whole "batched BPP loop +
//     verification" pair, which in plain PyTorch costs one host
//     synchronisation and some hundred small launches per iteration.
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

// ---------------------------------------------------------------- group path
template <typename T, int G>
__global__ void __launch_bounds__(kGroupThreads)
bpp_lcp_group(const T* __restrict__ Mg, const T* __restrict__ qg,
              const unsigned char* __restrict__ maskg,
              const T* __restrict__ z0g, const T* __restrict__ tolg,
              T* __restrict__ zg, unsigned char* __restrict__ okg,
              int B, int n, int max_bpp, int max_piv) {
  const Group<G> g;
  const int prob = (blockIdx.x * kGroupThreads + threadIdx.x) / G;
  const bool live = prob < B;            // the last block may hold fewer
  const bool row = live && g.i < n;
  const size_t off = (size_t)prob * n;
  const bool valid_i = row && maskg[off + g.i] != 0;
  const unsigned V = g.bits(valid_i);

  // an all-false mask (or no problem): nothing to do, z = 0, ok = 1
  const bool idle = V == 0u;
  if (idle) {
    if (row) zg[off + g.i] = T(0);
    if (live && g.i == 0) okg[prob] = 1;
  }
  if (__all_sync(kFull, idle)) return;

  T Mrow[G];
  const T qi = group_load<T, G>(g, Mg + off * n, qg + off, n, valid_i, V, Mrow);
  const T norminf = group_norminf<T, G>(g, Mrow, valid_i, V);
  const T m_active = T(__popc(V));
  const T ztol = m_active * norminf * Lim<T>::eps();
  const T tol = (tolg != nullptr) ? (live ? tolg[prob] : T(0))
                                  : m_active * norminf * Lim<T>::sqrt_eps();

  // ---- start set: the warm start's support if it has any, else {q < -ztol}
  // (both ballots by every lane: a ballot inside `?:` would diverge)
  const unsigned W = g.bits(z0g != nullptr && valid_i && fabs(z0g[off + g.i]) >= ztol);
  const unsigned C = g.bits(valid_i && qi < -ztol);
  unsigned F = W ? W : C;
  const bool trivial = !idle && F == 0u;

  // ---- stage 1: block pivoting, this group's own iteration count
  bool done = idle || trivial;
  T zi = T(0);
  int best = G + 1;
  int budget = kBudget;
  for (int it = 0; it < max_bpp; ++it) {
    if (__all_sync(kFull, done)) break;
    const bool in_i = (F >> g.i) & 1u;
    const T zs = group_solve<T, G>(g, Mrow, qi, F);
    const T w = group_residual<T, G>(g, Mrow, qi, zs);
    const unsigned H1 = g.bits(in_i && zs < -ztol);
    const unsigned H2 = g.bits(valid_i && !in_i && w < -ztol);
    if (!done) {
      zi = zs;
      const unsigned viol = H1 | H2;
      const int ninf = __popc(viol);
      if (ninf == 0) {
        done = true;
      } else {
        const bool improved = ninf < best;
        const int next = improved ? kBudget : budget - 1;
        // Murty: only the violator of least index, the lowest set bit
        const unsigned flip = next > 0 ? viol : (viol & (0u - viol));
        F = (F & ~(flip & H1)) | (flip & H2);
        if (improved) best = ninf;
        budget = next > 0 ? next : 0;
      }
    }
  }

  // ---- stage 2: principal pivoting from the block stage's last set
  group_ppm<T, G>(g, Mrow, qi, valid_i, F, ztol, max_piv, done, zi);

  // ---- stage 3: the check, on the z that is returned
  const T zc = (done && !trivial && valid_i) ? zi : T(0);
  const T wc = group_residual<T, G>(g, Mrow, qi, zc);
  const bool bad = valid_i && !((zc >= -tol) && (wc >= -tol) && (fabs(zc * wc) <= tol));
  const bool good = g.bits(bad) == 0u;
  if (!idle) {
    if (row) zg[off + g.i] = zc;
    if (g.i == 0)
      okg[prob] = (trivial && tolg == nullptr) ? 1 : ((done && good) ? 1 : 0);
  }
}

// ---------------------------------------------------------------- block path
template <typename T>
__global__ void __launch_bounds__(kThreads)
bpp_lcp_block(const T* __restrict__ Mg, const T* __restrict__ qg,
              const unsigned char* __restrict__ maskg,
              const T* __restrict__ z0g, const T* __restrict__ tolg,
              T* __restrict__ zg, unsigned char* __restrict__ okg,
              int n, int np, int max_bpp, int max_piv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> s(smem_raw, n, np);
  __shared__ int s_ninf;
  __shared__ int s_first;
  __shared__ PivotShared<T> sh;

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
  const T check_tol = (tolg != nullptr) ? tolg[prob]
                                        : T(m_active) * norminf * Lim<T>::sqrt_eps();

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
  const bool trivial = !any_f;
  if (trivial && tolg == nullptr) {
    // nothing to do: z = 0 is taken as the solution without a check
    for (int i = tid; i < n; i += kThreads) z[i] = T(0);
    if (tid == 0) okg[prob] = 1;
    return;
  }

  // ---- stage 1: block pivoting, this block's own iteration count
  int done = trivial;
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
        cnt += __shfl_xor_sync(kFull, cnt, o);
        first = min(first, __shfl_xor_sync(kFull, first, o));
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
  if (!done) done = ppm_pivot_loop(s, ztol, max_piv, &sh);

  // ---- stage 3: the check, on the z that is returned
  for (int i = tid; i < np; i += kThreads)
    if (!(done && !trivial && s.valid[i])) s.zv[i] = T(0);
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

template <typename T, int G>
void launch_group(const void* M, const void* q, const void* mask,
                  const void* z0, const void* tol, void* z, void* ok, int B,
                  int n, int max_bpp, int max_piv, int grid, cudaStream_t st) {
  bpp_lcp_group<T, G><<<grid, kGroupThreads, 0, st>>>(
      static_cast<const T*>(M), static_cast<const T*>(q),
      static_cast<const unsigned char*>(mask), static_cast<const T*>(z0),
      static_cast<const T*>(tol), static_cast<T*>(z),
      static_cast<unsigned char*>(ok), B, n, max_bpp, max_piv);
}

template <typename T>
int launch(const void* M, const void* q, const void* mask, const void* z0,
           const void* tol, void* z, void* ok, int B, int n, int np,
           int max_bpp, int max_piv, int group, int per_block, int grid,
           int smem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group == 0) {
    if (per_block != 1 || grid != B || np != (n + 31) / 32 * 32
        || (size_t)smem != smem_bytes<T>(np))
      return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        bpp_lcp_block<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    bpp_lcp_block<T><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(M), static_cast<const T*>(q),
        static_cast<const unsigned char*>(mask), static_cast<const T*>(z0),
        static_cast<const T*>(tol), static_cast<T*>(z),
        static_cast<unsigned char*>(ok), n, np, max_bpp, max_piv);
    return (int)cudaGetLastError();
  }
  if (n > group || per_block * group != kGroupThreads
      || grid != (B + per_block - 1) / per_block || smem != 0)
    return (int)cudaErrorInvalidValue;
  switch (group) {
    case 8: launch_group<T, 8>(M, q, mask, z0, tol, z, ok, B, n, max_bpp, max_piv, grid, st); break;
    case 16: launch_group<T, 16>(M, q, mask, z0, tol, z, ok, B, n, max_bpp, max_piv, grid, st); break;
    case 32: launch_group<T, 32>(M, q, mask, z0, tol, z, ok, B, n, max_bpp, max_piv, grid, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// M (B,n,n), q (B,n), z0 (B,n) or null, tol (B,) or null, z (B,n):
// contiguous, of the named type; mask (B,n) and ok (B,): one byte each, 0 or
// 1 (torch.bool). np: n rounded up to a multiple of 32. group, per_block,
// grid, smem: the launch plan of hopper_lcp.launch_plan (group 0: one block
// per problem with smem bytes of shared memory; else G lanes per problem,
// per_block problems a block), checked here. Launches on `stream`, does not
// synchronise, allocates nothing. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int bpp_lcp_f32(const void* M, const void* q, const void* mask,
                           const void* z0, const void* tol, void* z, void* ok,
                           int B, int n, int np, int max_bpp, int max_piv,
                           int group, int per_block, int grid, int smem,
                           void* stream) {
  return launch<float>(M, q, mask, z0, tol, z, ok, B, n, np, max_bpp, max_piv,
                       group, per_block, grid, smem, stream);
}

extern "C" int bpp_lcp_f64(const void* M, const void* q, const void* mask,
                           const void* z0, const void* tol, void* z, void* ok,
                           int B, int n, int np, int max_bpp, int max_piv,
                           int group, int per_block, int grid, int smem,
                           void* stream) {
  return launch<double>(M, q, mask, z0, tol, z, ok, B, n, np, max_bpp, max_piv,
                        group, per_block, grid, smem, stream);
}

// Dynamic shared memory one block of the block path needs, for elements of
// `elem_size` bytes.
extern "C" long long bpp_lcp_smem_bytes(int np, int elem_size) {
  return (long long)(elem_size == 8 ? lcp::smem_bytes<double>(np)
                                    : lcp::smem_bytes<float>(np));
}

extern "C" const char* bpp_lcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
