// ppm_lcp.cu — principal-pivoting LCP solver.
//
// Replaces the TPU kernel `_ppm_kernel_impl` of moby_tpu/solvers/pallas_lcp.py
// (entries `ppm_lcp_one`, warm-started, and `ppm_lcp_batched`, cold). It
// computes the same function: first-minimum principal pivoting (Moby
// src/LCP.cpp:41) on w = M z + q, z >= 0, w >= 0, z'w = 0, started from
// |z0| >= ztol when a warm start is given, returning z and a `done` flag
// that the caller verifies.
//
// What bounds it. Not bytes or operations: the serial depth of the pivot
// chain. A pivot needs z_F and w_B for the current nonbasic set F before the
// next index can be chosen, and the pivots of one problem follow one another.
// Solving the nonbasic system from scratch for every pivot, as the TPU kernel
// does, makes each pivot up to n dependent elimination steps. What each path
// does about it:
//
//   * n <= 32 (the group path, lcp_common.cuh; the stabilization's n=6): a
//     problem is G = 8, 16 or 32 lanes of one warp, the re-solve of each pivot
//     is G register-resident elimination steps that exchange rows by warp
//     shuffles, the first minima are shuffle reductions within the group, and
//     the sets are bit masks: no shared memory, no block barrier.
//   * n > 32 (the block path; the impact step's n=66): one block per problem
//     with M in shared memory. The pivot loop keeps the principal pivot
//     transform (Tucker's tableau) of [M | q] on F in the working matrix and
//     reads z_F and w_B from its last column: an entering or a leaving index
//     is one principal pivot, a rank-one update of the tableau's first n
//     rows and columns and its last column (one copy of the pivot row and
//     column, one update pass; the padding up to np is never read),
//     instead of |F| dependent elimination steps with a barrier each. It
//     re-solves from M every kRefresh = 16 updates (bounding the rounding the
//     updates accumulate), before it returns done (the "solved" is checked
//     again on a fresh solve, and pivoting goes on from there if it
//     disagrees), and at a pivot |T_rr| <= 1e-30, where the fresh
//     Gauss–Jordan skips the step exactly as the TPU kernel does.
//   * either path: every problem runs exactly its own number of pivots; an
//     already-solved problem (all-false mask) leaves before it loads M; M is
//     read from device memory once and z written once.
//
// Reductions propagate NaN as jnp.min does (CUDA's fmin drops it): a
// first-minimum over a set that holds a NaN returns NaN and selects no index,
// so a singular sub-solve that poisons z stalls the pivoting and the problem
// comes back with done = 0, exactly as in the plain version.
//
// Plain C interface (no PyTorch headers): built by nvcc into a shared library
// and loaded with ctypes by moby_tpu_torch/solvers/hopper_lcp.py.

#include "lcp_common.cuh"

namespace {

using namespace lcp;

// ---------------------------------------------------------------- group path
template <typename T, int G>
__global__ void __launch_bounds__(kGroupThreads)
ppm_lcp_group(const T* __restrict__ Mg, const T* __restrict__ qg,
              const unsigned char* __restrict__ maskg,
              const T* __restrict__ z0g, T* __restrict__ zg,
              unsigned char* __restrict__ okg, int B, int n, int max_piv) {
  const Group<G> g;
  const int prob = (blockIdx.x * kGroupThreads + threadIdx.x) / G;
  const bool live = prob < B;            // the last block may hold fewer
  const bool row = live && g.i < n;
  const size_t off = (size_t)prob * n;
  const bool valid_i = row && maskg[off + g.i] != 0;
  const unsigned V = g.bits(valid_i);

  // an all-false mask (or no problem): trivial, done, z = 0
  const bool idle = V == 0u;
  if (idle) {
    if (row) zg[off + g.i] = T(0);
    if (live && g.i == 0) okg[prob] = 1;
  }
  if (__all_sync(kFull, idle)) return;

  T Mrow[G];
  const T qi = group_load<T, G>(g, Mg + off * n, qg + off, n, valid_i, V, Mrow);
  const T norminf = group_norminf<T, G>(g, Mrow, valid_i, V);
  const T ztol = T(__popc(V)) * norminf * Lim<T>::eps();

  // ---- start basis: the first minimum of q, or the warm start's support;
  // `trivial` comes from the cold rule even when a warm start is given
  T mn;
  int idx0;
  group_first_min<T, G>(g, qi, valid_i, mn, idx0);
  const bool trivial = !idle && mn > -ztol;
  const unsigned W = g.bits(z0g != nullptr && valid_i && fabs(z0g[off + g.i]) >= ztol);
  const unsigned F = W ? W : (idx0 < G ? 1u << idx0 : 0u);

  // ---- pivot loop: this group's own pivot count
  bool done = idle || trivial;
  T zi = T(0);
  group_ppm<T, G>(g, Mrow, qi, valid_i, F, ztol, max_piv, done, zi);

  if (!idle) {
    if (row) zg[off + g.i] = (done && !trivial && valid_i) ? zi : T(0);
    if (g.i == 0) okg[prob] = done ? 1 : 0;
  }
}

// ---------------------------------------------------------------- block path
template <typename T>
__global__ void __launch_bounds__(kThreads)
ppm_lcp_block(const T* __restrict__ Mg, const T* __restrict__ qg,
              const unsigned char* __restrict__ maskg,
              const T* __restrict__ z0g, T* __restrict__ zg,
              unsigned char* __restrict__ okg, int n, int np, int max_piv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> s(smem_raw, n, np);
  __shared__ T s_mn;
  __shared__ int s_idx;
  __shared__ PivotShared<T> sh;

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
    first_min_warp(s.qv, 1, s.valid, np, mn, idx);
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
  const int done = ppm_pivot_loop(s, ztol, max_piv, &sh);

  for (int i = tid; i < n; i += kThreads)
    z[i] = (done && s.valid[i]) ? s.zv[i] : T(0);
  if (tid == 0) okg[prob] = done ? 1 : 0;
}

template <typename T, int G>
void launch_group(const void* M, const void* q, const void* mask,
                  const void* z0, void* z, void* ok, int B, int n, int max_piv,
                  int grid, cudaStream_t st) {
  ppm_lcp_group<T, G><<<grid, kGroupThreads, 0, st>>>(
      static_cast<const T*>(M), static_cast<const T*>(q),
      static_cast<const unsigned char*>(mask), static_cast<const T*>(z0),
      static_cast<T*>(z), static_cast<unsigned char*>(ok), B, n, max_piv);
}

template <typename T>
int launch(const void* M, const void* q, const void* mask, const void* z0,
           void* z, void* ok, int B, int n, int np, int max_piv, int group,
           int per_block, int grid, int smem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group == 0) {
    if (per_block != 1 || grid != B || np != (n + 31) / 32 * 32
        || (size_t)smem != smem_bytes<T>(np))
      return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        ppm_lcp_block<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    ppm_lcp_block<T><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(M), static_cast<const T*>(q),
        static_cast<const unsigned char*>(mask), static_cast<const T*>(z0),
        static_cast<T*>(z), static_cast<unsigned char*>(ok), n, np, max_piv);
    return (int)cudaGetLastError();
  }
  if (n > group || per_block * group != kGroupThreads
      || grid != (B + per_block - 1) / per_block || smem != 0)
    return (int)cudaErrorInvalidValue;
  switch (group) {
    case 8: launch_group<T, 8>(M, q, mask, z0, z, ok, B, n, max_piv, grid, st); break;
    case 16: launch_group<T, 16>(M, q, mask, z0, z, ok, B, n, max_piv, grid, st); break;
    case 32: launch_group<T, 32>(M, q, mask, z0, z, ok, B, n, max_piv, grid, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// M (B,n,n), q (B,n), z0 (B,n) or null, z (B,n): contiguous, of the named
// type; mask (B,n) and ok (B,): one byte each, 0 or 1 (torch.bool). np: n
// rounded up to a multiple of 32. group, per_block, grid, smem: the launch
// plan of hopper_lcp.launch_plan (group 0: one block per problem with smem
// bytes of shared memory; else G lanes per problem, per_block problems a
// block), checked here. Launches on `stream`, does not synchronise,
// allocates nothing. Returns the cudaError_t of the launch (0 on success).
extern "C" int ppm_lcp_f32(const void* M, const void* q, const void* mask,
                           const void* z0, void* z, void* ok, int B, int n,
                           int np, int max_piv, int group, int per_block,
                           int grid, int smem, void* stream) {
  return launch<float>(M, q, mask, z0, z, ok, B, n, np, max_piv, group,
                       per_block, grid, smem, stream);
}

extern "C" int ppm_lcp_f64(const void* M, const void* q, const void* mask,
                           const void* z0, void* z, void* ok, int B, int n,
                           int np, int max_piv, int group, int per_block,
                           int grid, int smem, void* stream) {
  return launch<double>(M, q, mask, z0, z, ok, B, n, np, max_piv, group,
                        per_block, grid, smem, stream);
}

// Dynamic shared memory one block of the block path needs, for elements of
// `elem_size` bytes.
extern "C" long long ppm_lcp_smem_bytes(int np, int elem_size) {
  return (long long)(elem_size == 8 ? lcp::smem_bytes<double>(np)
                                    : lcp::smem_bytes<float>(np));
}

extern "C" const char* ppm_lcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
