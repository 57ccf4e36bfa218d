// Batched Householder QR, R factor only, Hopper (kernel K2, version 3).
//
// Replaces the TPU kernel cvxpylayers_tpu/solver/pallas_linalg.py
// (_qr_kernel, launched by qr_r_pallas). For each instance it takes an
// (m, n) matrix, m >= n, and returns the upper (n, n) factor R of its QR
// without pivoting. Column j: x = column j from row j down,
// alpha = -sign(x_j) |x| (sign(0) = +1), u = x - alpha e_j. The Pallas
// kernel applies the LAPACK form I - tau v v' with v = u / u_j and
// tau = 2 u_j^2 / |u|^2; this kernel applies the same reflector as
// I - beta u u' with beta = tau / u_j^2 = 2 / |u|^2, reading u straight
// from column j of the tile: no stored v, no division per element. A
// degenerate column (|x|^2 <= 1e-30) gets beta = 0 and keeps x_j on the
// diagonal; a NaN norm stays NaN (max_nan). Callers use R only through
// R'R = M'M, which does not depend on the row signs.
//
// What bounds it on this card: 2mn^2 - (2/3)n^3 operations per instance
// against one read of M and one write of R. At the interior-point main
// path's shape (m = 170, n = 50, B = 1024, f32) that is 0.78 GFLOP and
// 45 MB: the bytes take 0.01345 ms at 3.35 TB/s, the FMAs 0.0117 ms at
// 67 TFLOP/s, so the bound is set by bytes. The kernel is far from it:
// each instance is a chain of n dependent column steps, and PERF.md
// measures what one step costs.
//
// Design. One thread block per instance (any batch size). The (m, n)
// tile is staged once in dynamic shared memory by asynchronous copies
// (odd row stride), worked on in place for all n steps, and its upper
// triangle written out once. Step j touches only the trailing block
// (rows >= j, columns > j).
// - Lanes over rows, a warp per trailing column: lane l holds rows
//   j + l + 32k of u and of the column in registers (RPL rows, chosen from
//   m at launch), so w_c = u'S_c is a warp sum of shuffles and the update
//   S_c += (-beta w_c) u reads nothing twice. Each warp works on three
//   columns at once so their shuffles overlap. Rows beyond 32 RPL take a
//   second pass from the tile.
// - One block barrier per step (version 2 had five): warp 0 holds column
//   j + 1 and sums its new squares below the diagonal in the same pass
//   (look-ahead), so the next step's norm is one shared word; the
//   diagonal entry is written one step late, when nobody reads it.
// - Every loop bound and every shuffle is the same for the whole block,
//   with loads and stores predicated, so the compiler needs no collective
//   fix-up around the shuffles; no integer division in the column loop.
// - Threads per instance (32, 64, 128 or 256) are chosen by shape in
//   solver/cuda_linalg.py and passed to the launch: one warp for a small
//   tile such as (40, 20).
// Registers set how many blocks an SM holds at the main shape (116 a
// thread in f32, so four blocks of 128 threads; shared memory alone would
// allow six): B = 1024 runs as two waves of 528 and 496 blocks, and
// PERF.md records what each costs.
// Plain FMA in the working type (float or double), no tensor cores, so no
// TF32: the point of the QR route is its eps sqrt(cond) accuracy. When
// the tile does not fit in the shared memory a block can use, the same
// kernel works in place on a copy in device memory (through L1/L2).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxThreads = 256;
// shared words ahead of the tile: the next column's squared norm below its
// diagonal, by step parity (written by one warp while the others may still
// read the current one); two used, eight keep the tile 32-byte aligned
constexpr int kHeader = 8;

__host__ __device__ inline int padded_stride(int n) { return n | 1; }

template <typename T>
__device__ inline T max_nan(T a, T lo) {
  // max(a, lo) that propagates NaN like the plain version's clamp_min
  return (a > lo || a != a) ? a : lo;
}

// Entry (r, c) of the tile: row-major with an odd row stride ld in shared
// memory (a warp's lanes, on consecutive rows, hit distinct banks);
// column-major with column stride ld = m on the device-memory copy (a
// warp's lanes read consecutive words).
template <bool kShared>
__device__ __forceinline__ int at(int r, int c, int ld) {
  return kShared ? r * ld + c : r + c * ld;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One group of trailing columns of a warp: col0, col0 + nw, ... (NC of
// them; those at or beyond n take no part). Lane l takes rows
// j + l + 32k (k < RPL) in registers, rows beyond j + 32 RPL in a second
// pass from the tile. w_c = u'S_c is a warp sum, S_c += (-beta w_c) u;
// the new squares of column j + 1 below row j + 1 add to sq. Every loop
// bound and every shuffle is the same for the whole block, so the warp
// stays converged and the shuffles need no collective fix-up.
template <typename T, int RPL, int NC, bool kShared>
__device__ __forceinline__ void reflect_group(T* S, int ld, int m, int n,
                                              int j, int col0, int nw,
                                              const T (&u)[RPL], T beta,
                                              int lane, T& sq) {
  T s[NC][RPL];
  T d[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int c = col0 + q * nw;
    d[q] = T(0);
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int r = j + lane + 32 * k;
      s[q][k] = (c < n && r < m) ? S[at<kShared>(r, c, ld)] : T(0);
      d[q] = fma(u[k], s[q][k], d[q]);
    }
  }
  for (int rb = j + 32 * RPL; rb < m; rb += 32) {
    const int r = rb + lane;
    const T ur = (r < m) ? S[at<kShared>(r, j, ld)] : T(0);
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int c = col0 + q * nw;
      const T src = (c < n && r < m) ? S[at<kShared>(r, c, ld)] : T(0);
      d[q] = fma(ur, src, d[q]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < NC; ++q)
      d[q] += __shfl_xor_sync(0xffffffffu, d[q], off);
  }
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int c = col0 + q * nw;
    const T w = -beta * d[q];
    const bool look = c == j + 1;
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int r = j + lane + 32 * k;
      const T e = fma(w, u[k], s[q][k]);
      if (c < n && r < m) S[at<kShared>(r, c, ld)] = e;
      sq = (look && r > j + 1 && r < m) ? fma(e, e, sq) : sq;
    }
    for (int rb = j + 32 * RPL; rb < m; rb += 32) {
      const int r = rb + lane;
      if (c < n && r < m) {
        const T e =
            fma(w, S[at<kShared>(r, j, ld)], S[at<kShared>(r, c, ld)]);
        S[at<kShared>(r, c, ld)] = e;
        if (look) sq = fma(e, e, sq);
      }
    }
  }
}

// kShared: the tile lies in shared memory (32-bit shared loads and
// stores); otherwise on a column-major device-memory copy in work_g. RPL:
// rows each lane keeps in registers per column (32 RPL >= m keeps them
// all).
template <typename T, int RPL, bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
house_qr_r_kernel(const T* __restrict__ m_g, T* __restrict__ r_g,
                  T* __restrict__ work_g, int m, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t inst = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const T tiny = T(1e-30);

  T* nrm = reinterpret_cast<T*>(smem_raw);
  const T* m_inst = m_g + inst * (size_t)m * n;
  T* S;
  int ld;
  if constexpr (kShared) {
    S = nrm + kHeader;
    ld = padded_stride(n);
  } else {
    S = work_g + inst * (size_t)m * n;
    ld = m;
  }
  // stage the tile: element k = r n + c; (r, c) advance by (nt / n,
  // nt % n) with one carry. Into shared memory as asynchronous copies,
  // all in flight at once, waited for after the norm below.
  const int dr = nt / n;
  const int dc = nt - dr * n;
  {
    int r = tid / n;
    int c = tid - r * n;
    for (int k = tid; k < m * n; k += nt) {
      if constexpr (kShared)
        __pipeline_memcpy_async(S + at<true>(r, c, ld), m_inst + k,
                                sizeof(T));
      else
        S[at<kShared>(r, c, ld)] = m_inst[k];
      r += dr;
      c += dc;
      if (c >= n) {
        c -= n;
        ++r;
      }
    }
    if constexpr (kShared) __pipeline_commit();
  }
  // column 0's squared norm below the diagonal, by warp 0
  if (warp == 0) {
    T sq = T(0);
    for (int r = 1 + lane; r < m; r += 32) {
      const T e = m_inst[(size_t)r * n];
      sq = fma(e, e, sq);
    }
    sq = warp_sum(sq);
    if (lane == 0) nrm[0] = sq;
  }
  if constexpr (kShared) __pipeline_wait_prior(0);
  __syncthreads();

  T diag = T(0);
  for (int j = 0; j < n; ++j) {
    // the step's scalars, from the diagonal entry and the norm below it
    const T xj = S[at<kShared>(j, j, ld)];
    const T tail2 = nrm[j & 1];
    const T nx2 = fma(xj, xj, tail2);
    const bool degen = nx2 <= tiny;  // false for NaN: it flows through
    const T nx = sqrt(max_nan(nx2, tiny));
    const T alpha = (xj < T(0)) ? nx : -nx;
    const T uj = xj - alpha;
    const T beta = degen ? T(0) : T(2) / max_nan(fma(uj, uj, tail2), tiny);
    // the previous step's diagonal: everyone has read it by now, and
    // nobody reads it in this step
    if (j > 0 && tid == 0) S[at<kShared>(j - 1, j - 1, ld)] = diag;
    diag = degen ? xj : alpha;
    if (j + 1 == n) break;
    T u[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int r = j + lane + 32 * k;
      u[k] = (r < m) ? S[at<kShared>(r, j, ld)] : T(0);
    }
    u[0] = (lane == 0) ? uj : u[0];
    // trailing column j + 1 + i goes to warp i mod nw, three at a time
    // (four need more registers and fit fewer f64 blocks on an SM); warp 0
    // holds column j + 1 and with it the next step's norm
    T sq = T(0);
    for (int base = 0; base < n - j - 1; base += 3 * nw)
      reflect_group<T, RPL, 3, kShared>(S, ld, m, n, j, j + 1 + base + warp,
                                        nw, u, beta, lane, sq);
    sq = warp_sum(sq);
    if (tid == 0) nrm[(j + 1) & 1] = sq;
    __syncthreads();
  }
  if (tid == 0) S[at<kShared>(n - 1, n - 1, ld)] = diag;
  __syncthreads();

  T* r_inst = r_g + inst * (size_t)n * n;
  const int er = nt / n;
  const int ec = nt - er * n;
  int r = tid / n;
  int c = tid - r * n;
  for (int k = tid; k < n * n; k += nt) {
    r_inst[k] = (c >= r) ? S[at<kShared>(r, c, ld)] : T(0);
    r += er;
    c += ec;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }
}

size_t needed_bytes(int m, int n, int elem, int in_shared) {
  size_t words = (size_t)kHeader;
  if (in_shared) words += (size_t)m * (size_t)padded_stride(n);
  return words * (size_t)elem;
}

template <typename T, int RPL, bool kShared>
int launch_on(const void* M, void* R, void* work, int B, int m, int n,
              int threads, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        house_qr_r_kernel<T, RPL, kShared>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  house_qr_r_kernel<T, RPL, kShared>
      <<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
          (const T*)M, (T*)R, (T*)work, m, n);
  return (int)cudaGetLastError();
}

template <typename T, bool kShared>
int launch_rows(const void* M, void* R, void* work, int B, int m, int n,
                int threads, int smem_bytes, void* stream) {
  // registers per lane and column: enough for all m rows up to 256
  const int rounds = (m + 31) / 32;
  if (rounds <= 1)
    return launch_on<T, 1, kShared>(M, R, work, B, m, n, threads,
                                     smem_bytes, stream);
  if (rounds <= 2)
    return launch_on<T, 2, kShared>(M, R, work, B, m, n, threads,
                                     smem_bytes, stream);
  if (rounds <= 4)
    return launch_on<T, 4, kShared>(M, R, work, B, m, n, threads,
                                     smem_bytes, stream);
  if (rounds <= 6)
    return launch_on<T, 6, kShared>(M, R, work, B, m, n, threads,
                                     smem_bytes, stream);
  return launch_on<T, 8, kShared>(M, R, work, B, m, n, threads, smem_bytes,
                                   stream);
}

template <typename T>
int launch(const void* M, void* R, void* work, int B, int m, int n,
           int threads, int smem_bytes, int in_shared, void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      smem_bytes < 0 ||
      (size_t)smem_bytes < needed_bytes(m, n, (int)sizeof(T), in_shared))
    return (int)cudaErrorInvalidValue;
  return in_shared ? launch_rows<T, true>(M, R, work, B, m, n, threads,
                                          smem_bytes, stream)
                   : launch_rows<T, false>(M, R, work, B, m, n, threads,
                                           smem_bytes, stream);
}

}  // namespace

extern "C" {

// The shared memory one block may opt into on `device`, in bytes, or
// -1 - cudaError on a failed query.
int house_qr_smem_optin(int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? optin : -1 - (int)err;
}

// One launch over a batch of B contiguous (m, n) matrices; R receives B
// contiguous upper (n, n) factors. `threads` (32, 64, 128 or 256) and
// `smem_bytes` come from the caller's launch plan: the header and the
// (m, n) tile when in_shared == 1, the header alone when the tile lives in
// `work` (B * m * n elements, used only when in_shared == 0). Returns
// the cudaError_t of the launch (0 on success), or cudaErrorInvalidValue
// when the plan does not fit the kernel's layout.
int house_qr_r_f32(const void* M, void* R, void* work, int B, int m, int n,
                   int threads, int smem_bytes, int in_shared,
                   void* stream) {
  return launch<float>(M, R, work, B, m, n, threads, smem_bytes, in_shared,
                       stream);
}

int house_qr_r_f64(const void* M, void* R, void* work, int B, int m, int n,
                   int threads, int smem_bytes, int in_shared,
                   void* stream) {
  return launch<double>(M, R, work, B, m, n, threads, smem_bytes, in_shared,
                        stream);
}

}  // extern "C"
