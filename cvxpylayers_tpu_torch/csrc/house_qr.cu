// Batched Householder QR, R factor only, Hopper.
//
// Replaces the TPU kernel cvxpylayers_tpu/solver/pallas_linalg.py
// (_qr_kernel, launched by qr_r_pallas). For each instance it takes an
// (m, n) matrix, m >= n, and returns the upper (n, n) factor R of its QR
// without pivoting. Column j: x = column j from row j down,
// alpha = -sign(x_j) |x| (sign(0) = +1), u = x - alpha e_j, v = u / u_j,
// tau = 2 u_j^2 / |u|^2; H = I - tau v v' is applied to the trailing block
// and the diagonal is set to alpha. A degenerate column (|x|^2 <= 1e-30)
// gets tau = 0 and keeps x_j. Callers use R only through R'R = M'M, which
// does not depend on the row signs.
//
// What bounds it on this card: 2mn^2 - (2/3)n^3 operations per instance
// against one read of M and one write of R. At the interior-point main
// path's shape (m = 170, n = 50, B = 1024, f32) that is 0.78 GFLOP and
// 45 MB: about 17 flop per byte, so at the data-sheet rates the bytes take
// slightly longer than the FMAs and the launch is bound by device memory,
// with the operations close behind.
//
// Design (simple and right first): one thread block per instance, so any
// batch size works. The (m, n) tile is staged once in dynamic shared
// memory, worked on in place for all n steps, and the upper triangle is
// written out once, so device memory sees each matrix once. The row
// stride is padded to an odd number of words, so the column pass (threads
// over rows of one column) hits distinct banks. Only the trailing block
// (rows >= j, columns > j) is touched per step, and with six blocks
// resident per SM the kernel is bound by instruction throughput, so the
// trailing block is spread over all threads: thread (g, c) owns trailing
// column c and every nrg-th row from row j + g, where nrg = threads /
// columns (at most kMaxRowGroups). It sums its share of v'S, the shares
// of one column meet in shared memory, every thread of the column adds
// them up to w_c = tau v'S_c in a register and applies S_rc -= v_r w_c to
// its own rows: one barrier between the two halves, w never stored.
// Lanes of a warp read consecutive words of a row. Plain FMA in the
// working type (float or double), no tensor cores, so no TF32: the point
// of the QR route is its eps sqrt(cond) accuracy. When the tile does not
// fit in the shared memory a block can use, the same kernel works in
// place on a copy in device memory (through L1/L2).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kMaxRowGroups = 8;

__host__ __device__ inline int padded_stride(int n) { return n | 1; }

// partial sums of v'S: one per row group and concurrently handled column
__host__ __device__ inline int part_len(int n) {
  return kMaxRowGroups * (n < kMaxThreads ? n : kMaxThreads);
}

template <typename T>
__device__ inline T max_nan(T a, T lo) {
  // max(a, lo) that propagates NaN like the plain version's clamp_min
  return (a > lo || a != a) ? a : lo;
}

template <typename T>
__device__ inline T block_sum(T val, T* red) {
  // sum over the block, returned to every thread; `red` holds kMaxWarps
  for (int off = 16; off > 0; off >>= 1)
    val += __shfl_down_sync(0xffffffffu, val, off);
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  __syncthreads();  // the previous use of `red` is over
  if (lane == 0) red[wid] = val;
  __syncthreads();
  T total = T(0);
  const int nw = blockDim.x >> 5;
  for (int k = 0; k < nw; ++k) total += red[k];
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
house_qr_r_kernel(const T* __restrict__ m_g, T* __restrict__ r_g,
                  T* __restrict__ work_g, int m, int n, int in_shared) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t inst = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const T tiny = T(1e-30);

  T* red = reinterpret_cast<T*>(smem_raw);
  T* v = red + kMaxWarps;
  T* part = v + m;
  const T* m_inst = m_g + inst * (size_t)m * n;
  T* S;
  int ld;
  if (in_shared) {
    S = part + part_len(n);
    ld = padded_stride(n);
  } else {
    S = work_g + inst * (size_t)m * n;
    ld = n;
  }
  for (int k = tid; k < m * n; k += nt) {
    const int r = k / n;
    S[(size_t)r * ld + (k - r * n)] = m_inst[k];
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const T xj = S[(size_t)j * ld + j];
    T sq = T(0);
    for (int r = j + 1 + tid; r < m; r += nt) {
      const T e = S[(size_t)r * ld + j];
      sq = fma(e, e, sq);
    }
    const T tail2 = block_sum(sq, red);
    const T nx2 = fma(xj, xj, tail2);
    const bool degen = nx2 <= tiny;  // false for NaN: it flows through
    const T nx = sqrt(max_nan(nx2, tiny));
    const T alpha = (xj < T(0)) ? nx : -nx;
    const T uj = xj - alpha;
    const T safe_uj = (fabs(uj) > tiny) ? uj : tiny;
    const T uu = fma(uj, uj, tail2);
    const T tau =
        degen ? T(0) : T(2) * safe_uj * safe_uj / max_nan(uu, tiny);
    for (int r = j + tid; r < m; r += nt) {
      const T ur = (r == j) ? uj : S[(size_t)r * ld + j];
      v[r] = degen ? T(0) : ur / safe_uj;
    }
    if (tid == 0) S[(size_t)j * ld + j] = degen ? xj : alpha;
    __syncthreads();
    // H = I - tau v v' on the trailing block: thread (g, cl) takes column
    // c and rows j + g, j + g + nrg, ...; more columns than threads go in
    // several passes
    const int cols = n - j - 1;
    const int cw = cols < nt ? cols : nt;
    for (int c0 = 0; c0 < cols; c0 += cw) {
      int nrg = nt / cw;
      if (nrg > kMaxRowGroups) nrg = kMaxRowGroups;
      const int g = tid / cw;
      const int cl = tid - g * cw;
      const bool has = g < nrg && c0 + cl < cols;
      T* col = S + (j + 1 + c0 + cl);
      if (has) {
        T acc = T(0);
        for (int r = j + g; r < m; r += nrg)
          acc = fma(v[r], col[(size_t)r * ld], acc);
        part[g * cw + cl] = acc;
      }
      __syncthreads();
      if (has) {
        T wc = T(0);
        for (int k = 0; k < nrg; ++k) wc += part[k * cw + cl];
        wc *= tau;
        for (int r = j + g; r < m; r += nrg)
          col[(size_t)r * ld] = fma(-v[r], wc, col[(size_t)r * ld]);
      }
      __syncthreads();
    }
    // with no trailing column the loop above ran no barrier: v and the
    // diagonal are not read again, so none is needed
  }

  T* r_inst = r_g + inst * (size_t)n * n;
  for (int k = tid; k < n * n; k += nt) {
    const int r = k / n;
    const int c = k - r * n;
    r_inst[k] = (c >= r) ? S[(size_t)r * ld + c] : T(0);
  }
}

size_t vector_bytes(int m, int n, int elem) {
  return (size_t)elem *
         ((size_t)kMaxWarps + (size_t)m + (size_t)part_len(n));
}

size_t shared_bytes(int m, int n, int elem) {
  return vector_bytes(m, n, elem) +
         (size_t)elem * (size_t)m * (size_t)padded_stride(n);
}

int threads_for(int m, int n) {
  return ((size_t)m * n <= 4096) ? 128 : 256;
}

template <typename T>
int launch(const void* M, void* R, void* work, int B, int m, int n,
           int in_shared, void* stream) {
  const size_t smem = in_shared ? shared_bytes(m, n, (int)sizeof(T))
                                : vector_bytes(m, n, (int)sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        house_qr_r_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  house_qr_r_kernel<T><<<B, threads_for(m, n), smem, (cudaStream_t)stream>>>(
      (const T*)M, (T*)R, (T*)work, m, n, in_shared);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory plan for one instance: returns 1 when the (m, n) tile and
// the work vectors fit in the shared memory one block may opt into on
// `device`, 0 when the kernel must work on a device-memory copy and only
// the work vectors go to shared memory; *smem_bytes receives the bytes
// either way. Returns -1 when not even the work vectors fit, and
// -2 - cudaError on a failed query.
int house_qr_r_plan(int m, int n, int elem_bytes, int device,
                    long long* smem_bytes) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -2 - (int)err;
  const size_t need = shared_bytes(m, n, elem_bytes);
  if (need <= (size_t)optin) {
    *smem_bytes = (long long)need;
    return 1;
  }
  const size_t vec = vector_bytes(m, n, elem_bytes);
  if (vec > (size_t)optin) return -1;
  *smem_bytes = (long long)vec;
  return 0;
}

// One launch over a batch of B contiguous (m, n) matrices; R receives B
// contiguous upper (n, n) factors. `work` holds B * m * n elements and is
// used only when in_shared == 0. Returns the cudaError_t of the launch
// (0 on success).
int house_qr_r_f32(const void* M, void* R, void* work, int B, int m, int n,
                   int in_shared, void* stream) {
  return launch<float>(M, R, work, B, m, n, in_shared, stream);
}

int house_qr_r_f64(const void* M, void* R, void* work, int B, int m, int n,
                   int in_shared, void* stream) {
  return launch<double>(M, R, work, B, m, n, in_shared, stream);
}

}  // extern "C"
