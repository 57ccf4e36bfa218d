// Fused ADMM inner epoch for polyhedral (zero + nonneg) cones, Hopper.
//
// Replaces the TPU kernel cvxpylayers_tpu/solver/pallas_admm.py
// (_kernel, launched by polyhedral_inner_epoch). For each instance it runs
// `iters` steps of
//
//   rhs = sigma x - q + A'(rho z - y);  xt = Minv rhs;  zt = A xt
//   x <- alpha xt + (1 - alpha) x;      w = alpha zt + (1 - alpha) z + y / rho
//   z = b on the first n_zero rows, b - max(b - w, 0) on the others
//   y = rho (w - z)
//
// What bounds it on this card: each step is three dependent matvecs (A'
// then Minv then A), 2mn + 2n^2 + 2mn FMAs per instance, against a one-time
// read of A (m x n) and Minv (n x n). At the main-path shape (n = 50,
// m = 120, 50 steps) the work is ~30 flop per byte read, so the launch is
// bound by the CUDA cores' f32 FMA rate, not by device memory.
//
// Design (simple and right first): one thread block per instance, so any
// batch size works. A and Minv are staged into dynamic shared memory once
// and reused by every step; their row stride is padded to an odd number of
// words so the thread-per-row matvecs (A xt, Minv rhs) hit 32 distinct
// banks, while A'(.) reads rows with consecutive threads on consecutive
// columns. The state vectors live in shared memory too, and the block
// loops over the steps with __syncthreads() between the matvecs. Plain FMA
// in the working type (float or double); no tensor cores, so no TF32.
// When A and Minv do not fit in the shared memory a block can use, the
// same kernel reads them from device memory (through L1/L2) and keeps
// the state in the output buffers and a workspace instead.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kVecSlotsN = 4;  // x, xt, rhs, q
constexpr int kVecSlotsM = 5;  // z, y, t, b, rho

__host__ __device__ inline int padded_stride(int n) { return n | 1; }

template <typename T>
__device__ inline T relu_nan(T d) {
  // max(d, 0) that propagates NaN like the plain version's clamp
  return (d > T(0) || d != d) ? d : T(0);
}

template <typename T>
__global__ void __launch_bounds__(256)
admm_polyhedral_epoch_kernel(
    const T* __restrict__ minv_g, const T* __restrict__ a_g,
    const T* __restrict__ q_g, const T* __restrict__ b_g,
    const T* __restrict__ rho_g, const T* __restrict__ x_g,
    const T* __restrict__ z_g, const T* __restrict__ y_g,
    T* __restrict__ x_out, T* __restrict__ z_out, T* __restrict__ y_out,
    T* __restrict__ work_g, int n, int m, int n_zero, int iters, T sigma,
    T alpha, T one_m_alpha, int in_shared) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t inst = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  const T* a_inst = a_g + inst * (size_t)m * n;
  const T* minv_inst = minv_g + inst * (size_t)n * n;
  const T* q_inst = q_g + inst * (size_t)n;
  const T* b_inst = b_g + inst * (size_t)m;
  const T* rho_inst = rho_g + inst * (size_t)m;

  T *x, *xt, *rhs, *z, *y, *t;
  const T *q, *b, *rho, *A, *Mi;
  int lda, ldm;
  if (in_shared) {
    T* s = reinterpret_cast<T*>(smem_raw);
    x = s;
    xt = x + n;
    rhs = xt + n;
    T* q_s = rhs + n;
    z = q_s + n;
    y = z + m;
    t = y + m;
    T* b_s = t + m;
    T* rho_s = b_s + m;
    lda = padded_stride(n);
    ldm = padded_stride(n);
    T* a_s = rho_s + m;
    T* m_s = a_s + (size_t)m * lda;
    for (int k = tid; k < m * n; k += nt) {
      const int i = k / n;
      a_s[i * lda + (k - i * n)] = a_inst[k];
    }
    for (int k = tid; k < n * n; k += nt) {
      const int i = k / n;
      m_s[i * ldm + (k - i * n)] = minv_inst[k];
    }
    for (int j = tid; j < n; j += nt) q_s[j] = q_inst[j];
    for (int i = tid; i < m; i += nt) {
      b_s[i] = b_inst[i];
      rho_s[i] = rho_inst[i];
    }
    q = q_s;
    b = b_s;
    rho = rho_s;
    A = a_s;
    Mi = m_s;
  } else {
    // device-memory branch: the state lives in the output buffers, the
    // temporaries in this instance's slice of the workspace
    x = x_out + inst * (size_t)n;
    z = z_out + inst * (size_t)m;
    y = y_out + inst * (size_t)m;
    T* w = work_g + inst * (size_t)(2 * n + m);
    xt = w;
    rhs = xt + n;
    t = rhs + n;
    q = q_inst;
    b = b_inst;
    rho = rho_inst;
    A = a_inst;
    Mi = minv_inst;
    lda = n;
    ldm = n;
  }

  for (int j = tid; j < n; j += nt) x[j] = x_g[inst * (size_t)n + j];
  for (int i = tid; i < m; i += nt) {
    const T zi = z_g[inst * (size_t)m + i];
    const T yi = y_g[inst * (size_t)m + i];
    z[i] = zi;
    y[i] = yi;
    t[i] = rho_inst[i] * zi - yi;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // rhs = sigma x - q + A' t, t = rho z - y
    for (int j = tid; j < n; j += nt) {
      T acc = T(0);
      for (int i = 0; i < m; ++i) acc = fma(A[(size_t)i * lda + j], t[i], acc);
      rhs[j] = sigma * x[j] - q[j] + acc;
    }
    __syncthreads();
    // xt = Minv rhs; x <- alpha xt + (1 - alpha) x
    for (int k = tid; k < n; k += nt) {
      const T* row = Mi + (size_t)k * ldm;
      T acc = T(0);
      for (int j = 0; j < n; ++j) acc = fma(row[j], rhs[j], acc);
      xt[k] = acc;
      x[k] = alpha * acc + one_m_alpha * x[k];
    }
    __syncthreads();
    // zt = A xt; relaxed, projected z; dual y; next step's t
    for (int i = tid; i < m; i += nt) {
      const T* row = A + (size_t)i * lda;
      T acc = T(0);
      for (int j = 0; j < n; ++j) acc = fma(row[j], xt[j], acc);
      const T ri = rho[i];
      const T bi = b[i];
      const T w = alpha * acc + one_m_alpha * z[i] + y[i] / ri;
      const T zn = (i < n_zero) ? bi : bi - relu_nan(bi - w);
      const T yn = ri * (w - zn);
      z[i] = zn;
      y[i] = yn;
      t[i] = ri * zn - yn;
    }
    __syncthreads();
  }

  if (in_shared) {
    for (int j = tid; j < n; j += nt) x_out[inst * (size_t)n + j] = x[j];
    for (int i = tid; i < m; i += nt) {
      z_out[inst * (size_t)m + i] = z[i];
      y_out[inst * (size_t)m + i] = y[i];
    }
  }
}

size_t vector_bytes(int n, int m, int elem) {
  return (size_t)elem * ((size_t)kVecSlotsN * n + (size_t)kVecSlotsM * m);
}

size_t shared_bytes(int n, int m, int elem) {
  const size_t ld = (size_t)padded_stride(n);
  return vector_bytes(n, m, elem) + (size_t)elem * ((size_t)m * ld + (size_t)n * ld);
}

int threads_for(int n, int m) {
  const int widest = n > m ? n : m;
  if (widest <= 128) return 128;
  return 256;
}

template <typename T>
int launch(const void* minv, const void* A, const void* q, const void* b,
           const void* rho, const void* x, const void* z, const void* y,
           void* x_out, void* z_out, void* y_out, void* work, int B, int n,
           int m, int n_zero, int iters, double sigma, double alpha,
           int in_shared, void* stream) {
  const size_t smem = in_shared ? shared_bytes(n, m, (int)sizeof(T)) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        admm_polyhedral_epoch_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  admm_polyhedral_epoch_kernel<T>
      <<<B, threads_for(n, m), smem, (cudaStream_t)stream>>>(
          (const T*)minv, (const T*)A, (const T*)q, (const T*)b,
          (const T*)rho, (const T*)x, (const T*)z, (const T*)y, (T*)x_out,
          (T*)z_out, (T*)y_out, (T*)work, n, m, n_zero, iters, (T)sigma,
          (T)alpha, (T)(1.0 - alpha), in_shared);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory plan for one instance: returns 1 when A, Minv and the
// state fit in the shared memory one block may opt into on `device`
// (writing the bytes to *smem_bytes), 0 when the kernel must take its
// device-memory branch, and -1 - cudaError on a failed query.
int admm_polyhedral_epoch_plan(int n, int m, int elem_bytes, int device,
                               long long* smem_bytes) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -1 - (int)err;
  const size_t need = shared_bytes(n, m, elem_bytes);
  if (need <= (size_t)optin) {
    *smem_bytes = (long long)need;
    return 1;
  }
  *smem_bytes = 0;
  return 0;
}

// One launch over a batch of B instances, all arrays contiguous with the
// batch axis first. `work` holds B * (2n + m) elements and is used only by
// the device-memory branch (in_shared == 0). Returns the cudaError_t of the
// launch (0 on success).
int admm_polyhedral_epoch_f32(const void* minv, const void* A, const void* q,
                              const void* b, const void* rho, const void* x,
                              const void* z, const void* y, void* x_out,
                              void* z_out, void* y_out, void* work, int B,
                              int n, int m, int n_zero, int iters,
                              double sigma, double alpha, int in_shared,
                              void* stream) {
  return launch<float>(minv, A, q, b, rho, x, z, y, x_out, z_out, y_out, work,
                       B, n, m, n_zero, iters, sigma, alpha, in_shared,
                       stream);
}

int admm_polyhedral_epoch_f64(const void* minv, const void* A, const void* q,
                              const void* b, const void* rho, const void* x,
                              const void* z, const void* y, void* x_out,
                              void* z_out, void* y_out, void* work, int B,
                              int n, int m, int n_zero, int iters,
                              double sigma, double alpha, int in_shared,
                              void* stream) {
  return launch<double>(minv, A, q, b, rho, x, z, y, x_out, z_out, y_out,
                        work, B, n, m, n_zero, iters, sigma, alpha, in_shared,
                        stream);
}

}  // extern "C"
