// Fused ADMM inner epoch for polyhedral (zero + nonneg) cones, Hopper
// (kernel K1, version 2).
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
// m = 120, 50 steps, B = 1024) the work is ~30 flop per byte read, so the
// least time is the CUDA cores' f32 FMA rate (0.0234 ms), not device
// memory. The kernel is far from it for another reason: each instance is a
// chain of 50 dependent steps, each of three dependent reductions, and the
// register file holds the operators of only four instances per SM, so
// B = 1024 runs in two waves, each as long as one SM's four chains.
//
// Version 1 (the shared and device-memory branches below) kept A and Minv
// in shared memory and ran each matvec with one thread per output, a chain
// of up to m dependent FMAs, each behind two loads (generic loads: one
// kernel serves both branches, so the pointers may be shared or global).
// Version 2 adds the register branch, which the launch plan
// (solver/cuda_admm.py::launch_plan) picks wherever the operators fit its
// register budget:
// - A and Minv are read from device memory once and held in registers for
//   the whole epoch. TPI threads serve one instance as TPI / 8 row groups
//   of 8 lanes; lane (tr, tc) owns rows tr*V .. tr*V + V - 1 of A, rows
//   tr*VM .. tr*VM + VM - 1 of Minv and columns tc, tc + 8, ..., tc + 8(CA-1)
//   of both, so a vector value read from shared memory serves V (or VM)
//   FMAs. Every element is owned by exactly one thread; ragged edges are
//   zeros in registers, never a branch on the lane. The box-QP shape takes
//   64 threads an instance in f32 (16 x 7 of A, 8 x 7 of Minv a lane) and
//   128 in f64, where 64 would spill.
// - A xt and Minv rhs reduce across the 8 lanes of a row group by a
//   reduce-scatter of shuffles (offsets 4, 2, 1; each level halves the
//   values a lane carries), so each row's sum lands in a fixed lane, which
//   keeps that row's state (z, y, b, rho, or x, q) in registers for the
//   whole epoch and does the projection. A' t reduces across the row
//   groups: shuffles inside a warp, then one partial per warp through
//   shared memory.
// - A step touches shared memory only for t (written and read inside one
//   row group: a warp barrier), the per-warp partials of A' t, xt and
//   sigma x - q (double-buffered by step parity): two block barriers per
//   step, 16-byte vector loads. y / rho is y * (1 / rho), the reciprocal
//   formed once: the division's instruction sequence sat in every step's
//   chain.
// - Every loop bound is a template constant or uniform over the block, so
//   the shuffles need no collective fix-up. Small programs (TPI < 128) are
//   packed several instances to a 128-thread block, and a lane of a
//   packed block shuffles only inside its own instance.
// When the operators do not fit the register budget, version 1's layouts
// stay: A and Minv staged once in padded shared memory (odd row stride,
// one thread per output row or column), and beyond the shared memory a
// block may use, the same kernel reading them through L1/L2 from device
// memory. Float and double from one template; plain FMA, no tensor cores
// (one vector per instance would fill 1 of an mma tile's 8 columns, and an
// f32-exact split would triple the work), so no TF32. max(d, 0) keeps a
// NaN (relu_nan), as the plain version's clamp.
//
// bench_k1.py times each branch and tile at the path's shapes, the batch
// staircase, register caps, cycles by phase and the SASS; PERF.md records
// what they read.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kVecSlotsN = 4;  // x, xt, rhs, q
constexpr int kVecSlotsM = 5;  // z, y, t, b, rho
constexpr int kMinBlockThreads = 128;  // small tiles pack instances to this

__host__ __device__ inline int padded_stride(int n) { return n | 1; }

template <typename T>
__device__ inline T relu_nan(T d) {
  // max(d, 0) that propagates NaN like the plain version's clamp
  return (d > T(0) || d != d) ? d : T(0);
}

// ------------------------------------------------- version 1 (shared, device)

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

// ------------------------------------------------------ version 2 (register)

// The register tiles compiled in; solver/cuda_admm.py::TILES mirrors the
// first four fields in the same order. TPI threads per instance, V rows of
// A and VM rows of Minv per row group, CA columns per lane, and the
// __launch_bounds__ minimum of blocks per SM for float and for double.
struct Tile {
  int tpi, v, vm, ca, minb32, minb64;
};
constexpr Tile kTiles[] = {
    {64, 16, 8, 7, 2, 1},  // box-QP in f32 (n <= 56, m <= 128)
    {128, 8, 4, 7, 4, 2},  // box-QP in f64: the same shapes, half the rows
    {32, 8, 8, 3, 4, 4},   // simplex (n <= 24, m <= 32)
    {8, 8, 8, 1, 4, 4},    // LAD (n <= 8, m <= 8)
};

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Shared-memory layout of one instance in the register branch, in elements:
// t (row i at i), xt, sigma x - q twice (by step parity), and one partial
// of A' t per warp of the instance. A column vector keeps column j at
// (j % 8) * cap + j / 8, so lane tc reads its CA columns as one run.
template <typename T, int TPI, int V, int CA>
struct RegLayout {
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kTR = TPI / 8;                 // row groups
  static constexpr int kGW = kTR < 4 ? kTR : 4;       // row groups a warp
  static constexpr int kNP = kTR / kGW;               // partials
  static constexpr int kCap = round_up(CA, kVec);
  static constexpr int kCol = 8 * kCap;
  static constexpr int kT = round_up(kTR * V, kVec);
  static constexpr int kXt = kT;
  static constexpr int kC = kXt + kCol;
  static constexpr int kP = kC + 2 * kCol;
  static constexpr int kSize = kP + kNP * kCol;
  static constexpr int kIPB =
      TPI >= kMinBlockThreads ? 1 : kMinBlockThreads / TPI;
  static constexpr int kBlock = TPI * kIPB;
};

// N values from 16-byte aligned shared memory in 16-byte loads
template <typename T, int N>
__device__ __forceinline__ void lds_vec(const T* p, T (&out)[N]) {
  constexpr int kVec = 16 / (int)sizeof(T);
  static_assert(N % kVec == 0, "a whole number of 16-byte loads");
#pragma unroll
  for (int k = 0; k < N; k += kVec) {
    if constexpr (sizeof(T) == 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + k);
      out[k] = f.x;
      out[k + 1] = f.y;
      out[k + 2] = f.z;
      out[k + 3] = f.w;
    } else {
      const double2 d = *reinterpret_cast<const double2*>(p + k);
      out[k] = d.x;
      out[k + 1] = d.y;
    }
  }
}

// Reduce-scatter of CNT values over the 8 lanes of a row group (xor
// offsets OFF = 4, 2, 1). At a level that still carries several values, a
// lane whose OFF bit is set keeps the upper half and sends the lower one;
// once one value is left the level is a plain butterfly. Afterwards lane
// tc holds, for CNT >= 8, the sums of values tc * CNT/8 + r (r < CNT/8) in
// v[r]; for CNT < 8, the sum of value tc / (8 / CNT) in v[0], the same in
// 8 / CNT lanes.
template <int OFF, int CNT, typename T>
__device__ __forceinline__ void reduce_scatter8(T* v, int tc) {
  if constexpr (OFF >= 1) {
    if constexpr (CNT > 1) {
      constexpr int H = CNT / 2;
      const bool up = (tc & OFF) != 0;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const T send = up ? v[k] : v[k + H];
        const T keep = up ? v[k + H] : v[k];
        v[k] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      reduce_scatter8<OFF / 2, H>(v, tc);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      reduce_scatter8<OFF / 2, 1>(v, tc);
    }
  }
}

template <typename T, int TPI, int V, int VM, int CA, int MINB>
__global__ void __launch_bounds__(RegLayout<T, TPI, V, CA>::kBlock, MINB)
admm_epoch_reg_kernel(
    const T* __restrict__ minv_g, const T* __restrict__ a_g,
    const T* __restrict__ q_g, const T* __restrict__ b_g,
    const T* __restrict__ rho_g, const T* __restrict__ x_g,
    const T* __restrict__ z_g, const T* __restrict__ y_g,
    T* __restrict__ x_out, T* __restrict__ z_out, T* __restrict__ y_out,
    int B, int n, int m, int n_zero, int iters, T sigma, T alpha,
    T one_m_alpha) {
  using L = RegLayout<T, TPI, V, CA>;
  constexpr int RPL = V >= 8 ? V / 8 : 1;     // rows of A a lane keeps
  constexpr int DUP = V >= 8 ? 1 : 8 / V;     // lanes holding each such row
  constexpr int KPL = VM >= 8 ? VM / 8 : 1;   // rows of Minv a lane keeps
  constexpr int DUPM = VM >= 8 ? 1 : 8 / VM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int local = threadIdx.x % TPI;
  const int tr = local >> 3;
  const int tc = local & 7;
  const int g = tr % L::kGW;
  const int np = tr / L::kGW;
  const long long inst = (long long)blockIdx.x * L::kIPB + threadIdx.x / TPI;
  const bool live = inst < B;
  T* base = reinterpret_cast<T*>(smem_raw) + (threadIdx.x / TPI) * L::kSize;
  T* t_s = base;
  T* xt_s = base + L::kXt;
  T* c_s = base + L::kC;
  T* p_s = base + L::kP;

  for (int k = local; k < L::kSize; k += TPI) base[k] = T(0);

  // the operators, once, into registers (zeros beyond the edges)
  T a[V][CA];
  T mi[VM][CA];
  {
    const T* ap = a_g + (live ? inst * (long long)m * n : 0);
    const T* mp = minv_g + (live ? inst * (long long)n * n : 0);
#pragma unroll
    for (int s = 0; s < V; ++s) {
      const int i = tr * V + s;
#pragma unroll
      for (int c = 0; c < CA; ++c) {
        const int j = tc + 8 * c;
        a[s][c] = (live && i < m && j < n) ? __ldg(ap + (size_t)i * n + j)
                                           : T(0);
      }
    }
#pragma unroll
    for (int s = 0; s < VM; ++s) {
      const int k = tr * VM + s;
#pragma unroll
      for (int c = 0; c < CA; ++c) {
        const int j = tc + 8 * c;
        mi[s][c] = (live && k < n && j < n) ? __ldg(mp + (size_t)k * n + j)
                                            : T(0);
      }
    }
  }

  // the state of the rows whose sums land in this lane
  T z[RPL], y[RPL], b[RPL], rho[RPL];
  bool eq[RPL], own_row[RPL];
  int row[RPL];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = tr * V + (V >= 8 ? tc * RPL + r : tc / DUP);
    const bool ok = live && i < m;
    const long long at = inst * m + i;
    row[r] = i;
    own_row[r] = ok && (tc % DUP == 0);
    eq[r] = i < n_zero;
    z[r] = ok ? z_g[at] : T(0);
    y[r] = ok ? y_g[at] : T(0);
    b[r] = ok ? b_g[at] : T(0);
    rho[r] = ok ? rho_g[at] : T(1);
  }
  T inv_rho[RPL];  // y / rho as y * (1 / rho): no division in the loop
#pragma unroll
  for (int r = 0; r < RPL; ++r) inv_rho[r] = T(1) / rho[r];
  T x[KPL], q[KPL];
  bool own_col[KPL];
  int col[KPL];
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int k = tr * VM + (VM >= 8 ? tc * KPL + r : tc / DUPM);
    const bool ok = live && k < n;
    const long long at = inst * n + k;
    col[r] = (k & 7) * L::kCap + (k >> 3);
    own_col[r] = ok && (tc % DUPM == 0);
    x[r] = ok ? x_g[at] : T(0);
    q[r] = ok ? q_g[at] : T(0);
  }
  __syncthreads();  // the zeroed layout, before the first writes
#pragma unroll
  for (int r = 0; r < RPL; ++r)
    if (own_row[r]) t_s[row[r]] = rho[r] * z[r] - y[r];
#pragma unroll
  for (int r = 0; r < KPL; ++r)
    if (own_col[r]) c_s[col[r]] = sigma * x[r] - q[r];
  __syncthreads();  // end of staging

  for (int it = 0; it < iters; ++it) {
    const int cur = (it & 1) * L::kCol;
    // A' t over this row group's rows, summed over the warp's row groups
    T acc[CA];
    {
      T tv[V];
      lds_vec<T, V>(t_s + tr * V, tv);
#pragma unroll
      for (int c = 0; c < CA; ++c) acc[c] = T(0);
#pragma unroll
      for (int s = 0; s < V; ++s)
#pragma unroll
        for (int c = 0; c < CA; ++c) acc[c] = fma(a[s][c], tv[s], acc[c]);
    }
#pragma unroll
    for (int off = 8; off < 8 * L::kGW; off <<= 1)
#pragma unroll
      for (int c = 0; c < CA; ++c)
        acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
#pragma unroll
    for (int c = 0; c < CA; ++c)
      if (c % L::kGW == g) p_s[np * L::kCol + tc * L::kCap + c] = acc[c];
    __syncthreads();  // barrier 1: the partials of A' t
    // rhs = (sigma x - q) + the partials; xt = Minv rhs
    T accm[VM];
    {
      T rhs[L::kCap];
      lds_vec<T, L::kCap>(c_s + cur + tc * L::kCap, rhs);
#pragma unroll
      for (int p = 0; p < L::kNP; ++p) {
        T pv[L::kCap];
        lds_vec<T, L::kCap>(p_s + p * L::kCol + tc * L::kCap, pv);
#pragma unroll
        for (int c = 0; c < CA; ++c) rhs[c] += pv[c];
      }
#pragma unroll
      for (int s = 0; s < VM; ++s) {
        T v = T(0);
#pragma unroll
        for (int c = 0; c < CA; ++c) v = fma(mi[s][c], rhs[c], v);
        accm[s] = v;
      }
    }
    reduce_scatter8<4, VM>(accm, tc);
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const T xt = accm[r];
      x[r] = alpha * xt + one_m_alpha * x[r];
      if (own_col[r]) {
        xt_s[col[r]] = xt;
        c_s[(L::kCol - cur) + col[r]] = sigma * x[r] - q[r];
      }
    }
    __syncthreads();  // barrier 2: xt
    // zt = A xt over this lane's columns, reduced over the row group
    T accz[V];
    {
      T xv[L::kCap];
      lds_vec<T, L::kCap>(xt_s + tc * L::kCap, xv);
#pragma unroll
      for (int s = 0; s < V; ++s) {
        T v = T(0);
#pragma unroll
        for (int c = 0; c < CA; ++c) v = fma(a[s][c], xv[c], v);
        accz[s] = v;
      }
    }
    reduce_scatter8<4, V>(accz, tc);
    // relaxed, projected z; dual y; next step's t
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const T w = alpha * accz[r] + one_m_alpha * z[r] + y[r] * inv_rho[r];
      const T zn = eq[r] ? b[r] : b[r] - relu_nan(b[r] - w);
      const T yn = rho[r] * (w - zn);
      z[r] = zn;
      y[r] = yn;
      if (own_row[r]) t_s[row[r]] = rho[r] * zn - yn;
    }
    __syncwarp();  // t is read back only inside this row group
  }

#pragma unroll
  for (int r = 0; r < KPL; ++r)
    if (own_col[r]) {
      const int k = tr * VM + (VM >= 8 ? tc * KPL + r : tc / DUPM);
      x_out[inst * n + k] = x[r];
    }
#pragma unroll
  for (int r = 0; r < RPL; ++r)
    if (own_row[r]) {
      z_out[inst * m + row[r]] = z[r];
      y_out[inst * m + row[r]] = y[r];
    }
}

// branch codes of the C interface
constexpr int kDevice = 0;
constexpr int kShared = 1;
constexpr int kRegister = 2;

// How one plan launches: solver/cuda_admm.py::launch_plan states the same
// numbers, and chip_smoke.py holds the two against each other through
// admm_epoch_geometry.
struct Geometry {
  int threads;    // threads per instance
  int instances;  // instances per block
  size_t smem;    // dynamic shared memory per block, in bytes
};

template <typename T, int I>
bool reg_geometry(int n, int m, Geometry* g) {
  constexpr Tile c = kTiles[I];
  using L = RegLayout<T, c.tpi, c.v, c.ca>;
  if (n > 8 * c.ca || m > L::kTR * c.v || n > L::kTR * c.vm) return false;
  *g = {c.tpi, L::kIPB, sizeof(T) * L::kSize * L::kIPB};
  return true;
}

// The geometry of (branch, tile) at this shape; false for a plan this
// source does not hold (an unknown branch or tile, or a tile too small).
template <typename T>
bool plan_geometry(int branch, int tile, int n, int m, Geometry* g) {
  if (branch == kRegister) {
    switch (tile) {
      case 0: return reg_geometry<T, 0>(n, m, g);
      case 1: return reg_geometry<T, 1>(n, m, g);
      case 2: return reg_geometry<T, 2>(n, m, g);
      case 3: return reg_geometry<T, 3>(n, m, g);
    }
    return false;
  }
  if (branch != kShared && branch != kDevice) return false;
  *g = {threads_for(n, m), 1,
        branch == kShared ? shared_bytes(n, m, (int)sizeof(T)) : 0};
  return true;
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int I>
int launch_reg(const void* minv, const void* A, const void* q, const void* b,
               const void* rho, const void* x, const void* z, const void* y,
               void* x_out, void* z_out, void* y_out, int B, int n, int m,
               int n_zero, int iters, double sigma, double alpha,
               size_t smem, cudaStream_t stream) {
  constexpr Tile c = kTiles[I];
  constexpr int kMinB = sizeof(T) == 4 ? c.minb32 : c.minb64;
  using L = RegLayout<T, c.tpi, c.v, c.ca>;
  auto kernel = admm_epoch_reg_kernel<T, c.tpi, c.v, c.vm, c.ca, kMinB>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  const int blocks = (B + L::kIPB - 1) / L::kIPB;
  kernel<<<blocks, L::kBlock, smem, stream>>>(
      (const T*)minv, (const T*)A, (const T*)q, (const T*)b, (const T*)rho,
      (const T*)x, (const T*)z, (const T*)y, (T*)x_out, (T*)z_out,
      (T*)y_out, B, n, m, n_zero, iters, (T)sigma, (T)alpha,
      (T)(1.0 - alpha));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* minv, const void* A, const void* q, const void* b,
           const void* rho, const void* x, const void* z, const void* y,
           void* x_out, void* z_out, void* y_out, void* work, int B, int n,
           int m, int n_zero, int iters, double sigma, double alpha,
           int branch, int tile, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Geometry g;
  if (!plan_geometry<T>(branch, tile, n, m, &g))
    return (int)cudaErrorInvalidValue;
  if (branch == kRegister) {
    switch (tile) {
#define K1_TILE(I)                                                          \
  case I:                                                                   \
    return launch_reg<T, I>(minv, A, q, b, rho, x, z, y, x_out, z_out,      \
                            y_out, B, n, m, n_zero, iters, sigma, alpha,    \
                            g.smem, st);
      K1_TILE(0)
      K1_TILE(1)
      K1_TILE(2)
      K1_TILE(3)
#undef K1_TILE
    }
    return (int)cudaErrorInvalidValue;
  }
  const int err = allow_smem(admm_polyhedral_epoch_kernel<T>, g.smem);
  if (err) return err;
  admm_polyhedral_epoch_kernel<T><<<B, g.threads, g.smem, st>>>(
      (const T*)minv, (const T*)A, (const T*)q, (const T*)b, (const T*)rho,
      (const T*)x, (const T*)z, (const T*)y, (T*)x_out, (T*)z_out,
      (T*)y_out, (T*)work, n, m, n_zero, iters, (T)sigma, (T)alpha,
      (T)(1.0 - alpha), (int)(branch == kShared));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The shared memory one block may opt into on `device`, in bytes, or
// -1 - cudaError on a failed query.
int admm_epoch_smem_optin(int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? optin : -1 - (int)err;
}

// threads per instance, instances per block and dynamic shared bytes of
// one block (out[0..2]) of the plan (branch, tile) at this shape and word
// size, as the launch below derives them; cudaErrorInvalidValue for a plan
// this source does not hold.
int admm_epoch_geometry(int branch, int tile, int n, int m, int elem_bytes,
                        long long* out) {
  Geometry g;
  const bool ok = elem_bytes == 4
                      ? plan_geometry<float>(branch, tile, n, m, &g)
                      : plan_geometry<double>(branch, tile, n, m, &g);
  if (!ok || (elem_bytes != 4 && elem_bytes != 8))
    return (int)cudaErrorInvalidValue;
  out[0] = g.threads;
  out[1] = g.instances;
  out[2] = (long long)g.smem;
  return 0;
}

// One launch over a batch of B instances, all arrays contiguous with the
// batch axis first, on the plan that solver/cuda_admm.py::launch_plan
// made: `branch` 2 (register; `tile` indexes kTiles), 1 (shared) or 0
// (device memory; `work` holds B * (2n + m) elements). The launch derives
// its threads and shared memory from (branch, tile) and refuses, with
// cudaErrorInvalidValue, a plan this source does not hold. Returns the
// cudaError_t of the launch (0 on success).
int admm_polyhedral_epoch_f32(const void* minv, const void* A, const void* q,
                              const void* b, const void* rho, const void* x,
                              const void* z, const void* y, void* x_out,
                              void* z_out, void* y_out, void* work, int B,
                              int n, int m, int n_zero, int iters,
                              double sigma, double alpha, int branch,
                              int tile, void* stream) {
  return launch<float>(minv, A, q, b, rho, x, z, y, x_out, z_out, y_out, work,
                       B, n, m, n_zero, iters, sigma, alpha, branch, tile,
                       stream);
}

int admm_polyhedral_epoch_f64(const void* minv, const void* A, const void* q,
                              const void* b, const void* rho, const void* x,
                              const void* z, const void* y, void* x_out,
                              void* z_out, void* y_out, void* work, int B,
                              int n, int m, int n_zero, int iters,
                              double sigma, double alpha, int branch,
                              int tile, void* stream) {
  return launch<double>(minv, A, q, b, rho, x, z, y, x_out, z_out, y_out,
                        work, B, n, m, n_zero, iters, sigma, alpha, branch,
                        tile, stream);
}

}  // extern "C"
