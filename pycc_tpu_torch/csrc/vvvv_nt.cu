// vvvv_nt: C[m, n] = sum_k A[m, k] * B[n, k]  (C = A * B^T), both operands
// contiguous along k.  The particle-particle ladder of CCSD/CCD,
// r2_ijab += 1/2 tau_ijef <ab|ef>, with A = tau as an (o^2, v^2) matrix and
// B = <ab|ef> as a (v^2, v^2) matrix.
//
// Replaces the TPU kernel K1, pycc_tpu/ops/kernels/vvvv.py::vvvv_pallas
// (body `_kernel`).  That kernel walked a sequential k axis of its grid and
// carried an f32 accumulator in scratch memory from one grid step to the
// next.  Blocks on this card run in parallel and in no order, so here each
// block owns one BM x BN tile of C and runs the whole k loop itself, with the
// accumulators in registers.  Ragged M, N and K are masked in the loads and
// the store instead of being asserted away.
//
// What bounds it: at (H2O)_6/cc-pVDZ, (no, nv) = (24, 114), the product is
// (576 x 12996) * (12996 x 12996)^T: 2*M*N*K = 1.9e11 flop against the
// 1.35 GB of B in float64, about 140 flop/byte, so it is compute-bound.
// This first version is a plain shared-memory tiled GEMM on the CUDA cores:
// BM x BN = 64 x 64 tiles, a k step of 16, a 4 x 4 register tile per
// thread, one k tile staged through shared memory at a time.  The FP64
// tensor cores (DMMA), wgmma and TMA-fed multi-stage pipelines are later
// work.
//
// Three instantiations, one C entry point each:
//   vvvv_nt_f64   float64 in, float64 accumulate, float64 out (DP path)
//   vvvv_nt_f32   float32 in, float32 accumulate, float32 out (SP path)
//   vvvv_nt_bf16  bfloat16 in, float32 accumulate, float32 out (the
//                 Pallas kernel's bf16=True mode)
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int ROW_GROUPS = BM / TM;            // 16 thread rows
constexpr int COL_GROUPS = BN / TN;            // 16 thread columns
constexpr int THREADS = ROW_GROUPS * COL_GROUPS;  // 256
constexpr int LOAD_ROWS = THREADS / BK;        // tile rows loaded per pass

static_assert(BM == BN, "one loader mapping serves both tiles");
static_assert(BM % LOAD_ROWS == 0, "loader passes must tile BM");

__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename Tin, typename Tacc, typename Tout>
__global__ void __launch_bounds__(THREADS)
    vvvv_nt_kernel(const Tin* __restrict__ A, const Tin* __restrict__ B,
                   Tout* __restrict__ C, int M, int N, int K) {
  // k-major tiles: the compute loop reads a row of As/Bs across threads.
  // The +1 column staggers the loader's stores across banks.
  __shared__ Tacc As[BK][BM + 1];
  __shared__ Tacc Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % COL_GROUPS;
  const int ty = tid / COL_GROUPS;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  // loader: 16 consecutive threads read 16 consecutive k of one row
  const int lk = tid % BK;
  const int lr = tid / BK;

  Tacc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Tacc(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int k = k0 + lk;
    const bool k_in = k < K;
#pragma unroll
    for (int p = 0; p < BM / LOAD_ROWS; ++p) {
      const int r = lr + p * LOAD_ROWS;
      const int m = m0 + r;
      const int n = n0 + r;
      As[lk][r] = (k_in && m < M) ? to_acc(A[int64_t(m) * K + k]) : Tacc(0);
      Bs[lk][r] = (k_in && n < N) ? to_acc(B[int64_t(n) * K + k]) : Tacc(0);
    }
    __syncthreads();
    // one k tile sums into `part` before it joins `acc`: the running sum
    // takes K/BK roundings instead of K, which keeps the float32 result
    // close to a blocked-summation GEMM at K ~ 1e4
    Tacc part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = Tacc(0);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      Tacc a[TM];
      Tacc b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * ROW_GROUPS];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * COL_GROUPS];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fma(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * ROW_GROUPS;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * COL_GROUPS;
      if (n < N) C[int64_t(m) * N + n] = static_cast<Tout>(acc[i][j]);
    }
  }
}

template <typename Tin, typename Tacc, typename Tout>
int launch(const void* A, const void* B, void* C, int M, int N, int K,
           void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  vvvv_nt_kernel<Tin, Tacc, Tout><<<grid, THREADS, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Tin*>(A), static_cast<const Tin*>(B),
      static_cast<Tout*>(C), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int vvvv_nt_f64(const void* A, const void* B, void* C, int M, int N, int K,
                void* stream) {
  return launch<double, double, double>(A, B, C, M, N, K, stream);
}

int vvvv_nt_f32(const void* A, const void* B, void* C, int M, int N, int K,
                void* stream) {
  return launch<float, float, float>(A, B, C, M, N, K, stream);
}

int vvvv_nt_bf16(const void* A, const void* B, void* C, int M, int N, int K,
                 void* stream) {
  return launch<__nv_bfloat16, float, float>(A, B, C, M, N, K, stream);
}

const char* vvvv_nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
