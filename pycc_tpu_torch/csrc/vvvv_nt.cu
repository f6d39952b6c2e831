// vvvv_nt: C[m, n] = sum_k A[m, k] * B[n, k]  (C = A * B^T), both operands
// contiguous along k.  The particle-particle ladder of CCSD/CCD,
// r2_ijab += 1/2 tau_ijef <ab|ef>, with A = tau as an (o^2, v^2) matrix and
// B = <ab|ef> as a (v^2, v^2) matrix.
//
// Replaces the TPU kernel K1, pycc_tpu/ops/kernels/vvvv.py::vvvv_pallas
// (body `_kernel`).  That kernel walked a sequential k axis of its grid and
// carried an f32 accumulator in scratch memory from one grid step to the
// next.  Blocks on this card run in parallel and in no order, so here each
// block owns one output tile of C and runs the whole k loop itself, with
// the accumulators in registers.  Ragged M, N and K are masked (zero-filled
// copies, masked stores) instead of being asserted away.
//
// What bounds it: at (H2O)_6/cc-pVDZ, (no, nv) = (24, 114), the product is
// (576 x 12996) * (12996 x 12996)^T: 2*M*N*K = 1.95e11 flop against the
// 1.35 GB of B in float64, about 140 flop/byte, so it is compute-bound:
// 2.9 ms at the FP64 tensor cores' 67 TFLOP/s.  The design:
//   - float64 runs on the FP64 tensor cores, mma.sync.m16n8k8 .f64 (DMMA;
//     the m8n8k4 shape issues at half the rate on this card).  A 64 x 128
//     block tile, eight warps of 32 x 32;
//   - operands stream through a ring of shared-memory stages filled with
//     cp.async, so the copies of the next k tiles overlap the products.
//     Rows are padded by 4 elements so that the fragment loads of one
//     half-warp hit distinct banks;
//   - the grid puts the M tiles fastest (blockIdx.x).  M = o^2 is only a
//     few tiles, so the blocks that share a B panel run together and B
//     leaves device memory about once (with N fastest, every M tile
//     streamed all of B again: 9 x 1.35 GB at (H2O)_6);
//   - float32 has no tensor-core path at its tolerance (TF32 keeps ~3
//     digits), so it runs on the CUDA cores: a 128 x 128 block tile, an
//     8 x 8 register tile a thread, vector loads along k; each 16-deep k
//     tile is summed apart before it joins the accumulator, which keeps
//     the float32 result close to a blocked-summation GEMM at K ~ 1e4;
//   - bf16 -> f32 runs mma.sync.m16n8k16 bf16 with f32 accumulation,
//     fed by ldmatrix, on the same ring.  wgmma and TMA are later work.
//   - 16-byte copies need 16-byte aligned rows.  The caller passes the
//     widest copy that K and the pointers allow (16, 8, 4 bytes, or 2 for
//     bf16 rows with odd K, which go through registers).
//
// Three entry points, one per type:
//   vvvv_nt_f64   float64 in, float64 accumulate, float64 out (DP path)
//   vvvv_nt_f32   float32 in, float32 accumulate, float32 out (SP path)
//   vvvv_nt_bf16  bfloat16 in, float32 accumulate, float32 out (the
//                 Pallas kernel's bf16=True mode)
// Each launches on the given stream, does not synchronise, and returns a
// cudaError_t (0 on success) so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// BYTES bytes from global src to shared dst, zero-filled when !valid.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool valid) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  } else if constexpr (BYTES == 8 || BYTES == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0));
  } else {
    static_assert(BYTES == 2, "copies are 2, 4, 8 or 16 bytes");
    // below cp.async's smallest size: staged through a register
    *static_cast<unsigned short*>(dst) =
        valid ? *static_cast<const unsigned short*>(src) : 0;
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [r0, r0 + ROWS) x k [k0, k0 + BK) of the (R, K) row-major
// matrix g into s (row pitch PITCH elements), BYTES per copy.  The chunk
// is all in or all out of range, because BYTES divides K * sizeof(T).
template <typename T, int ROWS, int BK, int PITCH, int BYTES, int THREADS>
__device__ __forceinline__ void load_tile(T* s, const T* __restrict__ g,
                                          int r0, int R, int k0, int K) {
  constexpr int E = BYTES / int(sizeof(T));
  constexpr int PER_ROW = BK / E;
  constexpr int TOTAL = ROWS * PER_ROW;
  static_assert(TOTAL % THREADS == 0, "threads must tile the stage");
#pragma unroll
  for (int p = 0; p < TOTAL / THREADS; ++p) {
    const int idx = threadIdx.x + p * THREADS;
    const int r = idx / PER_ROW;
    const int kk = (idx % PER_ROW) * E;
    const bool valid = r0 + r < R && k0 + kk < K;
    const T* src = valid ? g + int64_t(r0 + r) * K + k0 + kk : g;
    copy_async<BYTES>(s + r * PITCH + kk, src, valid);
  }
}

// The k loop shared by the three kernels: a ring of STAGES stages, each
// holding an A tile (BM rows) and a B tile (BN rows); compute(As, Bs) runs
// on one stage while the next STAGES - 1 are in flight.
template <typename T, int BM, int BN, int BK, int P, int STAGES, int BYTES,
          int THREADS, typename F>
__device__ __forceinline__ void k_loop(T* sm, const T* __restrict__ A,
                                       const T* __restrict__ B, int m0,
                                       int n0, int M, int N, int K,
                                       F&& compute) {
  constexpr int STAGE = (BM + BN) * P;
  const int KT = (K + BK - 1) / BK;
  auto load = [&](int kt) {
    T* s = sm + (kt % STAGES) * STAGE;
    load_tile<T, BM, BK, P, BYTES, THREADS>(s, A, m0, M, kt * BK, K);
    load_tile<T, BN, BK, P, BYTES, THREADS>(s + BM * P, B, n0, N, kt * BK, K);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    // the stage computed in step kt - 1 is free: every thread has passed
    // the barrier above since
    if (kt + STAGES - 1 < KT) load(kt + STAGES - 1);
    cp_commit();
    const T* As = sm + (kt % STAGES) * STAGE;
    compute(As, As + BM * P);
  }
}

// ---- float64: DMMA m16n8k8 --------------------------------------------
// fragments (g = lane / 4, t = lane % 4):
//   A 16 x 8:  a[r] = A[g + 8 (r % 2)][t + 4 (r / 2)]
//   B 8 x 8:   b[r] = B[k = t + 4 r][n = g]
//   C 16 x 8:  c[r] = C[g + 8 (r / 2)][2 t + r % 2]
namespace f64 {
constexpr int BM = 64, BN = 128, BK = 16, P = BK + 4, STAGES = 3;
constexpr int THREADS = 256;
constexpr size_t SMEM = size_t(STAGES) * (BM + BN) * P * sizeof(double);

__device__ __forceinline__ void mma(double (&c)[4], const double (&a)[4],
                                    const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

template <int BYTES>
__global__ void __launch_bounds__(THREADS)
    kernel(const double* __restrict__ A, const double* __restrict__ B,
           double* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* sm = reinterpret_cast<double*>(smem_raw);
  const int m0 = blockIdx.x * BM;   // M tiles fastest: see the header
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp % 2) * 32, wn = (warp / 2) * 32;
  double acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0;

  k_loop<double, BM, BN, BK, P, STAGES, BYTES, THREADS>(
      sm, A, B, m0, n0, M, N, K, [&](const double* As, const double* Bs) {
#pragma unroll
        for (int k8 = 0; k8 < BK; k8 += 8) {
          double a[2][4], b[4][2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              a[i][r] = As[(wm + i * 16 + g + 8 * (r % 2)) * P + k8 + t +
                           4 * (r / 2)];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              b[j][r] = Bs[(wn + j * 8 + g) * P + k8 + t + 4 * r];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma(acc[i][j], a[i], b[j]);
        }
      });

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + i * 16 + g + 8 * (r / 2);
        const int n = n0 + wn + j * 8 + 2 * t + r % 2;
        if (m < M && n < N) C[int64_t(m) * N + n] = acc[i][j][r];
      }
}
}  // namespace f64

// ---- float32: CUDA cores, 8 x 8 register tile a thread -------------------
namespace f32 {
constexpr int BM = 128, BN = 128, BK = 16, P = BK + 4, STAGES = 3;
constexpr int THREADS = 256;
constexpr size_t SMEM = size_t(STAGES) * (BM + BN) * P * sizeof(float);

template <int BYTES>
__global__ void __launch_bounds__(THREADS)
    kernel(const float* __restrict__ A, const float* __restrict__ B,
           float* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  // thread rows ty + 16 i, columns tx + 16 j: the 8 lanes of a quarter
  // warp read 8 B rows 80 bytes apart (distinct banks) and one A row
  // (a broadcast)
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  k_loop<float, BM, BN, BK, P, STAGES, BYTES, THREADS>(
      sm, A, B, m0, n0, M, N, K, [&](const float* As, const float* Bs) {
        float part[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
#pragma unroll
        for (int k4 = 0; k4 < BK; k4 += 4) {
          float4 b[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            b[j] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * P +
                                                    k4);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 a = *reinterpret_cast<const float4*>(
                As + (ty + 16 * i) * P + k4);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              float s = part[i][j];
              s = fmaf(a.x, b[j].x, s);
              s = fmaf(a.y, b[j].y, s);
              s = fmaf(a.z, b[j].z, s);
              part[i][j] = fmaf(a.w, b[j].w, s);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
      });

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) C[int64_t(m) * N + n] = acc[i][j];
    }
  }
}
}  // namespace f32

// ---- bf16 -> f32: mma m16n8k16 bf16, fed by ldmatrix --------------------
// fragments (g = lane / 4, t = lane % 4), two bf16 to a register:
//   A 16 x 16: a0 (g, 2t..), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
//              a3 (g + 8, 2t + 8..)
//   B 16 x 8:  b0 (k = 2t.., n = g), b1 (k = 2t + 8.., n = g)
//   C 16 x 8:  c[r] = C[g + 8 (r / 2)][2 t + r % 2]
namespace bf16 {
constexpr int BM = 64, BN = 128, BK = 32, P = BK + 8, STAGES = 4;
constexpr int THREADS = 256;
constexpr size_t SMEM =
    size_t(STAGES) * (BM + BN) * P * sizeof(__nv_bfloat16);

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BYTES>
__global__ void __launch_bounds__(THREADS)
    kernel(const __nv_bfloat16* __restrict__ A,
           const __nv_bfloat16* __restrict__ B, float* __restrict__ C, int M,
           int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp % 2) * 32, wn = (warp / 2) * 32;
  // ldmatrix row addresses: A rows lane % 16, k half lane / 16; B rows
  // lane % 8 (+ 8 for lanes 16-31), k half (lane / 8) % 2
  const int a_row = lane % 16, a_k = (lane / 16) * 8;
  const int b_row = lane % 8 + (lane / 16) * 8, b_k = ((lane / 8) % 2) * 8;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  k_loop<__nv_bfloat16, BM, BN, BK, P, STAGES, BYTES, THREADS>(
      sm, A, B, m0, n0, M, N, K,
      [&](const __nv_bfloat16* As, const __nv_bfloat16* Bs) {
#pragma unroll
        for (int k16 = 0; k16 < BK; k16 += 16) {
          unsigned a[2][4], b[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            ldmatrix_x4(a[i], As + (wm + i * 16 + a_row) * P + k16 + a_k);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            ldmatrix_x4(b[j], Bs + (wn + j * 16 + b_row) * P + k16 + b_k);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma(acc[i][j], a[i], b[j / 2][2 * (j % 2)],
                  b[j / 2][2 * (j % 2) + 1]);
        }
      });

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + i * 16 + g + 8 * (r / 2);
        const int n = n0 + wn + j * 8 + 2 * t + r % 2;
        if (m < M && n < N) C[int64_t(m) * N + n] = acc[i][j][r];
      }
}
}  // namespace bf16

template <typename Tin, typename Tout, int BM, int BN, int THREADS>
int launch(void (*kern)(const Tin*, const Tin*, Tout*, int, int, int),
           size_t smem, const void* A, const void* B, void* C, int M, int N,
           int K, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Tin*>(A), static_cast<const Tin*>(B),
      static_cast<Tout*>(C), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

#define VVVV_LAUNCH(NS, TIN, TOUT, BYTES)                                    \
  launch<TIN, TOUT, NS::BM, NS::BN, NS::THREADS>(                           \
      NS::kernel<BYTES>, NS::SMEM, A, B, C, M, N, K, stream)

}  // namespace

extern "C" {

// copy_bytes: the widest copy that K * sizeof(element) and both operand
// pointers are aligned to (16 or 8 for float64; 16, 8 or 4 for float32;
// 16, 8, 4 or 2 for bfloat16)

int vvvv_nt_f64(const void* A, const void* B, void* C, int M, int N, int K,
                int copy_bytes, void* stream) {
  switch (copy_bytes) {
    case 16: return VVVV_LAUNCH(f64, double, double, 16);
    case 8: return VVVV_LAUNCH(f64, double, double, 8);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int vvvv_nt_f32(const void* A, const void* B, void* C, int M, int N, int K,
                int copy_bytes, void* stream) {
  switch (copy_bytes) {
    case 16: return VVVV_LAUNCH(f32, float, float, 16);
    case 8: return VVVV_LAUNCH(f32, float, float, 8);
    case 4: return VVVV_LAUNCH(f32, float, float, 4);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int vvvv_nt_bf16(const void* A, const void* B, void* C, int M, int N, int K,
                 int copy_bytes, void* stream) {
  switch (copy_bytes) {
    case 16: return VVVV_LAUNCH(bf16, __nv_bfloat16, float, 16);
    case 8: return VVVV_LAUNCH(bf16, __nv_bfloat16, float, 8);
    case 4: return VVVV_LAUNCH(bf16, __nv_bfloat16, float, 4);
    case 2: return VVVV_LAUNCH(bf16, __nv_bfloat16, float, 2);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* vvvv_nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
