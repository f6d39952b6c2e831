// The float64 mma.sync shapes on sm_90a: their fragment layouts, checked
// against A @ B.T with one warp, and their issue rate (six independent
// accumulator chains a warp).  Driven by probes/dmma_shapes.py.
#include <cuda_runtime.h>
#include <cstdint>

template <int S> struct Shape;
template <> struct Shape<0> { static constexpr int M = 8, N = 8, K = 4, NA = 1, NB = 1, NC = 2; };
template <> struct Shape<1> { static constexpr int M = 16, N = 8, K = 4, NA = 2, NB = 1, NC = 4; };
template <> struct Shape<2> { static constexpr int M = 16, N = 8, K = 8, NA = 4, NB = 2, NC = 4; };
template <> struct Shape<3> { static constexpr int M = 16, N = 8, K = 16, NA = 8, NB = 4, NC = 4; };

__device__ __forceinline__ void mma(Shape<0>, double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};"
               : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
}
__device__ __forceinline__ void mma(Shape<1>, double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
__device__ __forceinline__ void mma(Shape<2>, double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void mma(Shape<3>, double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
                 "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// assumed layouts (g = lane/4, t = lane%4):
//  m8n8k4:  a0 (g, t); b0 (k=t, n=g); c (g, 2t+{0,1})
//  m16n8kK: a_i (g + 8*(i%2), t + 4*(i/2)); b_i (k = t + 4i, n = g);
//           c0,c1 (g, 2t+{0,1}), c2,c3 (g+8, 2t+{0,1})
template <int S>
__global__ void layout_kernel(const double* A, const double* B, double* D) {
  using Sh = Shape<S>;
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  double a[8], b[4], c[4] = {0, 0, 0, 0};
  for (int i = 0; i < Sh::NA; ++i) a[i] = A[(g + 8 * (i % 2)) * Sh::K + t + 4 * (i / 2)];
  for (int i = 0; i < Sh::NB; ++i) b[i] = B[g * Sh::K + t + 4 * i];   // B stored [n][k]
  mma(Sh(), c, a, b);
  for (int i = 0; i < Sh::NC; ++i) D[(g + 8 * (i / 2)) * Sh::N + 2 * t + (i % 2)] = c[i];
}

template <int S>
__global__ void rate_kernel(double* out, int iters) {
  using Sh = Shape<S>;
  double a[8], b[4], c[6][4];
  for (int i = 0; i < 8; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < 4; ++i) b[i] = 1e-3 * (i + 1);
  for (int j = 0; j < 6; ++j) for (int i = 0; i < 4; ++i) c[j][i] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 6; ++j) mma(Sh(), c[j], a, b);
  }
  double s = 0;
  for (int j = 0; j < 6; ++j) for (int i = 0; i < 4; ++i) s += c[j][i];
  if (s == 12345.0) out[0] = s;
}

extern "C" {
int probe_layout(int s, const void* A, const void* B, void* D) {
  auto a = (const double*)A; auto b = (const double*)B; auto d = (double*)D;
  if (s == 0) layout_kernel<0><<<1, 32>>>(a, b, d);
  if (s == 1) layout_kernel<1><<<1, 32>>>(a, b, d);
  if (s == 2) layout_kernel<2><<<1, 32>>>(a, b, d);
  if (s == 3) layout_kernel<3><<<1, 32>>>(a, b, d);
  return (int)cudaGetLastError();
}
int probe_rate(int s, void* out, int blocks, int threads, int iters) {
  auto o = (double*)out;
  if (s == 0) rate_kernel<0><<<blocks, threads>>>(o, iters);
  if (s == 1) rate_kernel<1><<<blocks, threads>>>(o, iters);
  if (s == 2) rate_kernel<2><<<blocks, threads>>>(o, iters);
  if (s == 3) rate_kernel<3><<<blocks, threads>>>(o, iters);
  return (int)cudaGetLastError();
}
}
