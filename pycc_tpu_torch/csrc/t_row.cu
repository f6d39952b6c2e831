// t_row: the seven (T) energy projections of one occupied row i.
//
// For each (j, k) the connected triples amplitude t3[i,j,k] over (a, b, c)
// is built from twelve contractions (six Wvvvo x t2 terms over a virtual
// index e, six Wovoo x t2 terms over an occupied index m) and divided by
// eps_i + eps_j + eps_k - eps_a - eps_b - eps_c.  The energy needs only
// projections of t3, summed over k:
//
//   X1a[j,a]     = sum_kbc t3[k,a,b,c] L[j,k,b,c]
//   X1m[j,c]     = sum_kab t3[k,a,b,c] L[j,k,b,a]
//   Z1[j,a,d]    = sum_kbc t3[k,a,b,c] (2 Ev[d,k,b,c] - Ev[d,k,c,b])
//   Z1m[j,c,d]   = sum_kab t3[k,a,b,c] Ev[d,k,b,a]
//   Z2a[j,a,b]   = sum_kc  t3[k,a,b,c] Fov[k,c]
//   Z2m[j,b,c]   = sum_ka  t3[k,a,b,c] Fov[k,a]
//   X2l[j,l,a,b] = sum_kc (2 t3[k,a,b,c] - t3[k,a,c,b] - t3[k,c,b,a])
//                  Eo[j,k,l,c]
//
// with the operand layouts of pycc_tpu's slab scan: Wv = Wvvvo_o (o,v,v,v),
// Ot = Wovoo_t (o,o,o,v), Ev = Evovv (v,o,v,v), Eo = Eooov (o,o,o,v),
// L = Loovv (o,o,v,v), Fov (o,v), eps (o+v), t2 (o,o,v,v).  T3 itself never
// reaches device memory: each tile lives in shared memory only.
//
// Replaces the TPU kernel K2, pycc_tpu/ops/kernels/triples.py::
// t_energy_row_pallas (body `_t_row_kernel`).  That kernel held a whole
// (v, v, v) cube of t3 in the TPU's ~128 MB of VMEM per grid cell, walked a
// sequential (j, k) grid and carried its sums from one grid step to the
// next.  Here:
//   - a block owns one 8 x 8 x 8 tile of (a, b, c) for one j, and runs the
//     k loop itself; the tile is 4 KB in float64, not the 11.9 MB cube;
//   - the projections of the (ac) and (bc) images (X1m, Z1m, Z2m and two of
//     the three X2l terms) are formed from the same tile by relabelling, as
//     in the Pallas kernel, so t3 is built once per element.  Those outputs
//     land at indices that other blocks also reach, so every block sums
//     over k in shared memory and adds its totals once, with atomicAdd,
//     into outputs that the caller zeroes;
//   - ragged a, b, c (v = 19, 114) are masked in the loads; nothing has to
//     divide anything.
//
// What bounds it: at (H2O)_6/cc-pVDZ, (no, nv) = (24, 114), one row builds
// o^2 v^3 = 8.5e8 t3 elements at 6 (v + o) = 828 FMA each (1.4e12 flop)
// and spends 3 (v + o) FMA more on the projections (0.4e12 flop).  The
// build runs each contraction as a small product staged through shared
// memory in chunks of 16 along e (or m): a 64-row slice of the pair
// operand (Wv[n][p1][p2][:] or t2[n][:][p1][p2]) and an 8-row slice of the
// single operand, every block re-reading them from L2.  Each FMA takes
// one or two shared-memory reads, so the inner loop is bound by shared-
// memory bandwidth at a fraction of the card's float64 FMA rate, and the
// Ev reads of the Z1 projections come from L2.  The FP64/bf16 tensor cores
// (mma/wgmma tiles), the pair symmetry t3[j,i,k]^{abc} = t3[i,j,k]^{bac}
// (which halves the build) and larger register tiles are later work.
//
// Three instantiations, one C entry point each:
//   t_row_f64   float64 operands, float64 tile and outputs (DP path)
//   t_row_f32   float32 operands, float32 tile and outputs (SP path)
//   t_row_bf16  bfloat16 operands, float32 tile and outputs (the Pallas
//               kernel's stream_dtype=bfloat16 mode)
// Fov and eps come in the tile's type.  Each launches on the given stream,
// does not synchronise, and returns a cudaError_t (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int T = 8;                 // tile edge along a, b and c
constexpr int T2 = T * T;
constexpr int T3 = T * T * T;
constexpr int THREADS = 128;
constexpr int PER_THREAD = T3 / THREADS;   // 4 consecutive c of one (a, b)
constexpr int BE = 16;               // contraction chunk in shared memory

static_assert(T3 % THREADS == 0, "threads must tile the t3 tile");
static_assert(T % PER_THREAD == 0, "a thread's c run stays in one row");

__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// axis 0, 1, 2 = a, b, c
template <int AX>
__device__ __forceinline__ int pick(int a, int b, int c) {
  return AX == 0 ? a : (AX == 1 ? b : c);
}

// Shared-memory layout, in elements of the tile type.  The host computes
// the same size through t_row_smem_bytes.
struct Layout {
  int ps, pr, sg, eo, fo, lbc, lba, x1a, x1m, z2a, z2m, z1, z1m, x2a, x2b,
      x2c, total;
  __host__ __device__ Layout(int no, int nv) {
    int o = 0;
    ps = o;  o += T3;           // the t3 tile, [a][b][c]
    pr = o;  o += BE * T2;      // pair operand chunk, [e][p1 * T + p2]
    sg = o;  o += BE * T;       // single operand chunk, [e][s]
    eo = o;  o += 3 * no * T;   // Eo[j,k,l,x] for x on the a, b, c ranges
    fo = o;  o += 3 * T;        // Fov[k, x] on the a, b, c ranges
    lbc = o; o += T2;           // L[j,k,b,c]
    lba = o; o += T2;           // L[j,k,b,a]
    x1a = o; o += T;            // the block's sums over k ...
    x1m = o; o += T;
    z2a = o; o += T2;
    z2m = o; o += T2;
    z1 = o;  o += T * nv;
    z1m = o; o += T * nv;
    x2a = o; o += no * T2;      // X2l[j,l,a,b] +=
    x2b = o; o += no * T2;      // X2l[j,l,a,c] +=
    x2c = o; o += no * T2;      // X2l[j,l,c,b] +=
    total = o;
  }
};

// One contraction of the t3 build, added into the thread's four outputs:
//   acc(a,b,c) += sign * sum_e pair[p1][p2][e] * single[s][e]
// where p1, p2 and s are the tile axes AX1, AX2 and AXS.  The pair operand
// sits at pb + p1*ps1 + p2*ps2 + e*pse, the single one at sb + s*ss + e*sse,
// and e runs over [0, K).
template <int AX1, int AX2, int AXS, typename Tin, typename Tacc>
__device__ __forceinline__ void term(
    Tacc (&acc)[PER_THREAD], Tacc* Pr, Tacc* Sg, Tacc sign,
    const Tin* __restrict__ pb, int64_t ps1, int64_t ps2, int64_t pse,
    const Tin* __restrict__ sb, int64_t ss, int64_t sse, int K, int nv,
    int a0, int b0, int c0, int al, int bl, int cb) {
  const int tid = threadIdx.x;
  const int p1s = pick<AX1>(a0, b0, c0);
  const int p2s = pick<AX2>(a0, b0, c0);
  const int ssx = pick<AXS>(a0, b0, c0);
  for (int e0 = 0; e0 < K; e0 += BE) {
    for (int idx = tid; idx < T2 * BE; idx += THREADS) {
      const int el = idx % BE;
      const int p = idx / BE;
      const int p1 = p1s + p / T;
      const int p2 = p2s + p % T;
      const int e = e0 + el;
      Tacc val = Tacc(0);
      if (p1 < nv && p2 < nv && e < K)
        val = to_acc(pb[p1 * ps1 + p2 * ps2 + e * pse]);
      Pr[el * T2 + p] = val;
    }
    for (int idx = tid; idx < T * BE; idx += THREADS) {
      const int el = idx % BE;
      const int s = idx / BE;
      const int sx = ssx + s;
      const int e = e0 + el;
      Tacc val = Tacc(0);
      if (sx < nv && e < K) val = sign * to_acc(sb[sx * ss + e * sse]);
      Sg[el * T + s] = val;
    }
    __syncthreads();
#pragma unroll
    for (int el = 0; el < BE; ++el) {
#pragma unroll
      for (int q = 0; q < PER_THREAD; ++q) {
        const int cl = cb + q;
        const Tacc x = Pr[el * T2 + pick<AX1>(al, bl, cl) * T +
                          pick<AX2>(al, bl, cl)];
        const Tacc y = Sg[el * T + pick<AXS>(al, bl, cl)];
        acc[q] = fma(x, y, acc[q]);
      }
    }
    __syncthreads();
  }
}

template <typename Tin, typename Tacc>
__global__ void __launch_bounds__(THREADS) t_row_kernel(
    int i, const Tin* __restrict__ Wv, const Tin* __restrict__ Ot,
    const Tin* __restrict__ Ev, const Tin* __restrict__ Eo,
    const Tin* __restrict__ L, const Tacc* __restrict__ Fov,
    const Tacc* __restrict__ eps, const Tin* __restrict__ t2,
    Tacc* __restrict__ X1a, Tacc* __restrict__ X1m, Tacc* __restrict__ Z1,
    Tacc* __restrict__ Z1m, Tacc* __restrict__ Z2a, Tacc* __restrict__ Z2m,
    Tacc* __restrict__ X2l, int no, int nv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tacc* sm = reinterpret_cast<Tacc*>(smem_raw);
  const Layout lay(no, nv);
  Tacc* Ps = sm + lay.ps;
  Tacc* Pr = sm + lay.pr;
  Tacc* Sg = sm + lay.sg;
  Tacc* EoS = sm + lay.eo;
  Tacc* FoS = sm + lay.fo;
  Tacc* Lbc = sm + lay.lbc;
  Tacc* Lba = sm + lay.lba;
  Tacc* sX1a = sm + lay.x1a;
  Tacc* sX1m = sm + lay.x1m;
  Tacc* sZ2a = sm + lay.z2a;
  Tacc* sZ2m = sm + lay.z2m;
  Tacc* sZ1 = sm + lay.z1;
  Tacc* sZ1m = sm + lay.z1m;
  Tacc* sXa = sm + lay.x2a;
  Tacc* sXb = sm + lay.x2b;
  Tacc* sXc = sm + lay.x2c;

  const int tid = threadIdx.x;
  const int nt = (nv + T - 1) / T;
  const int tile = blockIdx.x;
  const int j = blockIdx.y;
  const int a0 = (tile / (nt * nt)) * T;
  const int b0 = ((tile / nt) % nt) * T;
  const int c0 = (tile % nt) * T;
  // the thread's outputs in the build: (al, bl, cb .. cb + 3)
  const int al = (tid / (T / PER_THREAD)) / T;
  const int bl = (tid / (T / PER_THREAD)) % T;
  const int cb = (tid % (T / PER_THREAD)) * PER_THREAD;

  for (int x = tid; x < lay.total - lay.x1a; x += THREADS)
    sm[lay.x1a + x] = Tacc(0);

  const int64_t V = nv;
  const int64_t O = no;
  const int64_t V2 = V * V;
  const int64_t V3 = V2 * V;
  const Tin* t2ij = t2 + (int64_t(i) * O + j) * V2;
  const Tin* t2ji = t2 + (int64_t(j) * O + i) * V2;
  const Tin* Oij = Ot + (int64_t(i) * O + j) * O * V;
  const Tin* Oji = Ot + (int64_t(j) * O + i) * O * V;
  const Tacc eij = eps[i] + eps[j];

  for (int k = 0; k < no; ++k) {
    const Tin* t2kj = t2 + (int64_t(k) * O + j) * V2;
    const Tin* t2jk = t2 + (int64_t(j) * O + k) * V2;
    const Tin* t2ik = t2 + (int64_t(i) * O + k) * V2;
    const Tin* t2ki = t2 + (int64_t(k) * O + i) * V2;
    const Tin* Ojk = Ot + (int64_t(j) * O + k) * O * V;
    const Tin* Okj = Ot + (int64_t(k) * O + j) * O * V;
    const Tin* Oki = Ot + (int64_t(k) * O + i) * O * V;
    const Tin* Oik = Ot + (int64_t(i) * O + k) * O * V;
    const Tin* Wi = Wv + int64_t(i) * V3;
    const Tin* Wj = Wv + int64_t(j) * V3;
    const Tin* Wk = Wv + int64_t(k) * V3;
    const Tin* t2i = t2 + int64_t(i) * O * V2;
    const Tin* t2j = t2 + int64_t(j) * O * V2;
    const Tin* t2k = t2 + int64_t(k) * O * V2;
    const Tacc one = Tacc(1);

    // ---- t3[i,j,k] on the tile: pycc_tpu/triples.py::_t3c_slab_ij ----
    Tacc acc[PER_THREAD];
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) acc[q] = Tacc(0);
    // v-terms: pair Wv[n][p1][p2][e], single t2[n1][n2][s][e]
    term<1, 0, 2>(acc, Pr, Sg, one, Wi, V2, V, 1, t2kj, V, 1, nv, nv,
                  a0, b0, c0, al, bl, cb);   // Wi[b,a,e] t2[k,j,c,e]
    term<2, 0, 1>(acc, Pr, Sg, one, Wi, V2, V, 1, t2jk, V, 1, nv, nv,
                  a0, b0, c0, al, bl, cb);   // Wi[c,a,e] t2[j,k,b,e]
    term<0, 2, 1>(acc, Pr, Sg, one, Wk, V2, V, 1, t2ji, V, 1, nv, nv,
                  a0, b0, c0, al, bl, cb);   // Wk[a,c,e] t2[j,i,b,e]
    term<1, 2, 0>(acc, Pr, Sg, one, Wk, V2, V, 1, t2ij, V, 1, nv, nv,
                  a0, b0, c0, al, bl, cb);   // Wk[b,c,e] t2[i,j,a,e]
    term<2, 1, 0>(acc, Pr, Sg, one, Wj, V2, V, 1, t2ik, V, 1, nv, nv,
                  a0, b0, c0, al, bl, cb);   // Wj[c,b,e] t2[i,k,a,e]
    term<0, 1, 2>(acc, Pr, Sg, one, Wj, V2, V, 1, t2ki, V, 1, nv, nv,
                  a0, b0, c0, al, bl, cb);   // Wj[a,b,e] t2[k,i,c,e]
    // o-terms: pair t2[n][m][p1][p2], single Ot[n1][n2][m][s]
    term<0, 1, 2>(acc, Pr, Sg, -one, t2i, V, 1, V2, Ojk, 1, V, no, nv,
                  a0, b0, c0, al, bl, cb);   // O[j,k,m,c] t2[i,m,a,b]
    term<0, 2, 1>(acc, Pr, Sg, -one, t2i, V, 1, V2, Okj, 1, V, no, nv,
                  a0, b0, c0, al, bl, cb);   // O[k,j,m,b] t2[i,m,a,c]
    term<2, 0, 1>(acc, Pr, Sg, -one, t2k, V, 1, V2, Oij, 1, V, no, nv,
                  a0, b0, c0, al, bl, cb);   // O[i,j,m,b] t2[k,m,c,a]
    term<2, 1, 0>(acc, Pr, Sg, -one, t2k, V, 1, V2, Oji, 1, V, no, nv,
                  a0, b0, c0, al, bl, cb);   // O[j,i,m,a] t2[k,m,c,b]
    term<1, 2, 0>(acc, Pr, Sg, -one, t2j, V, 1, V2, Oki, 1, V, no, nv,
                  a0, b0, c0, al, bl, cb);   // O[k,i,m,a] t2[j,m,b,c]
    term<1, 0, 2>(acc, Pr, Sg, -one, t2j, V, 1, V2, Oik, 1, V, no, nv,
                  a0, b0, c0, al, bl, cb);   // O[i,k,m,c] t2[j,m,b,a]

    const Tacc eijk = eij + eps[k];
    const int a = a0 + al;
    const int b = b0 + bl;
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int c = c0 + cb + q;
      Tacc val = Tacc(0);
      if (a < nv && b < nv && c < nv)
        val = acc[q] / (eijk - eps[no + a] - eps[no + b] - eps[no + c]);
      Ps[al * T2 + bl * T + cb + q] = val;
    }
    // the small operands of the projections, masked to the tile
    const Tin* Eojk = Eo + (int64_t(j) * O + k) * O * V;
    const Tin* Ljk = L + (int64_t(j) * O + k) * V2;
    for (int x = tid; x < 3 * no * T; x += THREADS) {
      const int ax = x / (no * T);
      const int l = (x / T) % no;
      const int g = (ax == 0 ? a0 : (ax == 1 ? b0 : c0)) + x % T;
      EoS[x] = g < nv ? to_acc(Eojk[l * V + g]) : Tacc(0);
    }
    for (int x = tid; x < 3 * T; x += THREADS) {
      const int ax = x / T;
      const int g = (ax == 0 ? a0 : (ax == 1 ? b0 : c0)) + x % T;
      FoS[x] = g < nv ? Fov[int64_t(k) * V + g] : Tacc(0);
    }
    for (int x = tid; x < T2; x += THREADS) {
      const int bb = b0 + x / T;
      const int cc = c0 + x % T;
      const int aa = a0 + x % T;
      Lbc[x] = (bb < nv && cc < nv) ? to_acc(Ljk[bb * V + cc]) : Tacc(0);
      Lba[x] = (bb < nv && aa < nv) ? to_acc(Ljk[bb * V + aa]) : Tacc(0);
    }
    __syncthreads();

    // ---- projections of the tile, summed over k in shared memory ----
    // Z1[a,d] and Z1m[c,d]: one d per thread; Ps reads are broadcasts
    const Tin* Evk = Ev + int64_t(k) * V2;
    for (int d = tid; d < nv; d += THREADS) {
      const Tin* Evdk = Evk + int64_t(d) * O * V2;
      Tacc z1[T], z1m[T];
#pragma unroll
      for (int x = 0; x < T; ++x) z1[x] = z1m[x] = Tacc(0);
      for (int yb = 0; yb < T; ++yb) {
        const int bb = b0 + yb;
        if (bb >= nv) break;
#pragma unroll
        for (int yc = 0; yc < T; ++yc) {
          const int cc = c0 + yc;
          if (cc < nv) {
            const Tacc g = Tacc(2) * to_acc(Evdk[bb * V + cc]) -
                           to_acc(Evdk[cc * V + bb]);
#pragma unroll
            for (int x = 0; x < T; ++x)
              z1[x] = fma(Ps[x * T2 + yb * T + yc], g, z1[x]);
          }
        }
#pragma unroll
        for (int ya = 0; ya < T; ++ya) {
          const int aa = a0 + ya;
          if (aa < nv) {
            const Tacc h = to_acc(Evdk[bb * V + aa]);
#pragma unroll
            for (int x = 0; x < T; ++x)
              z1m[x] = fma(Ps[ya * T2 + yb * T + x], h, z1m[x]);
          }
        }
      }
#pragma unroll
      for (int x = 0; x < T; ++x) {
        sZ1[x * nv + d] += z1[x];
        sZ1m[x * nv + d] += z1m[x];
      }
    }
    // X2l: the direct term and the (bc) and (ac) images, by relabelling
    for (int x = tid; x < no * T2; x += THREADS) {
      const int l = x / T2;
      const int p = x % T2;
      const int u = p / T;
      const int w = p % T;
      const Tacc* eoa = EoS + (0 * no + l) * T;
      const Tacc* eob = EoS + (1 * no + l) * T;
      const Tacc* eoc = EoS + (2 * no + l) * T;
      Tacc sa = Tacc(0), sb = Tacc(0), sc = Tacc(0);
#pragma unroll
      for (int y = 0; y < T; ++y) {
        sa = fma(Ps[u * T2 + w * T + y], eoc[y], sa);   // (a,b)=(u,w), sum c
        sb = fma(Ps[u * T2 + y * T + w], eob[y], sb);   // (a,c)=(u,w), sum b
        sc = fma(Ps[y * T2 + w * T + u], eoa[y], sc);   // (c,b)=(u,w), sum a
      }
      sXa[x] += Tacc(2) * sa;
      sXb[x] -= sb;
      sXc[x] -= sc;
    }
    // Z2a[a,b], Z2m[b,c], X1a[a], X1m[c]
    for (int x = tid; x < 2 * T2 + 2 * T; x += THREADS) {
      Tacc s = Tacc(0);
      if (x < T2) {                      // Z2a[a=u][b=w] = sum_c P Fov[k,c]
        const int u = x / T, w = x % T;
        for (int y = 0; y < T; ++y)
          s = fma(Ps[u * T2 + w * T + y], FoS[2 * T + y], s);
        sZ2a[x] += s;
      } else if (x < 2 * T2) {           // Z2m[b=u][c=w] = sum_a P Fov[k,a]
        const int u = (x - T2) / T, w = (x - T2) % T;
        for (int y = 0; y < T; ++y)
          s = fma(Ps[y * T2 + u * T + w], FoS[y], s);
        sZ2m[x - T2] += s;
      } else if (x < 2 * T2 + T) {       // X1a[a] = sum_bc P L[j,k,b,c]
        const int u = x - 2 * T2;
        for (int y = 0; y < T2; ++y) s = fma(Ps[u * T2 + y], Lbc[y], s);
        sX1a[u] += s;
      } else {                           // X1m[c] = sum_ab P L[j,k,b,a]
        const int u = x - 2 * T2 - T;
        for (int ya = 0; ya < T; ++ya)
          for (int yb = 0; yb < T; ++yb)
            s = fma(Ps[ya * T2 + yb * T + u], Lba[yb * T + ya], s);
        sX1m[u] += s;
      }
    }
    __syncthreads();
  }

  // ---- the block's totals, added once into the row's outputs ----
  const int64_t jv = int64_t(j) * V;
  const int64_t jvv = int64_t(j) * V2;
  for (int x = tid; x < T; x += THREADS) {
    if (a0 + x < nv) atomicAdd(&X1a[jv + a0 + x], sX1a[x]);
    if (c0 + x < nv) atomicAdd(&X1m[jv + c0 + x], sX1m[x]);
  }
  for (int x = tid; x < T2; x += THREADS) {
    const int u = x / T, w = x % T;
    if (a0 + u < nv && b0 + w < nv)
      atomicAdd(&Z2a[jvv + (a0 + u) * V + b0 + w], sZ2a[x]);
    if (b0 + u < nv && c0 + w < nv)
      atomicAdd(&Z2m[jvv + (b0 + u) * V + c0 + w], sZ2m[x]);
  }
  for (int x = tid; x < T * nv; x += THREADS) {
    const int u = x / nv, d = x % nv;
    if (a0 + u < nv) atomicAdd(&Z1[jvv + (a0 + u) * V + d], sZ1[x]);
    if (c0 + u < nv) atomicAdd(&Z1m[jvv + (c0 + u) * V + d], sZ1m[x]);
  }
  Tacc* X2j = X2l + int64_t(j) * O * V2;
  for (int x = tid; x < no * T2; x += THREADS) {
    const int64_t l = x / T2;
    const int u = (x % T2) / T, w = x % T;
    Tacc* X2jl = X2j + l * V2;
    if (a0 + u < nv && b0 + w < nv)
      atomicAdd(&X2jl[(a0 + u) * V + b0 + w], sXa[x]);
    if (a0 + u < nv && c0 + w < nv)
      atomicAdd(&X2jl[(a0 + u) * V + c0 + w], sXb[x]);
    if (c0 + u < nv && b0 + w < nv)
      atomicAdd(&X2jl[(c0 + u) * V + b0 + w], sXc[x]);
  }
}

template <typename Tin, typename Tacc>
int launch(int i, const void* Wv, const void* Ot, const void* Ev,
           const void* Eo, const void* L, const void* Fov, const void* eps,
           const void* t2, void* X1a, void* X1m, void* Z1, void* Z1m,
           void* Z2a, void* Z2m, void* X2l, int no, int nv, void* stream) {
  const size_t smem = size_t(Layout(no, nv).total) * sizeof(Tacc);
  cudaError_t err = cudaFuncSetAttribute(
      t_row_kernel<Tin, Tacc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (nv + T - 1) / T;
  const dim3 grid(nt * nt * nt, no);
  t_row_kernel<Tin, Tacc><<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      i, static_cast<const Tin*>(Wv), static_cast<const Tin*>(Ot),
      static_cast<const Tin*>(Ev), static_cast<const Tin*>(Eo),
      static_cast<const Tin*>(L), static_cast<const Tacc*>(Fov),
      static_cast<const Tacc*>(eps), static_cast<const Tin*>(t2),
      static_cast<Tacc*>(X1a), static_cast<Tacc*>(X1m),
      static_cast<Tacc*>(Z1), static_cast<Tacc*>(Z1m),
      static_cast<Tacc*>(Z2a), static_cast<Tacc*>(Z2m),
      static_cast<Tacc*>(X2l), no, nv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define T_ROW_ENTRY(NAME, TIN, TACC)                                        \
  int NAME(int i, const void* Wv, const void* Ot, const void* Ev,           \
           const void* Eo, const void* L, const void* Fov, const void* eps, \
           const void* t2, void* X1a, void* X1m, void* Z1, void* Z1m,       \
           void* Z2a, void* Z2m, void* X2l, int no, int nv, void* stream) { \
    return launch<TIN, TACC>(i, Wv, Ot, Ev, Eo, L, Fov, eps, t2, X1a, X1m,  \
                             Z1, Z1m, Z2a, Z2m, X2l, no, nv, stream);       \
  }

T_ROW_ENTRY(t_row_f64, double, double)
T_ROW_ENTRY(t_row_f32, float, float)
T_ROW_ENTRY(t_row_bf16, __nv_bfloat16, float)

#undef T_ROW_ENTRY

// bytes of dynamic shared memory one block takes, for a tile type of
// acc_bytes bytes
long long t_row_smem_bytes(int no, int nv, int acc_bytes) {
  return static_cast<long long>(Layout(no, nv).total) * acc_bytes;
}

const char* t_row_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
