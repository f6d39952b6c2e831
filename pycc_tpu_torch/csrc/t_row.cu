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
// L = Loovv (o,o,v,v), Fov (o,v), eps (o+v), t2 (o,o,v,v), and three
// operands the caller derives: t2m[n,p,q,m] = t2[n,m,p,q] (o,v,v,o) and
// Otm[x,y,s,m] = -Ot[x,y,m,s] (o,o,v,o), so that every operand of the build
// is contiguous along its contraction index, and the Z1 operand
// G[d,k,b,c] = 2 Ev[d,k,b,c] - Ev[d,k,c,b] (v,o,v,v) in the streamed type,
// as the Pallas kernel forms it.  None of the three depends on the row:
// the (T) driver forms them once for all rows.  T3 itself never reaches
// device memory:
// each tile lives in shared memory only.
//
// Replaces the TPU kernel K2, pycc_tpu/ops/kernels/triples.py::
// t_energy_row_pallas (body `_t_row_kernel`).  That kernel held a whole
// (v, v, v) cube of t3 in the TPU's ~128 MB of VMEM per grid cell, walked a
// sequential (j, k) grid and carried its sums from one grid step to the
// next.  Here a block owns one 8 x 8 x 8 tile of (a, b, c) for one j and
// runs the k loop itself; the projections of the (ac) and (bc) images
// (X1m, Z1m, Z2m and two of the three X2l terms) are formed from the same
// tile by relabelling, so t3 is built once per element; every block sums
// over k in shared memory and adds its totals once, with atomicAdd, into
// outputs that the caller zeroes.  Ragged a, b, c are masked.
//
// What bounds it: at (H2O)_6/cc-pVDZ, (no, nv) = (24, 114), one row builds
// o^2 v^3 = 8.5e8 t3 elements at 6 (v + o) = 828 FMA each (1.4e12 flop)
// and spends 3 (v + o) FMA more on the projections (0.4e12 flop): 29 ms
// at the FP64 tensor cores' 67 TFLOP/s.  But every block streams its
// operands from L2 with a reuse of 8, the tile edge: ~1.2 TB a row, so
// the copies, not the arithmetic, set the time.  The design:
//   - the twelve build terms fall into three groups by the tile axis that
//     their single operand indexes (c, b or a).  Each group is one product
//     (64 pair rows) x (8 columns) over a contraction axis of 2v + 2o
//     (276 at (H2O)_6): the four terms' e and m ranges laid end to end.
//     The pair transposes are strides of the staging copy; the minus sign
//     of the m terms comes with Otm; the last group's
//     write-back divides by the denominators.  In float64 the products run
//     on the FP64 tensor cores, mma.sync.m16n8k4 .f64 (DMMA), one 16-row
//     slice of the pairs to each of the four warps, in two independent
//     accumulator chains;
//   - Z1 and Z1m are DMMA products too, (32 d) x (8 a or c) over the 64
//     (b, c) or (a, b) pairs of the tile, with G and Ev staged so that
//     consecutive threads read consecutive elements; the four warps'
//     partial sums meet in shared memory;
//   - the operands stream through a two-stage cp.async ring in shared
//     memory, 32 contraction steps (or 32 d) a stage, so the copies of the
//     next stage overlap the products of this one; when no and nv are
//     even a copy moves two elements (16 bytes in float64, past L1).
//     Shared memory (the ring, the tile and the block's sums over k)
//     allows two blocks an SM at (24, 114);
//   - the occupied index l of Eo and of the X2l sums is staged in chunks
//     of lc: all no when 8 (7048 + 216 no + 16 nv) bytes (float64) fit in
//     what a block may take, else as many as fit, so no occupied size is
//     refused.  A later chunk rebuilds the t3 tiles of every k for its
//     own X2l sums and runs nothing else, so past one chunk a row costs
//     about no / lc builds;
//   - blocks run j fastest, so the blocks resident together share their
//     k-dependent operands in L2;
//   - float32 has no tensor-core path at its tolerance (TF32 keeps ~3
//     digits), so its grouped products run on the CUDA cores, each lane
//     computing the 2 x 2 register tile that the mma fragment layout gives
//     it;
//   - in the bf16-streamed mode the build's operands are bf16, and a
//     product of two bf16 values is exact in float32, so the build runs on
//     the bf16 tensor cores, mma.sync.m16n8k16 with float32 accumulation,
//     in the same fragment layout.  bf16 operands are loaded into
//     registers one stage ahead and widened as they are stored, and the
//     fragment loads narrow them back exactly.  The t3 tile is float32,
//     so Z1 and Z1m stay on the CUDA cores in this mode;
//   - X2l, Z2, X1 stay on the CUDA cores: 4% of the row's arithmetic.
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
#include <type_traits>

namespace {

constexpr int T = 8;                 // tile edge along a, b and c
constexpr int T2 = T * T;
constexpr int THREADS = 128;         // four warps
constexpr int XC = 32;               // contraction steps a build stage
constexpr int PX = XC + 4;           // pitch of a build stage row
constexpr int DC = 32;               // d values a Z1 stage
constexpr int MT = DC / 16;          // 16-row d tiles a Z1 stage (two)
constexpr int PE = T2 + 4;           // pitch of a Z1 stage row
constexpr int PS = T2 + 4;           // pitch of the t3 tile along a
constexpr int NSTAGE = 2;            // stages in the ring
// a stage holds the build's 64 pair rows and 8 single rows, or one
// (DC, 64) slice of G or Ev for the Z1 products
constexpr int STAGE = (T2 + T) * PX > DC * PE ? (T2 + T) * PX : DC * PE;
// copies of VEC consecutive elements: XV threads to a build stage row,
// RP rows a pass of the block's threads
template <int VEC>
struct Copies {
  static constexpr int XV = XC / VEC;
  static constexpr int RP = THREADS / XV;
  static constexpr int BUILD = (T + 1) * (T / RP);   // a thread, a stage
  static constexpr int EV = DC * T2 / VEC / THREADS;  // a thread, a stage
  static_assert(THREADS % XV == 0 && T % RP == 0,
                "passes of the threads tile the stage rows");
  static_assert(DC * T2 % (VEC * THREADS) == 0,
                "a Z1 stage is a whole number of copies a thread");
};
constexpr int NPRE = Copies<1>::BUILD;   // copies a thread (at most)

static_assert(THREADS == 4 * 32 && T == 8, "four warps, one 16-row slice each");
static_assert(MT == 2, "a Z1 stage is two d tiles, one accumulator chain each");
static_assert(XC % 32 == 0, "a build stage is two bf16 mma steps");
static_assert(Copies<1>::EV <= NPRE && Copies<2>::BUILD <= NPRE,
              "the stager holds a stage's copies");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The copies of one stage by one thread, VEC elements each.  When the
// operand and tile types agree each copy is a cp.async (zero-filled when
// out of range); for bf16 operands the values are loaded into registers
// here and widened into shared memory by store(), after the products of
// the current stage.  When !valid, src may point past the operand: a
// zero-size cp.async, like the skipped register load, reads nothing.
template <typename Tin, typename Tacc, int VEC>
struct Stager {
  static constexpr bool ASYNC = std::is_same_v<Tin, Tacc>;
  static constexpr int BYTES = int(sizeof(Tin)) * VEC;
  uint32_t v[NPRE];
  Tacc* dst[NPRE];
  int count;

  __device__ __forceinline__ void copy(int n, Tacc* d, const Tin* src,
                                       bool valid) {
    if constexpr (ASYNC && BYTES == 16) {
      // 16-byte copies bypass L1: no block reads a line twice
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_u32(d)),
                   "l"(src), "r"(valid ? 16 : 0));
    } else if constexpr (ASYNC) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                       smem_u32(d)),
                   "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0));
    } else {
      static_assert(sizeof(Tin) == 2, "bf16 operands");
      if constexpr (VEC == 2)
        v[n] = valid ? *reinterpret_cast<const uint32_t*>(src) : 0u;
      else
        v[n] = valid ? *reinterpret_cast<const uint16_t*>(src) : 0u;
      dst[n] = d;
    }
  }
  __device__ __forceinline__ void store() {
    if constexpr (!ASYNC) {
#pragma unroll
      for (int n = 0; n < NPRE; ++n)
        if (n < count) {
          dst[n][0] = __uint_as_float(v[n] << 16);
          if constexpr (VEC == 2) dst[n][1] = __uint_as_float(v[n] & 0xffff0000u);
        }
    }
  }
};

// v = the T elements at p, a 16-byte aligned row of shared memory, by
// 16-byte loads
template <typename Tacc>
__device__ __forceinline__ void load_row(Tacc (&v)[T], const Tacc* p) {
  using V16 = std::conditional_t<std::is_same_v<Tacc, double>, double2,
                                 float4>;
  constexpr int N = int(sizeof(V16) / sizeof(Tacc));
#pragma unroll
  for (int n = 0; n < T / N; ++n) {
    const V16 x = reinterpret_cast<const V16*>(p)[n];
    if constexpr (N == 2) {
      v[2 * n] = x.x;
      v[2 * n + 1] = x.y;
    } else {
      v[4 * n] = x.x;
      v[4 * n + 1] = x.y;
      v[4 * n + 2] = x.z;
      v[4 * n + 3] = x.w;
    }
  }
}

// Where a stage of one k lies: part 0-2 are the build groups (single axis
// c, b, a), part 3-5 the three Z1 products; idx counts the stages of the
// part.  Advanced by one stage at a time, so no stage index is divided.
struct Cursor {
  int part, idx;
  __device__ __forceinline__ void next(int nxc, int nz) {
    if (++idx == (part < 3 ? nxc : nz)) {
      idx = 0;
      ++part;
    }
  }
};

// c += A (16 x 4) * B (4 x 8) in the m16n8k4 fragment layout (g = lane / 4,
// t = lane % 4): c[r] = C[g + 8 (r / 2)][2 t + r % 2].  A(row, k) and
// B(k, col) read the operands.  float64 issues one DMMA from the
// fragments a0 = A(g, t), a1 = A(g + 8, t), b = B(t, g); float32 computes
// the lane's same four outputs on the CUDA cores.
template <typename Tacc, typename FA, typename FB>
__device__ __forceinline__ void mma_k4(Tacc (&c)[4], int g, int t, FA&& A,
                                       FB&& B) {
  if constexpr (std::is_same_v<Tacc, double>) {
    const double a0 = A(g, t), a1 = A(g + 8, t), b = B(t, g);
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a0), "d"(a1), "d"(b));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const Tacc a0 = A(g, k), a1 = A(g + 8, k);
      const Tacc b0 = B(k, 2 * t), b1 = B(k, 2 * t + 1);
      c[0] = fmaf(a0, b0, c[0]);
      c[1] = fmaf(a0, b1, c[1]);
      c[2] = fmaf(a1, b0, c[2]);
      c[3] = fmaf(a1, b1, c[3]);
    }
  }
}

// c += A (16 x 16) * B (16 x 8) on the bf16 tensor cores, mma.sync
// m16n8k16 with float32 accumulation, c in the layout of mma_k4.  The
// operands are float32 rows of pitch PX in shared memory that hold bf16
// values, so taking their upper halves is exact: a points at A(g, 2t),
// b at B(2t, g) (B stored by columns), each pair of consecutive k one
// 8-byte load.
__device__ __forceinline__ void mma_k16_bf16(float (&c)[4], const float* a,
                                             const float* b) {
  auto pack = [](const float* p) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    // the bf16 of k in the low half, of k + 1 in the high half
    return __byte_perm(__float_as_uint(x.x), __float_as_uint(x.y), 0x7632);
  };
  const unsigned a0 = pack(a), a1 = pack(a + 8 * PX), a2 = pack(a + 8),
                 a3 = pack(a + 8 * PX + 8);
  const unsigned b0 = pack(b), b1 = pack(b + 8);
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Shared-memory layout, in elements of the tile type, for chunks of lc
// occupied indices l of Eo and of the X2l sums.  The host computes the
// same size through t_row_smem_bytes.
struct Layout {
  int ps, st, red, eo, fo, lbc, lba, x1a, x1m, z2a, z2m, z1, z1m, x2a, x2b,
      x2c, total;
  __host__ __device__ Layout(int lc, int nv) {
    int o = 0;
    ps = o;  o += T * PS;          // the t3 tile, [a][b * T + c], pitch PS
    st = o;  o += NSTAGE * STAGE;  // the operand ring
    red = o; o += THREADS * 4 * MT;  // the warps' Z1 partial sums
    eo = o;  o += 3 * lc * T;      // Eo[j,k,l,x], x on the a, b, c ranges
    fo = o;  o += 3 * T;           // Fov[k, x] on the a, b, c ranges
    lbc = o; o += T2;              // L[j,k,b,c]
    lba = o; o += T2;              // L[j,k,b,a]
    x1a = o; o += T;               // the block's sums over k ...
    x1m = o; o += T;
    z2a = o; o += T2;
    z2m = o; o += T2;
    z1 = o;  o += T * nv;          // Z1[a][d]
    z1m = o; o += T * nv;          // Z1m[c][d]
    x2a = o; o += lc * T2;         // X2l[j,l,a,b] +=
    x2b = o; o += lc * T2;         // X2l[j,l,a,c] +=
    x2c = o; o += lc * T2;         // X2l[j,l,c,b] +=
    total = o;
  }
};

// Dynamic shared memory a block may take: the card's 232448 bytes less
// the kernel's static arrays (seg_p, seg_q, seg_n: 480 bytes) and room
// to spare.
constexpr long long SMEM_BUDGET = 232448 - 1024;

// The chunk of occupied l a block stages: all no when they fit, else the
// most that fit, so that the X2l sums of a chunk stay on chip; 0 when
// not even one fits (nv too large).
__host__ __device__ inline int chunk_of(int no, int nv, int acc_bytes) {
  for (int lc = no; lc > 0; --lc)
    if (static_cast<long long>(Layout(lc, nv).total) * acc_bytes <=
        SMEM_BUDGET)
      return lc;
  return 0;
}

template <typename Tin, typename Tacc, int VEC>
__global__ void __launch_bounds__(THREADS) t_row_kernel(
    int i, const Tin* __restrict__ Wv, const Tin* __restrict__ t2m,
    const Tin* __restrict__ Otm, const Tin* __restrict__ Ev,
    const Tin* __restrict__ G,
    const Tin* __restrict__ Eo, const Tin* __restrict__ L,
    const Tacc* __restrict__ Fov, const Tacc* __restrict__ eps,
    const Tin* __restrict__ t2, Tacc* __restrict__ X1a,
    Tacc* __restrict__ X1m, Tacc* __restrict__ Z1, Tacc* __restrict__ Z1m,
    Tacc* __restrict__ Z2a, Tacc* __restrict__ Z2m, Tacc* __restrict__ X2l,
    int no, int nv, int lc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tacc* sm = reinterpret_cast<Tacc*>(smem_raw);
  const Layout lay(lc, nv);
  Tacc* Ps = sm + lay.ps;
  Tacc* St = sm + lay.st;
  Tacc* Red = sm + lay.red;
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
  auto ps = [&](int a, int b, int c) -> Tacc& { return Ps[a * PS + b * T + c]; };
  using St_t = Stager<Tin, Tacc, VEC>;
  using C = Copies<VEC>;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nt = (nv + T - 1) / T;
  // j fastest: the blocks resident together share k-dependent operands
  const int tile = blockIdx.x / no;
  const int j = blockIdx.x % no;
  const int a0 = (tile / (nt * nt)) * T;
  const int b0 = ((tile / nt) % nt) * T;
  const int c0 = (tile % nt) * T;

  for (int x = tid; x < lay.total - lay.x1a; x += THREADS)
    sm[lay.x1a + x] = Tacc(0);

  const int V = nv, O = no, V2 = nv * nv, VO = nv * no;
  const int X = 2 * nv + 2 * no;          // the groups' contraction length
  const int NXC = (X + XC - 1) / XC;      // build stages a group
  const int NZ = (nv + DC - 1) / DC;      // stages of each Z1 product
  const int NB = 3 * NXC;
  const Tacc eij = eps[i] + eps[j];
  const Tin* Wi = Wv + int64_t(i) * V2 * V;
  const Tin* Wj = Wv + int64_t(j) * V2 * V;
  // a thread's place in a build stage: contraction steps xl .. xl + VEC - 1
  // of rows r2 + T r1 (pair) and r2 (single), for r2 = r2b + RP h
  const int xl = (tid % C::XV) * VEC, r2b = tid / C::XV;

  // the build's twelve terms for this k, one entry (grp * 4 + seg) each:
  // the pair operand at p + r1 sr1 + r2 sr2 + x, the single one at
  // q + s ss + x (p and q already at the tile's origin), and the numbers
  // of in-range pair rows r1, r2 and single rows s
  __shared__ const Tin* seg_p[12];
  __shared__ const Tin* seg_q[12];
  __shared__ int seg_n[12][6];

  // The occupied l of Eo and the X2l sums come in chunks of lc, one k loop
  // each.  The first chunk also runs the Z1 products and the other
  // projections; a later one rebuilds the t3 tiles for its X2l alone.
  for (int l0 = 0; l0 < no; l0 += lc) {
    const int nl = min(lc, no - l0);
    const bool first = l0 == 0;
    const int NQ = first ? NB + 2 * NZ : NB;  // stages a k
    for (int k = 0; k < no; ++k) {
      if (tid < 12) {
        const Tin* Wk = Wv + int64_t(k) * V2 * V;
        auto t2p = [&](int x, int y) { return t2 + (int64_t(x) * O + y) * V2; };
        auto t2n = [&](int x) { return t2m + int64_t(x) * V2 * O; };
        auto Op = [&](int x, int y) { return Otm + (int64_t(x) * O + y) * VO; };
        const int grp = tid / 4;
        const Tin *p, *sg;
        int sr1, sr2, ss;
        // v-terms pair Wv[n][p1][p2][e] with t2[n1][n2][s][e], o-terms
        // t2m[n][p1][p2][m] with Otm[n1][n2][s][m]
        // (pycc_tpu/triples.py::_t3c_slab_ij)
        switch (tid) {
          // c: Wi[b,a,e] t2[k,j,c,e]; Wj[a,b,e] t2[k,i,c,e];
          //    O[j,k,m,c] t2[i,m,a,b]; O[i,k,m,c] t2[j,m,b,a]
          case 0: p = Wi; sr1 = V; sr2 = V2; sg = t2p(k, j); ss = V; break;
          case 1: p = Wj; sr1 = V2; sr2 = V; sg = t2p(k, i); ss = V; break;
          case 2: p = t2n(i); sr1 = VO; sr2 = O; sg = Op(j, k); ss = O; break;
          case 3: p = t2n(j); sr1 = O; sr2 = VO; sg = Op(i, k); ss = O; break;
          // b: Wi[c,a,e] t2[j,k,b,e]; Wk[a,c,e] t2[j,i,b,e];
          //    O[k,j,m,b] t2[i,m,a,c]; O[i,j,m,b] t2[k,m,c,a]
          case 4: p = Wi; sr1 = V; sr2 = V2; sg = t2p(j, k); ss = V; break;
          case 5: p = Wk; sr1 = V2; sr2 = V; sg = t2p(j, i); ss = V; break;
          case 6: p = t2n(i); sr1 = VO; sr2 = O; sg = Op(k, j); ss = O; break;
          case 7: p = t2n(k); sr1 = O; sr2 = VO; sg = Op(i, j); ss = O; break;
          // a: Wk[b,c,e] t2[i,j,a,e]; Wj[c,b,e] t2[i,k,a,e];
          //    O[j,i,m,a] t2[k,m,c,b]; O[k,i,m,a] t2[j,m,b,c]
          case 8: p = Wk; sr1 = V2; sr2 = V; sg = t2p(i, j); ss = V; break;
          case 9: p = Wj; sr1 = V; sr2 = V2; sg = t2p(i, k); ss = V; break;
          case 10: p = t2n(k); sr1 = O; sr2 = VO; sg = Op(j, i); ss = O; break;
          default: p = t2n(j); sr1 = VO; sr2 = O; sg = Op(k, i); ss = O; break;
        }
        // tile origins of the pair axes and the single axis of the group
        const int o1 = grp == 2 ? b0 : a0;
        const int o2 = grp == 0 ? b0 : c0;
        const int os = grp == 0 ? c0 : grp == 1 ? b0 : a0;
        seg_p[tid] = p + int64_t(o1) * sr1 + int64_t(o2) * sr2;
        seg_q[tid] = sg + int64_t(os) * ss;
        seg_n[tid][0] = sr1;
        seg_n[tid][1] = sr2;
        seg_n[tid][2] = ss;
        seg_n[tid][3] = nv - o1;
        seg_n[tid][4] = nv - o2;
        seg_n[tid][5] = nv - os;
      }
      __syncthreads();
      const Tin* Evk = Ev + int64_t(k) * V2;
      const Tacc eijk = eij + eps[k];
      const Tin* Gk = G + int64_t(k) * V2;

      // the small operands of the projections, masked to the tile: with the
      // first stage of k when they can be copied as they are, else (bf16)
      // widened at the end of the build
      auto small_operands = [&](bool async) {
        const Tin* Eojk = Eo + (int64_t(j) * O + k) * VO;
        const Tin* Ljk = L + (int64_t(j) * O + k) * V2;
        auto put = [&](Tacc* d, const auto* src, bool valid) {
          if constexpr (St_t::ASYNC) {
            if (async) {
              asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                               smem_u32(d)),
                           "l"(valid ? src : Fov), "n"(int(sizeof(Tacc))),
                           "r"(valid ? int(sizeof(Tacc)) : 0));
              return;
            }
          }
          *d = valid ? Tacc(*src) : Tacc(0);
        };
        for (int x = tid; x < 3 * lc * T; x += THREADS) {
          const int ax = x / (lc * T);
          const int l = (x / T) % lc;
          const int gx = (ax == 0 ? a0 : (ax == 1 ? b0 : c0)) + x % T;
          put(EoS + x, Eojk + (l0 + l) * V + gx, gx < nv && l < nl);
        }
        for (int x = tid; x < 3 * T; x += THREADS) {
          const int ax = x / T;
          const int gx = (ax == 0 ? a0 : (ax == 1 ? b0 : c0)) + x % T;
          put(FoS + x, Fov + int64_t(k) * V + gx, gx < nv);
        }
        for (int x = tid; x < T2; x += THREADS) {
          const int bb = b0 + x / T, cc = c0 + x % T, aa = a0 + x % T;
          put(Lbc + x, Ljk + bb * V + cc, bb < nv && cc < nv);
          put(Lba + x, Ljk + bb * V + aa, bb < nv && aa < nv);
        }
      };

      // stage at cursor c into ring slot `slot`
      auto issue = [&](Cursor c, int slot, St_t& s) {
        Tacc* buf = St + slot * STAGE;
        if constexpr (St_t::ASYNC) {
          if (c.part == 0 && c.idx == 0) small_operands(true);
        }
        if (c.part < 3) {
          // group c.part, steps x of its 2v + 2o: e of two v-terms, then m
          // of two o-terms
          const int x = c.idx * XC + xl;
          const int seg = x < nv ? 0 : x < 2 * nv ? 1 : x < 2 * nv + no ? 2 : 3;
          const int e = x - (seg == 0 ? 0 : seg == 1 ? nv
                             : seg == 2 ? 2 * nv : 2 * nv + no);
          const int id = c.part * 4 + seg;
          const int sr1 = seg_n[id][0];
          const bool xin = x < X;
          const int n1 = seg_n[id][3];
          s.count = C::BUILD;
  #pragma unroll
          for (int h = 0; h < T / C::RP; ++h) {
            const int r2 = r2b + C::RP * h;
            const bool in = xin && r2 < seg_n[id][4];
            const Tin* row = seg_p[id] + r2 * seg_n[id][1] + e;
  #pragma unroll
            for (int r1 = 0; r1 < T; ++r1) {
              const bool valid = in && r1 < n1;
              s.copy(h * T + r1, buf + (r1 * T + r2) * PX + xl,
                     row + r1 * sr1, valid);
            }
            const bool valid = xin && r2 < seg_n[id][5];
            s.copy(T * (T / C::RP) + h, buf + (T2 + r2) * PX + xl,
                   seg_q[id] + r2 * seg_n[id][2] + e, valid);
          }
        } else {
          // G (Z1) or Ev (Z1m) at [d, k, b0 + xx, Y0 + yy] for DC d into
          // buf[d][xx * T + yy]: the consecutive threads of a d run along yy,
          // then xx
          constexpr int TD = T2 / VEC;      // threads to a d
          constexpr int DP = THREADS / TD;  // d a pass of the threads
          const bool z1 = c.part == 3;      // else Z1m
          const int Y0 = z1 ? c0 : a0;
          const int inner = (tid % TD) * VEC;
          const int xx = b0 + inner / T, yy = Y0 + inner % T;
          const bool in = xx < nv && yy < nv;
          const int dl = tid / TD;
          const int d0 = c.idx * DC + dl;
          const Tin* src = (z1 ? Gk : Evk) + int64_t(d0) * VO * V + xx * V + yy;
          const int64_t step = int64_t(DP) * VO * V;
          s.count = C::EV;
  #pragma unroll
          for (int n = 0; n < C::EV; ++n) {
            const bool valid = in && d0 + n * DP < nv;
            s.copy(n, buf + (dl + n * DP) * PE + inner,
                   src + n * step, valid);
          }
        }
      };

      Tacc acc[2][4];
  #pragma unroll
      for (int h = 0; h < 2; ++h)
  #pragma unroll
        for (int r = 0; r < 4; ++r) acc[h][r] = Tacc(0);
      St_t s;
      Cursor ci{0, 0}, cc{0, 0};     // the next stage to issue, to compute
      if constexpr (St_t::ASYNC) {
  #pragma unroll
        for (int q = 0; q < NSTAGE - 1; ++q) {
          if (q < NQ) {
            issue(ci, q, s);
            ci.next(NXC, NZ);
          }
          cp_commit();
        }
      } else {
        issue(ci, 0, s);
        ci.next(NXC, NZ);
        s.store();
      }
      for (int q = 0; q < NQ; ++q, cc.next(NXC, NZ)) {
        if constexpr (St_t::ASYNC) {
          cp_wait<NSTAGE - 2>();
          __syncthreads();
          // the slot filled here was read in step q - 1, before the barrier
          if (q + NSTAGE - 1 < NQ) {
            issue(ci, (q + NSTAGE - 1) % NSTAGE, s);
            ci.next(NXC, NZ);
          }
          cp_commit();
        } else {
          if (q + 1 < NQ) {                  // into registers
            issue(ci, (q + 1) % NSTAGE, s);
            ci.next(NXC, NZ);
          }
          __syncthreads();
        }
        const Tacc* buf = St + (q % NSTAGE) * STAGE;
        if (cc.part < 3) {
          // ---- the build: warp w's 16 pair rows of group cc.part ----
          const int grp = cc.part;
          const Tacc* Pr = buf + warp * 16 * PX;
          const Tacc* Sg = buf + T2 * PX;
          if constexpr (std::is_same_v<Tin, __nv_bfloat16>) {
  #pragma unroll
            for (int kk = 0; kk < XC; kk += 16)
              mma_k16_bf16(acc[(kk / 16) % 2], Pr + g * PX + kk + 2 * t,
                           Sg + g * PX + kk + 2 * t);
          } else {
  #pragma unroll
            for (int kk = 0; kk < XC; kk += 4) {
              mma_k4(acc[(kk / 4) % 2], g, t,
                     [&](int r, int kq) { return Pr[r * PX + kk + kq]; },
                     [&](int kq, int n) { return Sg[n * PX + kk + kq]; });
            }
          }
          if (cc.idx == NXC - 1) {
            // the lane's rows are pairs (2w, g) and (2w + 1, g), its columns
            // 2t and 2t + 1 along the single axis
  #pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int r1 = 2 * warp + r / 2, s2 = 2 * t + r % 2;
              const Tacc val = acc[0][r] + acc[1][r];
              if (grp == 0) {
                ps(r1, g, s2) = val;                      // (a,b) x c
              } else if (grp == 1) {
                ps(r1, s2, g) += val;                     // (a,c) x b
              } else {
                // (b,c) x a completes the element: divide by its denominator
                const int a = a0 + s2, b = b0 + r1, c = c0 + g;
                Tacc& p = ps(s2, r1, g);
                p = (a < nv && b < nv && c < nv)
                        ? (p + val) / (eijk - eps[no + a] - eps[no + b] -
                                       eps[no + c])
                        : Tacc(0);
              }
              acc[0][r] = acc[1][r] = Tacc(0);
            }
          }
        } else {
          // ---- Z1 and Z1m, DC d a stage, a quarter of the 64 tile pairs
          // to each warp:
          //   Z1[a, d]  += sum_bc t3[a,b,c] G[d,k,b,c]
          //   Z1m[c, d] += sum_ab t3[a,b,c] Ev[d,k,b,a]
          const int z = cc.idx;
          const bool z1 = cc.part == 3;
          // one accumulator chain for each of the two d tiles
          Tacc zz[MT][4];
  #pragma unroll
          for (int h = 0; h < MT; ++h)
  #pragma unroll
            for (int r = 0; r < 4; ++r) zz[h][r] = Tacc(0);
  #pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const Tacc* E = buf + mt * 16 * PE;
  #pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int kk = warp * 16 + 4 * m;
              auto& c = zz[mt];
              if (z1)                  // p = b T + c
                mma_k4(c, g, t,
                       [&](int r, int kq) { return E[r * PE + kk + kq]; },
                       [&](int kq, int n) { return Ps[n * PS + kk + kq]; });
              else                     // p = a T + b, staged as [b T + a]
                mma_k4(c, g, t,
                       [&](int r, int kq) {
                         const int p = kk + kq;
                         return E[r * PE + (p % T) * T + p / T];
                       },
                       [&](int kq, int n) {
                         const int p = kk + kq;
                         return Ps[(p / T) * PS + (p % T) * T + n];
                       });
            }
          }
  #pragma unroll
          for (int mt = 0; mt < MT; ++mt)
  #pragma unroll
            for (int r = 0; r < 4; ++r)
              Red[(warp * MT + mt) * THREADS + r * 32 + lane] = zz[mt][r];
          __syncthreads();
  #pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            // thread (r, lane) sums the four warps' (d, col) of that place
            const int r = tid / 32, gg = (tid % 32) / 4, tt = tid % 4;
            const int d = z * DC + mt * 16 + gg + 8 * (r / 2);
            const int col = 2 * tt + r % 2;
            Tacc sum = Tacc(0);
  #pragma unroll
            for (int ww = 0; ww < 4; ++ww)
              sum += Red[(ww * MT + mt) * THREADS + tid];
            if (d < nv) (z1 ? sZ1 : sZ1m)[col * nv + d] += sum;
          }
        }
        if constexpr (!St_t::ASYNC) {
          // the slot of stage q + 1 was last read in step q + 1 - NSTAGE
          if (q + 1 < NQ) s.store();
        }
      }
      __syncthreads();
      if constexpr (!St_t::ASYNC) {
        // the bf16 small operands, widened once the build is done
        small_operands(false);
        __syncthreads();
      }

      // ---- the small projections of the tile, summed over k ----
      // X2l: the direct term and the (bc) and (ac) images, by relabelling.
      // A thread owns one (u, w) and every other l: it reads its eight t3
      // values of a term once and sweeps l against Eo (one row a warp)
      {
        const int uw = tid % T2, u = uw / T, w = uw % T;
  #pragma unroll
        for (int term = 0; term < 3; ++term) {
          Tacc p[T];
  #pragma unroll
          for (int y = 0; y < T; ++y)
            p[y] = term == 0 ? ps(u, w, y)     // (a,b)=(u,w), sum c
                 : term == 1 ? ps(u, y, w)     // (a,c)=(u,w), sum b
                             : ps(y, w, u);    // (c,b)=(u,w), sum a
          const int ax = 2 - term;             // Eo on the c, b, a range
          Tacc* sX = term == 0 ? sXa : term == 1 ? sXb : sXc;
          const Tacc f = term == 0 ? Tacc(2) : Tacc(-1);
          for (int l = tid / T2; l < nl; l += THREADS / T2) {
            Tacc eo[T];
            load_row(eo, EoS + (ax * lc + l) * T);
            Tacc acc2 = Tacc(0);
  #pragma unroll
            for (int y = 0; y < T; ++y) acc2 = fma(p[y], eo[y], acc2);
            sX[l * T2 + uw] += f * acc2;
          }
        }
      }
      // Z2a[a,b], Z2m[b,c], X1a[a], X1m[c]: one Z2 element and one X1
      // partial (over the eight c, or the eight a) a thread, the X1 partials
      // summed over b across the eight lanes that share a (or c); the first
      // chunk's only
      if (first) {
        const int u = (tid % T2) / T, w = tid % T;
        Tacc z = Tacc(0), x1 = Tacc(0);
        if (tid < T2) {            // (a, b) = (u, w)
  #pragma unroll
          for (int y = 0; y < T; ++y) {
            z = fma(ps(u, w, y), FoS[2 * T + y], z);        // sum_c P Fov[k,c]
            x1 = fma(ps(u, w, y), Lbc[w * T + y], x1);      // sum_c P L[j,k,b,c]
          }
        } else {                   // (b, c) = (u, w) for Z2m; (c, b) = (u, w)
  #pragma unroll
          for (int y = 0; y < T; ++y) {
            z = fma(ps(y, u, w), FoS[y], z);                // sum_a P Fov[k,a]
            x1 = fma(ps(y, w, u), Lba[w * T + y], x1);      // sum_a P L[j,k,b,a]
          }
        }
  #pragma unroll
        for (int o = T / 2; o > 0; o /= 2) x1 += __shfl_xor_sync(~0u, x1, o);
        (tid < T2 ? sZ2a : sZ2m)[u * T + w] += z;
        if (w == 0) (tid < T2 ? sX1a : sX1m)[u] += x1;
      }
      __syncthreads();
    }

    // ---- the chunk's X2l totals, added once into the row's X2l and
    // zeroed for the next chunk (each thread its own elements) ----
    const int64_t jvv = int64_t(j) * V2;
    Tacc* X2j = X2l + jvv * O;
    for (int x = tid; x < nl * T2; x += THREADS) {
      const int64_t l = l0 + x / T2;
      const int u = (x % T2) / T, w = x % T;
      Tacc* X2jl = X2j + l * V2;
      if (a0 + u < nv && b0 + w < nv)
        atomicAdd(&X2jl[(a0 + u) * V + b0 + w], sXa[x]);
      if (a0 + u < nv && c0 + w < nv)
        atomicAdd(&X2jl[(a0 + u) * V + c0 + w], sXb[x]);
      if (c0 + u < nv && b0 + w < nv)
        atomicAdd(&X2jl[(c0 + u) * V + b0 + w], sXc[x]);
      sXa[x] = sXb[x] = sXc[x] = Tacc(0);
    }
    __syncthreads();
  }

  // ---- the block's other totals, added once into the row's outputs ----
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
}

template <typename Tin, typename Tacc, int VEC>
int launch(int i, const void* Wv, const void* t2m, const void* Otm,
           const void* Ev, const void* G, const void* Eo, const void* L,
           const void* Fov, const void* eps, const void* t2, void* X1a,
           void* X1m, void* Z1, void* Z1m, void* Z2a, void* Z2m, void* X2l,
           int no, int nv, void* stream) {
  const int lc = chunk_of(no, nv, int(sizeof(Tacc)));
  if (lc < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = size_t(Layout(lc, nv).total) * sizeof(Tacc);
  cudaError_t err = cudaFuncSetAttribute(
      t_row_kernel<Tin, Tacc, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (nv + T - 1) / T;
  const dim3 grid(nt * nt * nt * no);
  t_row_kernel<Tin, Tacc, VEC><<<grid, THREADS, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      i, static_cast<const Tin*>(Wv), static_cast<const Tin*>(t2m),
      static_cast<const Tin*>(Otm), static_cast<const Tin*>(Ev),
      static_cast<const Tin*>(G),
      static_cast<const Tin*>(Eo), static_cast<const Tin*>(L),
      static_cast<const Tacc*>(Fov), static_cast<const Tacc*>(eps),
      static_cast<const Tin*>(t2), static_cast<Tacc*>(X1a),
      static_cast<Tacc*>(X1m), static_cast<Tacc*>(Z1),
      static_cast<Tacc*>(Z1m), static_cast<Tacc*>(Z2a),
      static_cast<Tacc*>(Z2m), static_cast<Tacc*>(X2l), no, nv, lc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vec = 2 stages two consecutive elements a copy: the caller passes it
// when nv and no are even and the staged operands (Wv, t2m, Otm, Ev, t2)
// are aligned to two elements, else 1
#define T_ROW_ENTRY(NAME, TIN, TACC)                                          \
  int NAME(int i, const void* Wv, const void* t2m, const void* Otm,           \
           const void* Ev, const void* G, const void* Eo, const void* L,      \
           const void* Fov, const void* eps, const void* t2, void* X1a,       \
           void* X1m, void* Z1, void* Z1m, void* Z2a, void* Z2m, void* X2l,   \
           int no, int nv, int vec, void* stream) {                           \
    if (vec == 2)                                                             \
      return launch<TIN, TACC, 2>(i, Wv, t2m, Otm, Ev, G, Eo, L, Fov, eps,    \
                                  t2, X1a, X1m, Z1, Z1m, Z2a, Z2m, X2l, no,   \
                                  nv, stream);                                \
    if (vec == 1)                                                             \
      return launch<TIN, TACC, 1>(i, Wv, t2m, Otm, Ev, G, Eo, L, Fov, eps,    \
                                  t2, X1a, X1m, Z1, Z1m, Z2a, Z2m, X2l, no,   \
                                  nv, stream);                                \
    return static_cast<int>(cudaErrorInvalidValue);                           \
  }

T_ROW_ENTRY(t_row_f64, double, double)
T_ROW_ENTRY(t_row_f32, float, float)
T_ROW_ENTRY(t_row_bf16, __nv_bfloat16, float)

#undef T_ROW_ENTRY

// bytes of dynamic shared memory one block takes, for a tile type of
// acc_bytes bytes (past SMEM_BUDGET when not even one l fits)
long long t_row_smem_bytes(int no, int nv, int acc_bytes) {
  const int lc = chunk_of(no, nv, acc_bytes);
  return static_cast<long long>(Layout(lc > 0 ? lc : 1, nv).total) *
         acc_bytes;
}

// the occupied indices l a block stages at once (0 when none fits)
int t_row_chunk(int no, int nv, int acc_bytes) {
  return chunk_of(no, nv, acc_bytes);
}

const char* t_row_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
