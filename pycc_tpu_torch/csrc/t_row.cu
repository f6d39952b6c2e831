// t_row: the seven (T) energy projections of one occupied row i.
//
// For each (j, k) the connected triples amplitude t3[i,j,k] over (a, b, c)
// is built from twelve contractions (six Wvvvo x t2 terms over a virtual
// index e, six Wovoo x t2 terms over an occupied index m) and divided by
// eps_i + eps_j + eps_k - eps_a - eps_b - eps_c.  The energy needs only
// projections of t3, summed over k, and X1a, X1m and X2l, whose weights in
// the energy carry no j, summed over j too:
//
//   X1a[a]       = sum_jkbc t3[j,k,a,b,c] L[j,k,b,c]
//   X1m[c]       = sum_jkab t3[j,k,a,b,c] L[j,k,b,a]
//   Z1[j,a,d]    = sum_kbc t3[j,k,a,b,c] (2 Ev[d,k,b,c] - Ev[d,k,c,b])
//   Z1m[j,c,d]   = sum_kab t3[j,k,a,b,c] Ev[d,k,b,a]
//   Z2a[j,a,b]   = sum_kc  t3[j,k,a,b,c] Fov[k,c]
//   Z2m[j,b,c]   = sum_ka  t3[j,k,a,b,c] Fov[k,a]
//   X2l[l,a,b]   = sum_jkc (2 t3[j,k,a,b,c] - t3[j,k,a,c,b] - t3[j,k,c,b,a])
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
// device memory: each tile lives in shared memory only.
//
// Replaces the TPU kernel K2, pycc_tpu/ops/kernels/triples.py::
// t_energy_row_pallas (body `_t_row_kernel`).  That kernel held a whole
// (v, v, v) cube of t3 in the TPU's ~128 MB of VMEM per grid cell, walked a
// sequential (j, k) grid and carried its sums from one grid step to the
// next.  Here a block owns one 8 x 8 x 8 tile (a0, b0, c0) of (a, b, c)
// and two rows j, and runs their k loops itself.  t3[i,j,k]^{abc} =
// t3[i,k,j]^{acb}, since W is the full six-permutation sum and the
// denominator is symmetric, so the tile of (j, k) is also the tile
// (a0, c0, b0) of (k, j) with b and c swapped, its image: each unordered
// (j, k) is built once, for k >= j, and projected twice, into row j and,
// through the image's relabelled sums (the k-indexed operands swapped for
// the j-indexed ones), into row k; a diagonal pair is its own image.  The
// projections of the (ac) and (bc) images within a tile (X1m, Z1m, Z2m and
// two of the three X2l terms) are formed from the same tile by relabelling
// too, so t3 is built once per unordered element.  Block rp of a tile owns
// rows rp and no - 1 - rp, so every block builds no + 1 pairs.  Sums that
// stay with the block (row j's Z2 and X1, X2l over j and k) are added once,
// with atomicAdd, into outputs that the caller zeroes; Z1 and Z1m as each
// Z1 stage ends, and the image's Z2 as its pair ends, the same way.  The
// image's Z1 products read G and Ev of row j, which a row's pairs share,
// so a pair's wait for the next pair's and both run over one staging.
// Ragged a, b, c are masked.
//
// What bounds it: at (H2O)_6/cc-pVDZ, (no, nv) = (24, 114), one row's
// arithmetic counted over all (j, k), o^2 v^3 = 8.5e8 t3 elements at
// 6 (v + o) = 828 FMA each (1.4e12 flop) and 3 (v + o) FMA more on the
// projections (0.4e12 flop), takes 29 ms at the FP64 tensor cores'
// 67 TFLOP/s; the symmetric build does a little over half of it.  A block
// of four warps (two an SM, held there by shared memory and registers)
// waits out each stage's round trip through L2, its barrier and its copy
// instructions: with the copies of the build made zero-size a row of the
// all-pairs build took 212 ms of 287, with no copy issued at all 152 ms,
// and without the build's DMMA 286 ms.  So the time follows the stages a
// row runs: 27 build stages (3 groups x 9 of 32 steps of 2 (v + o)) and
// 8 Z1 stages (Z1 and Z1m, 4 of 32 d each) a pair, and 8 more for the
// image's Z1 and Z1m of one or two pairs: 300 x 35 + 144 x 8 = 11652
// stages a tile and row against the all-pairs build's 576 x 35 = 20160.
// A Z1 stage, with its three barriers and its reduction across the warps,
// costs about two build stages, and the blocks of a tile must run the
// same k together to share their operands in L2.  On the H100 a row took
// 272 ms with the all-pairs build and takes 187 ms: 235 ms with each
// row's k walked upwards, 211 ms with them aligned, 205 ms with X2l summed
// over j in shared memory instead of the image's sums added into row k,
// 187 ms with the image's Z1 products of two pairs together.  At
// (24, 216) a row took 3.34 s and takes 1.64 s: with no Z1 sums in shared
// memory two blocks an SM fit there too.  (Tried and slower: the
// all-pairs build's thread-block clusters multicasting the j-independent
// segments, 852 ms; per-block bulk copies; a pitch-34 stage; Z1 by two
// warps without the reduction, 213-217 ms against 211; the next pair's
// first stage issued before the projections, no faster; tiles ordered in
// strips of 1 x 4, 2 x 4 or 3 x 3 along a and b, within 2%.)  The design:
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
//   - Z1 and Z1m are DMMA products too, (32 d) x (8 a, b or c) over the 64
//     pairs of the tile, with G and Ev staged so that consecutive threads
//     read consecutive elements (for the image, G[d,j,c,b] and Ev[d,j,c,a]
//     along their last axis, read transposed); the four warps' partial
//     sums meet in shared memory and go to the outputs with atomicAdd.  A
//     pair whose next pair is an image too keeps its tile in the second
//     tile buffer, and the next pair's image stages run over both;
//   - the operands stream through a cp.async ring in shared memory, 32
//     contraction steps (or 32 d) a stage, so the copies of the next
//     stages overlap the products of this one; when no and nv are even a
//     copy moves two elements (16 bytes in float64, past L1).  A float64
//     tile has three stages (Ring<true>): the 8 single rows ride in the
//     64 pair rows' padding, the Z1 partial sums in the slot of their own
//     stage, and a pair's small operands (Eo, Fov, L), of row j and of the
//     image, in the two slots its last stages leave free, so that three
//     stages, two tiles and the block's sums allow two blocks an SM
//     (113152 bytes at no = 24).  Three stages in the float32 placement (single rows after
//     the pair rows, the sums and small operands in regions of their own)
//     took one block an SM and 397 ms a row of the all-pairs build.  A
//     float32 tile keeps two stages (Ring<false>): a third made its row
//     slower;
//   - the occupied index l of Eo and of the X2l sums is staged in chunks
//     of lc: all no when they fit in what a block may take (in float64
//     8 (8000 + 256 lc) bytes, whatever nv, and at most 89, what a ring
//     slot holds of Eo), else as many as fit, so no occupied size is
//     refused.  A later chunk rebuilds the t3 tiles of every pair for its
//     own X2l sums and runs nothing else, so past one chunk a row costs
//     about no / lc builds;
//   - row rp walks k down from no - 1, row no - 1 - rp up to it, and the
//     blocks of a tile run together, so that at any time they run at most
//     two k and share their k-dependent operands in L2;
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
// the small operands of a pair's projections into one row: Eo on the
// tile's a, b and c for lc occupied l, then SMALL more: Fov on the three,
// and two 8 x 8 slices of L
constexpr int SMALL = 3 * T + 2 * T2;

// The operand ring, by tile type.  A stage holds the build's 64 pair rows
// and 8 single rows, or one (DC, 64) slice of G or Ev for the Z1 products.
// Float64 tiles (DEEP): three stages, so that two are in flight while one
// is read, in the shared memory of two blocks an SM at (24, 114): the
// single rows ride in the pair rows' last PX - XC columns (single_at), and
// a pair's two sets of small operands in the ring slots that its last
// stages leave free, so lc is at most LC_SLOT.  Float32 tiles: two
// stages, the single rows after the pair rows, the small operands in
// regions of their own.
template <bool DEEP_>
struct Ring {
  static constexpr bool DEEP = DEEP_;
  static constexpr int NSTAGE = DEEP ? 3 : 2;
  static constexpr int ROWS = DEEP ? T2 : T2 + T;
  static constexpr int STAGE = ROWS * PX > DC * PE ? ROWS * PX : DC * PE;
  // where single row s keeps contraction step x: for DEEP, steps
  // x .. x + 3 (x a multiple of 4) in the last four columns of pair row
  // (x / 4) T + s, so that an mma fragment's four k and eight n fall on
  // distinct banks
  __host__ __device__ static constexpr int single_at(int s, int x) {
    return DEEP ? ((x / 4) * T + s) * PX + XC + x % 4 : (T2 + s) * PX + x;
  }
  // single_at(s, x + 4 m) = single_at(s, x) + m SQ
  static constexpr int SQ = DEEP ? T * PX : 4;
  // the most l whose small operands a slot holds (read for DEEP)
  static constexpr int LC_SLOT = (STAGE - SMALL) / (3 * T);
};

static_assert(THREADS == 4 * 32 && T == 8, "four warps, one 16-row slice each");
static_assert(MT == 2, "a Z1 stage is two d tiles, one accumulator chain each");
static_assert(PX - XC == 4 && XC / 4 == T,
              "the pair rows' last columns hold the single rows");
static_assert(2 * THREADS * 4 * MT <= Ring<true>::STAGE,
              "the Z1 partial sums of two tiles fit a slot");
static_assert(XC % 32 == 0, "a build stage is two bf16 mma steps");
static_assert(Ring<true>::LC_SLOT >= 1,
              "a ring slot holds the small operands of one l");
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
// operands are float32 values in shared memory that hold bf16 values, so
// taking their upper halves is exact: a points at A(g, 2t) (rows of pitch
// PX), b and b8 at B(2t, g) and B(2t + 8, g), each pair of consecutive k
// one 8-byte load.
__device__ __forceinline__ void mma_k16_bf16(float (&c)[4], const float* a,
                                             const float* b,
                                             const float* b8) {
  auto pack = [](const float* p) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    // the bf16 of k in the low half, of k + 1 in the high half
    return __byte_perm(__float_as_uint(x.x), __float_as_uint(x.y), 0x7632);
  };
  const unsigned a0 = pack(a), a1 = pack(a + 8 * PX), a2 = pack(a + 8),
                 a3 = pack(a + 8 * PX + 8);
  const unsigned b0 = pack(b), b1 = pack(b8);
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Shared-memory layout, in elements of the tile type, for chunks of lc
// occupied indices l of the X2l sums (and of Eo, when the small operands
// have a region of their own).  No size depends on nv.  The host computes
// the same size through t_row_smem_bytes.
struct Layout {
  int ps, st, red, eo, x2a, x2b, x2c, x2d, total;
  __host__ __device__ Layout(int lc, bool deep) {
    int o = 0;
    ps = o;  o += 2 * T * PS;      // two t3 tiles, [a][b * T + c], pitch PS
    st = o;                        // the operand ring
    o += deep ? Ring<true>::NSTAGE * Ring<true>::STAGE
              : Ring<false>::NSTAGE * Ring<false>::STAGE;
    red = o;                       // float32 tiles: the Z1 partial sums
    if (!deep) o += 2 * THREADS * 4 * MT;   // of two tiles
    eo = o;                        // and the small operands of row j's
    if (!deep) o += 2 * (3 * lc * T + SMALL);   // and of row k's sums
    x2a = o; o += lc * T2;         // the block's sums, over j and k:
    x2b = o; o += lc * T2;         //   X2l[l,a,b], X2l[l,a,c],
    x2c = o; o += lc * T2;         //   X2l[l,c,b] and X2l[l,b,c]
    x2d = o; o += lc * T2;
    total = o;
  }
};

// Dynamic shared memory a block may take: the card's 232448 bytes less
// the kernel's static arrays (seg_p, seg_q, seg_n: 480 bytes) and room
// to spare.
constexpr long long SMEM_BUDGET = 232448 - 1024;

// The chunk of occupied l a block stages: all no when they fit (and are
// at most LC_SLOT), else the most that fit, so that the X2l sums of a
// chunk stay on chip.
__host__ __device__ inline int chunk_of(int no, int acc_bytes) {
  const bool deep = acc_bytes == 8;
  const int cap = deep ? Ring<true>::LC_SLOT : no;
  for (int lc = no < cap ? no : cap; lc > 0; --lc)
    if (static_cast<long long>(Layout(lc, deep).total) * acc_bytes <=
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
  using R = Ring<sizeof(Tacc) == 8>;
  constexpr int NSTAGE = R::NSTAGE, STAGE = R::STAGE;
  const Layout lay(lc, R::DEEP);
  Tacc* Ps = sm + lay.ps;             // the pair's tile
  Tacc* St = sm + lay.st;
  Tacc* sXa = sm + lay.x2a;
  Tacc* sXb = sm + lay.x2b;
  Tacc* sXc = sm + lay.x2c;
  Tacc* sXd = sm + lay.x2d;
  auto ps = [&](int a, int b, int c) -> Tacc& { return Ps[a * PS + b * T + c]; };
  using St_t = Stager<Tin, Tacc, VEC>;
  using C = Copies<VEC>;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nt = (nv + T - 1) / T;
  // a block owns rows rp and no - 1 - rp (rp alone in the middle of an
  // odd no), the blocks of one tile run together
  const int nr = (no + 1) / 2;
  const int tile = blockIdx.x / nr;
  const int rp = blockIdx.x % nr;
  const int a0 = (tile / (nt * nt)) * T;
  const int b0 = ((tile / nt) % nt) * T;
  const int c0 = (tile % nt) * T;

  const int V = nv, O = no, V2 = nv * nv, VO = nv * no;
  const int X = 2 * nv + 2 * no;          // the groups' contraction length
  const int NXC = (X + XC - 1) / XC;      // build stages a group
  const int NZ = (nv + DC - 1) / DC;      // stages of each Z1 product
  const int NB = 3 * NXC;
  const Tin* Wi = Wv + int64_t(i) * V2 * V;
  // a thread's place in a build stage: contraction steps xl .. xl + VEC - 1
  // of rows r2 + T r1 (pair) and r2 (single), for r2 = r2b + RP h
  const int xl = (tid % C::XV) * VEC, r2b = tid / C::XV;
  // the thread's sums over k of one Z2 element of row j and of one X1
  // partial, and of one X1m partial of the images
  Tacc z2sum, x1sum, x1img;

  // the build's twelve terms for this (j, k), one entry (grp * 4 + seg)
  // each: the pair operand at p + r1 sr1 + r2 sr2 + x, the single one at
  // q + s ss + x (p and q already at the tile's origin), and the numbers
  // of in-range pair rows r1, r2 and single rows s
  __shared__ const Tin* seg_p[12];
  __shared__ const Tin* seg_q[12];
  __shared__ int seg_n[12][6];

  int gs = 0;                          // stages the block has run
  for (int rr = 0; rr < 2; ++rr) {
    const int j = rr == 0 ? rp : no - 1 - rp;
    if (rr == 1 && j == rp) break;
    for (int x = tid; x < lay.total - lay.x2a; x += THREADS)
      sm[lay.x2a + x] = Tacc(0);
    z2sum = x1sum = x1img = Tacc(0);
    // a pair's image Z1 products may wait for the next pair's, to run
    // together over one staging of G and Ev of row j: the held tile, in
    // the other tile buffer, and its k
    bool held = false;
    int kh = 0, pb = 0;
    const Tacc eij = eps[i] + eps[j];
    const Tin* Wj = Wv + int64_t(j) * V2 * V;

    // The occupied l of Eo and the X2l sums come in chunks of lc, one k loop
    // each.  The first chunk also runs the Z1 products and the other
    // projections; a later one rebuilds the t3 tiles for its X2l alone.
    for (int l0 = 0; l0 < no; l0 += lc) {
      const int nl = min(lc, no - l0);
      const bool first = l0 == 0;
      // t3[i,j,k] for k >= j: its tile (a0, b0, c0) is also t3[i,k,j] on
      // (a0, c0, b0) with b and c swapped, the image, whose projections are
      // row k's; a diagonal pair is its own image.  Row rp walks k down
      // from no - 1 and row no - 1 - rp up to it, so that the blocks of a
      // tile, which start together, run at most two k at a time and share
      // their k-dependent operands in L2
      for (int kq = 0; kq < no - j; ++kq) {
        const int k = rr == 0 ? no - 1 - kq : j + kq;
        const bool img = k != j;
        // the next pair of the row is an image too
        const bool next_img = rr == 0 ? k - 1 > j : k + 1 < no;
        const bool defer = first && img && !held && next_img;
        // the image stages run for the held tile and this pair's image
        const bool img_now = first && img && !defer;
        Ps = sm + lay.ps + pb * T * PS;
        Tacc* Ph = sm + lay.ps + (pb ^ 1) * T * PS;
        // stages of the pair: the build, then Z1 and Z1m of row j and of
        // the images whose products run now
        const int NQ = first ? NB + ((img_now || held) ? 4 : 2) * NZ : NB;
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
        const Tacc eijk = eij + eps[k];
        // the small operands of row j's projections (EoS) and of the
        // image's (EoI): for DEEP in the ring slots that the next pair's
        // first two stages take, whose last stages here were the pair's
        // third- and second-to-last, so they are free from the second-to-last
        // and the last step on
        Tacc* EoS = R::DEEP ? St + ((gs + NQ) % NSTAGE) * STAGE : sm + lay.eo;
        Tacc* EoI = R::DEEP ? St + ((gs + NQ + 1) % NSTAGE) * STAGE
                            : sm + lay.eo + 3 * lc * T + SMALL;

        // the small operands of row r's sums over s, (r, s) = (j, k) or, for
        // the image, (k, j), masked to the tile: Eo[r,s,l] on the tile's a,
        // b and c, Fov[s] on the three, L[r,s,b,c] at [b][c] and L[r,s,b,a]
        // at [b][a], or for the image L[k,j,c,b] at [b][c] and L[k,j,c,a] at
        // [c][a].  Copied as they are (for DEEP in the last two steps of the
        // pair, else with its first stage), or (bf16) widened at its end
        auto small_operands = [&](Tacc* dst, bool image, bool async) {
          const int r = image ? k : j, s = image ? j : k;
          const Tin* Eors = Eo + (int64_t(r) * O + s) * VO;
          const Tin* Lrs = L + (int64_t(r) * O + s) * V2;
          Tacc* FoD = dst + 3 * lc * T;
          Tacc* L1 = FoD + 3 * T;
          Tacc* L2 = L1 + T2;
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
            put(dst + x, Eors + (l0 + l) * V + gx, gx < nv && l < nl);
          }
          for (int x = tid; x < 3 * T; x += THREADS) {
            const int ax = x / T;
            const int gx = (ax == 0 ? a0 : (ax == 1 ? b0 : c0)) + x % T;
            put(FoD + x, Fov + int64_t(s) * V + gx, gx < nv);
          }
          for (int x = tid; x < T2; x += THREADS) {
            const int bb = b0 + x / T, cc = c0 + x % T, aa = a0 + x % T;
            const int r2 = (image ? c0 : b0) + x / T;
            put(L1 + x, Lrs + (image ? cc * V + bb : bb * V + cc),
                bb < nv && cc < nv);
            put(L2 + x, Lrs + r2 * V + aa, r2 < nv && aa < nv);
          }
        };

        // stage at cursor c, the block's gi-th, into ring slot gi % NSTAGE
        auto issue = [&](Cursor c, int gi, St_t& s) {
          Tacc* buf = St + (gi % NSTAGE) * STAGE;
          if constexpr (St_t::ASYNC && !R::DEEP) {
            if (c.part == 0 && c.idx == 0) {
              small_operands(EoS, false, true);
              if (img) small_operands(EoI, true, true);
            }
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
              s.copy(T * (T / C::RP) + h, buf + R::single_at(r2, xl),
                     seg_q[id] + r2 * seg_n[id][2] + e, valid);
            }
          } else {
            // part 3-6: G (Z1) and Ev (Z1m) at [d, k, b0 + xx, Y0 + yy] for
            // row j, at [d, j, c0 + xx, Y0 + yy] for the image, for DC d into
            // buf[d][xx * T + yy]: the consecutive threads of a d run along
            // yy, then xx
            constexpr int TD = T2 / VEC;      // threads to a d
            constexpr int DP = THREADS / TD;  // d a pass of the threads
            const int zp = c.part - 3;
            const int X0 = zp < 2 ? b0 : c0;
            const int Y0 = zp == 0 ? c0 : zp == 2 ? b0 : a0;
            const Tin* src0 =
                (zp % 2 == 0 ? G : Ev) + int64_t(zp < 2 ? k : j) * V2;
            const int inner = (tid % TD) * VEC;
            const int xx = X0 + inner / T, yy = Y0 + inner % T;
            const bool in = xx < nv && yy < nv;
            const int dl = tid / TD;
            const int d0 = c.idx * DC + dl;
            const Tin* src = src0 + int64_t(d0) * VO * V + xx * V + yy;
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
              issue(ci, gs + q, s);
              ci.next(NXC, NZ);
            }
            cp_commit();
          }
        } else {
          issue(ci, gs, s);
          ci.next(NXC, NZ);
          s.store();
        }
        for (int q = 0; q < NQ; ++q, cc.next(NXC, NZ)) {
          if constexpr (St_t::ASYNC) {
            cp_wait<NSTAGE - 2>();
            __syncthreads();
            // the slot filled here was read in step q - 1, before the barrier
            if (q + NSTAGE - 1 < NQ) {
              issue(ci, gs + q + NSTAGE - 1, s);
              ci.next(NXC, NZ);
            } else if (R::DEEP && q + NSTAGE - 1 == NQ) {
              small_operands(EoS, false, true);
            } else if (R::DEEP && img && q + NSTAGE - 1 == NQ + 1) {
              small_operands(EoI, true, true);
            }
            cp_commit();
          } else {
            if (q + 1 < NQ) {                  // into registers
              issue(ci, gs + q + 1, s);
              ci.next(NXC, NZ);
            }
            __syncthreads();
          }
          const Tacc* buf = St + ((gs + q) % NSTAGE) * STAGE;
          if (cc.part < 3) {
            // ---- the build: warp w's 16 pair rows of group cc.part ----
            const int grp = cc.part;
            const Tacc* Pr = buf + warp * 16 * PX;
            // the lane's place in the single rows is found once, the steps
            // are offsets (R::SQ)
            if constexpr (std::is_same_v<Tin, __nv_bfloat16>) {
              const Tacc* Sg = buf + R::single_at(g, 2 * t);
    #pragma unroll
              for (int kk = 0; kk < XC; kk += 16)
                mma_k16_bf16(acc[(kk / 16) % 2], Pr + g * PX + kk + 2 * t,
                             Sg + (kk / 4) * R::SQ, Sg + (kk + 8) / 4 * R::SQ);
            } else {
    #pragma unroll
              for (int kk = 0; kk < XC; kk += 4) {
                mma_k4(acc[(kk / 4) % 2], g, t,
                       [&](int r, int kq) { return Pr[r * PX + kk + kq]; },
                       [&](int kq, int n) {
                         return buf[R::single_at(n, kq) + (kk / 4) * R::SQ];
                       });
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
            // to each warp, added into row j (part 3, 4) and, for the
            // image, row k (part 5, 6):
            //   Z1[j, a, d]  += sum_bc t3[a,b,c] G[d,k,b,c]
            //   Z1m[j, c, d] += sum_ab t3[a,b,c] Ev[d,k,b,a]
            //   Z1[k, a, d]  += sum_bc t3[a,b,c] G[d,j,c,b]
            //   Z1m[k, b, d] += sum_ac t3[a,b,c] Ev[d,j,c,a]
            const int z = cc.idx;
            const int zp = cc.part - 3;
            // the tiles of the products: the pair's; for the image parts
            // (5, 6) the held tile (row kh) and, unless it waits, the
            // pair's (row k)
            const int ntl = zp < 2 ? 1 : int(held) + int(img_now);
            const Tacc* Pt[2] = {zp >= 2 && held ? Ph : Ps, Ps};
            const int kt[2] = {zp >= 2 && held ? kh : k, k};
            // one accumulator chain for each of the two d tiles, a tile
            Tacc zz[2][MT][4];
    #pragma unroll
            for (int u = 0; u < 2; ++u)
    #pragma unroll
              for (int h = 0; h < MT; ++h)
    #pragma unroll
                for (int r = 0; r < 4; ++r) zz[u][h][r] = Tacc(0);
            // the products over the tile pairs p: E[d][at(p)] against
            // P[pt(p, n)] for the output column n
            auto z1_mma = [&](auto at, auto pt) {
    #pragma unroll
              for (int u = 0; u < 2; ++u) {
                if (u >= ntl) break;
                const Tacc* P = Pt[u];
    #pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                  const Tacc* E = buf + mt * 16 * PE;
    #pragma unroll
                  for (int m = 0; m < 4; ++m) {
                    const int kk = warp * 16 + 4 * m;
                    mma_k4(zz[u][mt], g, t,
                           [&](int r, int kq) { return E[r * PE + at(kk + kq)]; },
                           [&](int kq, int n) { return P[pt(kk + kq, n)]; });
                  }
                }
              }
            };
            // staged along (b, c), or transposed: [x T + y] holds pair (y, x)
            auto tr = [](int p) { return (p % T) * T + p / T; };
            if (zp == 0)          // p = b T + c, n = a
              z1_mma([](int p) { return p; },
                     [](int p, int n) { return n * PS + p; });
            else if (zp == 1)     // p = a T + b, n = c
              z1_mma(tr, [](int p, int n) {
                return (p / T) * PS + (p % T) * T + n;
              });
            else if (zp == 2)     // p = b T + c, n = a
              z1_mma(tr, [](int p, int n) { return n * PS + p; });
            else                  // p = a T + c, n = b
              z1_mma(tr, [](int p, int n) {
                return (p / T) * PS + n * T + p % T;
              });
            // the four warps' partial sums meet in this stage's slot once every
            // warp has read it (DEEP), else in a region of their own
            Tacc* Red = R::DEEP ? const_cast<Tacc*>(buf) : sm + lay.red;
            if constexpr (R::DEEP) __syncthreads();
    #pragma unroll
            for (int u = 0; u < 2; ++u)
    #pragma unroll
              for (int mt = 0; mt < MT; ++mt)
    #pragma unroll
                for (int r = 0; r < 4; ++r)
                  if (u < ntl)
                    Red[((u * 4 + warp) * MT + mt) * THREADS + r * 32 + lane] =
                        zz[u][mt][r];
            __syncthreads();
    #pragma unroll
            for (int u = 0; u < 2; ++u) {
              if (u >= ntl) break;
    #pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                // thread (r, lane) sums the four warps' (d, col) of that place
                const int r = tid / 32, gg = (tid % 32) / 4, tt = tid % 4;
                const int d = z * DC + mt * 16 + gg + 8 * (r / 2);
                const int col = 2 * tt + r % 2;
                Tacc sum = Tacc(0);
    #pragma unroll
                for (int ww = 0; ww < 4; ++ww)
                  sum += Red[((u * 4 + ww) * MT + mt) * THREADS + tid];
                const int o = (zp % 2 == 0 ? a0 : zp == 1 ? c0 : b0) + col;
                if (d < nv && o < nv)
                  atomicAdd((zp % 2 == 0 ? Z1 : Z1m) +
                                int64_t(zp < 2 ? j : kt[u]) * V2 + o * V + d,
                            sum);
              }
            }
          }
          if constexpr (!St_t::ASYNC) {
            // the slot of stage q + 1 was last read in step q + 1 - NSTAGE
            if (q + 1 < NQ) s.store();
          }
        }
        gs += NQ;
        if constexpr (St_t::ASYNC) cp_wait<0>();
        __syncthreads();
        if constexpr (!St_t::ASYNC) {
          // the bf16 small operands, widened once the build is done
          small_operands(EoS, false, false);
          if (img) small_operands(EoI, true, false);
          __syncthreads();
        }

        // ---- the small projections of the tile, of row j and of the
        // image ----
        // X2l: the direct term and the (bc) and (ac) images, by relabelling.
        // A thread owns one (u, w) and every other l: it reads its eight t3
        // values of a term once and sweeps l against Eo (one row a warp).
        // The image's terms read the same eight values, but the last, which
        // sums over a at (b, c) = (u, w):
        //   X2l[l,a,b] -= sum_c t3[a,b,c] Eo[k,j,l,c]
        //   X2l[l,a,c] += 2 sum_b t3[a,b,c] Eo[k,j,l,b]
        //   X2l[l,b,c] -= sum_a t3[a,b,c] Eo[k,j,l,a]
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
            if (!img) continue;
            if (term == 2) {
    #pragma unroll
              for (int y = 0; y < T; ++y) p[y] = ps(y, u, w);
            }
            Tacc* sXi = term == 0 ? sXa : term == 1 ? sXb : sXd;
            const Tacc fi = term == 1 ? Tacc(2) : Tacc(-1);
            for (int l = tid / T2; l < nl; l += THREADS / T2) {
              Tacc eo[T];
              load_row(eo, EoI + (ax * lc + l) * T);
              Tacc acc2 = Tacc(0);
    #pragma unroll
              for (int y = 0; y < T; ++y) acc2 = fma(p[y], eo[y], acc2);
              sXi[l * T2 + uw] += fi * acc2;
            }
          }
        }
        // Z2a[a,b], Z2m[b,c], X1a[a], X1m[c]: one Z2 element and one X1
        // partial (over the eight c, or the eight a) a thread, the X1 partials
        // summed over b across the eight lanes that share a (or c); the
        // image's Z2a[k,a,c] and Z2m[k,c,b] likewise, and its X1a[a] and
        // X1m[b] partials summed over c; the first chunk's only
        if (first) {
          const int u = (tid % T2) / T, w = tid % T;
          const Tacc* FoS = EoS + 3 * lc * T;
          const Tacc* Lbc = FoS + 3 * T;
          const Tacc* Lba = Lbc + T2;
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
          z2sum += z;
          x1sum += x1;                   // kept where w == 0
          if (img) {
            const Tacc* FoI = EoI + 3 * lc * T;
            const Tacc* Lcb = FoI + 3 * T;     // L[k,j,c,b] at [b][c]
            const Tacc* Lca = Lcb + T2;        // L[k,j,c,a] at [c][a]
            z = x1 = Tacc(0);
            if (tid < T2) {          // (a, c) = (u, w)
    #pragma unroll
              for (int y = 0; y < T; ++y) {
                z = fma(ps(u, y, w), FoI[T + y], z);          // sum_b P Fov[j,b]
                x1 = fma(ps(u, y, w), Lcb[y * T + w], x1);    // sum_b P L[k,j,c,b]
              }
            } else {                 // (b, c) = (u, w)
    #pragma unroll
              for (int y = 0; y < T; ++y) {
                z = fma(ps(y, u, w), FoI[y], z);              // sum_a P Fov[j,a]
                x1 = fma(ps(y, u, w), Lca[w * T + y], x1);    // sum_a P L[k,j,c,a]
              }
            }
    #pragma unroll
            for (int o = T / 2; o > 0; o /= 2) x1 += __shfl_xor_sync(~0u, x1, o);
            const int64_t kvv = int64_t(k) * V2;
            if (tid < T2) {
              if (a0 + u < nv && c0 + w < nv)
                atomicAdd(&Z2a[kvv + (a0 + u) * V + c0 + w], z);
              x1sum += x1;             // X1a[a0 + u], kept where w == 0
            } else {
              if (b0 + u < nv && c0 + w < nv)
                atomicAdd(&Z2m[kvv + (c0 + w) * V + b0 + u], z);
              x1img += x1;             // X1m[b0 + u], kept where w == 0
            }
          }
        }
        __syncthreads();
        // a held tile's image products have run unless this pair waits
        held = defer;
        if (defer) {
          kh = k;
          pb ^= 1;
        }
      }

      // ---- the chunk's X2l totals, added once into X2l and zeroed for
      // the next chunk (each thread its own elements) ----
      for (int x = tid; x < nl * T2; x += THREADS) {
        const int64_t l = l0 + x / T2;
        const int u = (x % T2) / T, w = x % T;
        Tacc* X2ll = X2l + l * V2;
        if (a0 + u < nv && b0 + w < nv)
          atomicAdd(&X2ll[(a0 + u) * V + b0 + w], sXa[x]);
        if (a0 + u < nv && c0 + w < nv)
          atomicAdd(&X2ll[(a0 + u) * V + c0 + w], sXb[x]);
        if (c0 + u < nv && b0 + w < nv)
          atomicAdd(&X2ll[(c0 + u) * V + b0 + w], sXc[x]);
        if (b0 + u < nv && c0 + w < nv)
          atomicAdd(&X2ll[(b0 + u) * V + c0 + w], sXd[x]);
        sXa[x] = sXb[x] = sXc[x] = sXd[x] = Tacc(0);
      }
      __syncthreads();
    }

    // ---- row j's other totals, added once into its outputs: thread (u, w)
    // of the first 64 holds Z2a[a0 + u, b0 + w] (and, at w = 0,
    // X1a[a0 + u]), of the others Z2m[b0 + u, c0 + w] (X1m[c0 + u] and
    // X1m[b0 + u]) ----
    const int64_t jvv = int64_t(j) * V2;
    {
      const int u = (tid % T2) / T, w = tid % T;
      if (tid < T2) {
        if (a0 + u < nv && b0 + w < nv)
          atomicAdd(&Z2a[jvv + (a0 + u) * V + b0 + w], z2sum);
        if (w == 0 && a0 + u < nv) atomicAdd(&X1a[a0 + u], x1sum);
      } else {
        if (b0 + u < nv && c0 + w < nv)
          atomicAdd(&Z2m[jvv + (b0 + u) * V + c0 + w], z2sum);
        if (w == 0 && c0 + u < nv) atomicAdd(&X1m[c0 + u], x1sum);
        if (w == 0 && b0 + u < nv) atomicAdd(&X1m[b0 + u], x1img);
      }
    }
    // the next row zeroes these sums
    __syncthreads();
  }
}

template <typename Tin, typename Tacc, int VEC>
int launch(int i, const void* Wv, const void* t2m, const void* Otm,
           const void* Ev, const void* G, const void* Eo, const void* L,
           const void* Fov, const void* eps, const void* t2, void* X1a,
           void* X1m, void* Z1, void* Z1m, void* Z2a, void* Z2m, void* X2l,
           int no, int nv, void* stream) {
  const int lc = chunk_of(no, int(sizeof(Tacc)));
  if (lc < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      size_t(Layout(lc, sizeof(Tacc) == 8).total) * sizeof(Tacc);
  cudaError_t err = cudaFuncSetAttribute(
      t_row_kernel<Tin, Tacc, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (nv + T - 1) / T;
  const dim3 grid(nt * nt * nt * ((no + 1) / 2));
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
// acc_bytes bytes
long long t_row_smem_bytes(int no, int acc_bytes) {
  return static_cast<long long>(
             Layout(chunk_of(no, acc_bytes), acc_bytes == 8).total) *
         acc_bytes;
}

// the occupied indices l a block stages at once
int t_row_chunk(int no, int acc_bytes) { return chunk_of(no, acc_bytes); }

const char* t_row_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
