// block_sparse_attn.cu — MRA-2 block-sparse attention for training on Hopper
// (sm_90a): the forward, dq and dk/dv kernels.
//
// Replaces the TPU kernels of repro/kernels/block_sparse_attn.py:
//   bsa_fwd_kernel     <- _fwd_kernel     (pallas_call in block_sparse_attention_fwd)
//   bsa_bwd_dq_kernel  <- _bwd_dq_kernel  (first pallas_call in block_sparse_attention_bwd)
//   bsa_bwd_dkv_kernel <- _bwd_dkv_kernel (second pallas_call in block_sparse_attention_bwd)
//
// Contract (kernels/block_sparse_attn.py): for every selected (query block
// x, key block y) pair of a BHG row, s = q_x·k_yᵀ·scale under the mask
// flags bit0 (pair valid) ∧ (bit1 ⇒ causal triangle i >= j) ∧ key mask.
//   forward: the per-token stabilizer mt = max(c[x], masked row maxima)
//     seeds at the floor c and rises online; a = exp(min(s − mt, 0));
//     outputs the unnormalized numerator Σ a·v, the row sums Σ a and mt.
//     A query tile that no pair visits comes out as 0 / 0 / c.
//   dq:  recompute a from the forward's mt, ds = a ⊙ (do·vᵀ + dr),
//        dq = Σ ds·k·scale.
//   dkv: over each KV head's pairs of all G groups, sorted by key block,
//        dk = Σ dsᵀ·q·scale and dv = Σ aᵀ·do (the GQA reduction inside).
//
// Ownership. The TPU grid runs in order and keeps an output tile resident in
// VMEM while consecutive grid steps revisit it (first-visit flags, coverage
// padding). Here every output tile has exactly one owning thread block that
// walks that tile's CSR list of pairs (row_ptr offsets built by the wrapper)
// in a fixed order and zero-initializes its accumulators itself: no atomics,
// no first-visit flags, no coverage padding, and results that are bitwise
// the same from run to run. The grids are one-dimensional over (tile, row
// sub-tile) and map the tile through `order`, which the wrapper sorts
// heaviest first (most pairs), so the longest pair lists start in the first
// wave; a balanced selection keeps the natural order.
//
// What bounds the three kernels on this card: operations. A pair costs
// 2·b²·d multiply-adds per product (2 in the forward, 3 in dq, 4 in dk/dv) in
// the reference's fp32, about 250 FLOP per byte moved at b = d = 128 — below
// the bf16 tensor-core ridge point (295) and far above the fp32 CUDA-core one
// (20). What their design does about it:
//   * Every product runs on tensor cores as mma.sync.m16n8k16 bf16 with fp32
//     accumulators, in fp32 accuracy: an fp32 operand is split into three
//     bf16 terms that sum to it exactly (split3) and the products of terms
//     i + j <= 2 are kept (what is dropped is below 2^-24 of the product).
//     bf16 q/k/v need no split. At bf16 inputs the forward does 1 + 3 bf16
//     products per pair (S = q·kᵀ; P·v with P split), dq 1 + 3 + 3 (S;
//     dP = do·vᵀ with do split; dq += dS·k with dS split), dk/dv
//     1 + 3 + 6 + 3 (Sᵀ = k·qᵀ; dPᵀ = v·doᵀ with do split; dv += aᵀ·do, both
//     split; dk += dsᵀ·q with ds split). With fp32 q/k/v every operand of
//     those output products is split, and the scores S and dP (below) run
//     on CUDA cores.
//   * One warp owns 16 rows outright (query rows in the forward and dq, key
//     rows in dk/dv), so its softmax weights and its accumulators never leave
//     its registers: no exchange between warps, and each output is written
//     once. A block is four warps, 64 rows (all b rows when b < 64).
//   * Above D = 128 (recurrentgemma's D = 256) a warp's accumulators over the
//     whole D would not fit its 255 registers (o 128, dq 128, dk and dv 256
//     a thread), so DS = D / 128 warps share each 16 rows: each owns 128
//     columns of o / dq / dk / dv, and each computes the rows' scores (S,
//     dP) over the whole D itself, from q in shared-memory planes (not
//     registers). The DS warps run the same instructions on the same data,
//     so their weights and stabilizers are the same bits, and no partial
//     product crosses warps: no atomics, no exchange, results bitwise the
//     same from run to run. The price is the score products done DS times
//     (the forward 5 bf16 products a pair where 4 would do, dq 11 for 7,
//     dk/dv 17 for 13). A bf16 block is 64 rows (eight warps, one block an
//     SM); an fp32 one is 32 rows with 16-key (16-query) stages, the most
//     whose split planes fit a block's shared memory.
//   * Operands are staged in their own type by 16-byte cp.async copies into a
//     two-slot ring: the next stage is in flight while the current one is
//     computed. A bf16 operand lands in a tile that ldmatrix reads free of
//     bank conflicts (PlaneRow: XOR-swizzled rows, or at D = 80 rows padded
//     from ten to eleven 16-byte chunks); an fp32 one (do, and fp32 q/k/v) is
//     split into three bf16 tiles once per block, so the four warps share
//     the split.
//   * Forward and dq: the warp's bf16 q fragments stay in registers for the
//     whole pair list; K/V and the key mask stream in stages of 64 keys (32
//     for fp32 inputs). dq splits the block's do rows (and fp32 q rows) into
//     three planes once; per stage it computes S and dP, the weights, then
//     dq += dS·k with dS turned from accumulator into A fragments in
//     registers; dq (64 registers beside q's 32 and S's and dP's 64) stays
//     in registers over the whole pair list. dk/dv: the
//     block's K/V rows are staged once; the pairs' q, do, mt and dr stream in
//     stages of 32 queries, 16 at a time; Aᵀ and dSᵀ turn from accumulator
//     into A fragments in registers (as FlashAttention-2's backward) and
//     never go through shared memory; dk and dv accumulate in registers over
//     the whole pair list (128 of a thread's <= 255) and are written once.
//   * Precision of the scores. The tensor cores' fp32 accumulation is not
//     rounded to nearest at each step, so the bf16 scores take each k-step's
//     products from zero and add them in fp32. Above D = 128 (256 terms a
//     score) that rounding comes close to the 1e-5 that mt is held to, so
//     there the forward recomputes the few scores near each stage's maximum
//     with sequential fp32 FMAs over d. fp32 inputs are the parity route:
//     there every score S (and dP = do·vᵀ in the backward) is a sequential
//     fp32 FMA sum over d, the order a plain fp32 product sums it in, so
//     the weights exp(s − mt) and ds = a ⊙ (dP + dr) carry the reference's
//     own rounding. Through the exponent an error in s scales the weight by
//     e^err: at the logits of a saturated softmax (|s·scale| in the
//     hundreds, recurrentgemma's MQA keys at its initialization) the
//     truncating split products moved the row sums by 4e-3 and the
//     gradients by 3e-3 (NVIDIA H100 80GB HBM3, 700 W).
//   * A stage that holds no live score of the block's rows (an invalid pair,
//     or the keys above every row of a diagonal block) is neither loaded nor
//     computed: it would add exactly zero. In dq a warp also skips a stage
//     of a diagonal block whose keys lie above all of its own rows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas=-v (repro_torch/kernels/build.py); plain C
//        entry points, loaded with ctypes. All three kernels are
//        instantiated for (head dim, block size) = (128, 128), (64, 64),
//        (16, 16), (64, 128), (80, 128), (64, 32) and (256, 128), bf16 and
//        fp32 (42 kernels); the wrapper zero-pads a head dim to the next
//        multiple of 16 (exact for the products).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr float kNegInf = -1e9f;  // repro NEG_INF

// ==========================================================================
// tensor-core products over cp.async-staged tiles
// ==========================================================================
// bf16 terms of an input type: bf16 is exact, fp32 takes three
template <typename T>
struct Terms;
template <>
struct Terms<__nv_bfloat16> {
  static constexpr int n = 1;
};
template <>
struct Terms<float> {
  static constexpr int n = 3;
};

// A "plane" is a bf16 tile of rows x D read by ldmatrix, laid out by
// PlaneRow<D>: rows of D / 8 16-byte chunks, XOR-swizzled where that count
// is a power of two, else padded to an odd count. A raw tile holds rows as
// they are in device memory (fp32 rows of D floats).

// copy ROWS rows of RB bytes (device row stride RB) into a tile: as a bf16
// plane (PLANE, RB = 2·D) or as they are (raw). Where the block's threads
// cover whole rows, a thread copies one 16-byte chunk column of every
// NT / CPR-th row, so its plane offset is the same in each row it copies
// and its addresses step by constants; otherwise (ten chunks a row: D = 80)
// the threads take the chunks in order. The constant-stride path is kept
// for registers and speed: with the in-order loop alone the bf16 (128, 128)
// dq and dk/dv kernels spill at 255 registers and the power-of-two shapes
// run 6-10% slower (NVIDIA H100 80GB HBM3, 700 W).
template <int RB, bool PLANE, int NT, int ROWS>
__device__ __forceinline__ void stage(unsigned char* dst, const void* src) {
  constexpr int CPR = RB / 16;
  using P = PlaneRow<RB / 2>;
  const char* s = static_cast<const char*>(src);
  if constexpr (NT % CPR == 0 &&
                (!PLANE || !P::SWZ || (NT / CPR) % cmin(CPR, 8) == 0)) {
    constexpr int STEP = NT / CPR, DRB = PLANE ? P::BYTES : RB;
    const int r0 = threadIdx.x / CPR, ch = threadIdx.x % CPR;
    unsigned char* d = dst + (PLANE ? P::at(r0, ch) : r0 * RB + ch * 16);
    s += (size_t)r0 * RB + ch * 16;
#pragma unroll
    for (int r = 0; r < ROWS; r += STEP)
      if (ROWS % STEP == 0 || r0 + r < ROWS)
        cp16(d + r * DRB, s + (size_t)r * RB, true);
  } else {
    for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
      const int row = i / CPR, ch = i - row * CPR;
      cp16(dst + (PLANE ? P::at(row, ch) : i * 16), s + (size_t)i * 16, true);
    }
  }
}

// raw fp32 rows (rows x D) -> three planes of rows x D, `pstride` bytes
// apart, largest term first
template <int D, int NT>
__device__ __forceinline__ void split_rows(unsigned char* planes, int pstride,
                                           const float* raw, int rows) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < rows * C4; i += NT) {
    const int row = i / C4, c = i - row * C4;  // floats 4c .. 4c + 3
    const float4 x = reinterpret_cast<const float4*>(raw)[i];
    uint32_t lo[3], hi[3];
    split3(x.x, x.y, lo);
    split3(x.z, x.w, hi);
    const int off = PlaneRow<D>::at(row, c >> 1) + (c & 1) * 8;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      *reinterpret_cast<uint2*>(planes + j * pstride + off) = make_uint2(lo[j], hi[j]);
  }
}

// A fragment (16 x 16) of plane rows r0.. at columns k0..; `tile` is the
// plane's shared-space address
template <int D>
__device__ __forceinline__ void lda(uint32_t* a, uint32_t tile, int r0, int k0,
                                    int lane) {
  const int i = lane >> 3, row = r0 + ((i & 1) << 3) + (lane & 7);
  ldsm4(a, tile + PlaneRow<D>::at(row, (k0 >> 3) + (i >> 1)));
}

// B fragments of two n-tiles whose n runs over plane rows n0.. and n0 + 8..,
// k over columns k0..: regs {0, 1} the first n-tile, {2, 3} the second.
// Loaded with lda's lane-to-address map (so the kernels' ldmatrix loads
// share their swizzled offsets): lda's regs {0, 2} are the first n-tile's
// pair and {1, 3} the second's.
template <int D>
__device__ __forceinline__ void ldb(uint32_t* b, uint32_t tile, int n0, int k0,
                                    int lane) {
  uint32_t r[4];
  lda<D>(r, tile, n0, k0, lane);
  b[0] = r[0];
  b[1] = r[2];
  b[2] = r[1];
  b[3] = r[3];
}

// B fragments of two n-tiles whose k runs over plane rows k0.., n over
// columns n0.. and n0 + 8.. (ldmatrix.trans)
template <int D>
__device__ __forceinline__ void ldbt(uint32_t* b, uint32_t tile, int k0, int n0,
                                     int lane) {
  const int i = lane >> 3, row = k0 + ((i & 1) << 3) + (lane & 7);
  ldsm4t(b, tile + PlaneRow<D>::at(row, (n0 >> 3) + (i >> 1)));
}

// c += Σ_i a_i · b_j for term j of B (B's terms are loaded and applied one
// at a time, largest j first): the term products i + j <= 2 (i < NA),
// smallest first; what is dropped is below 2^-24 of the product. h picks
// the n-tile of a two-tile B fragment.
template <int NA>
__device__ __forceinline__ void mma_plane(float* c, const uint32_t (&a)[NA][4],
                                          const uint32_t* b, int j, int h) {
#pragma unroll
  for (int i = NA - 1; i >= 0; --i)
    if (i + j <= 2) mma(c, a[i], b[2 * h], b[2 * h + 1]);
}

// the three-term A fragments of a 16-wide k-step from fp32 weights in the
// C layout of its two n-tiles w0 (k 0-7) and w1 (k 8-15)
__device__ __forceinline__ void split_c(const float* w0, const float* w1,
                                        uint32_t (&a)[3][4]) {
  uint32_t x[4][3];
  split3(w0[0], w0[1], x[0]);
  split3(w0[2], w0[3], x[1]);
  split3(w1[0], w1[1], x[2]);
  split3(w1[2], w1[3], x[3]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = x[e][i];
}

// A fragments (terms of T) of rows g and g + 8 of a 16-row tile in device
// memory (row stride D) at columns k0..
template <typename T, int D>
__device__ __forceinline__ void row_frag(const T* rows, int k0, int g, int t,
                                         uint32_t (&a)[Terms<T>::n][4]) {
  const T* ra = rows + (size_t)g * D + k0 + 2 * t;
  const T* rb = ra + 8 * D;
  if constexpr (Terms<T>::n == 1) {
    a[0][0] = *reinterpret_cast<const uint32_t*>(ra);
    a[0][1] = *reinterpret_cast<const uint32_t*>(rb);
    a[0][2] = *reinterpret_cast<const uint32_t*>(ra + 8);
    a[0][3] = *reinterpret_cast<const uint32_t*>(rb + 8);
  } else {
    const float2 x0 = *reinterpret_cast<const float2*>(ra);
    const float2 x1 = *reinterpret_cast<const float2*>(rb);
    const float2 x2 = *reinterpret_cast<const float2*>(ra + 8);
    const float2 x3 = *reinterpret_cast<const float2*>(rb + 8);
    uint32_t x[4][3];
    split3(x0.x, x0.y, x[0]);
    split3(x1.x, x1.y, x[1]);
    split3(x2.x, x2.y, x[2]);
    split3(x3.x, x3.y, x[3]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[i][e] = x[e][i];
  }
}

// --------------------------------------------------------------------------
// forward: one block per (BHG row, query block, 64-row sub-tile)
// --------------------------------------------------------------------------
struct FwdArgs {
  const void* q;         // (BHG, n, D) input type
  const void* k;         // (BHKV, n, D)
  const void* v;         // (BHKV, n, D)
  const float* c;        // (BHG, nb) stabilizer floor
  const int* row_ptr;    // (BHG, nb + 1) CSR offsets by query block
  const int* ys;         // (BHG, m) key blocks
  const int* fls;        // (BHG, m) flags
  const int* km;         // (BHKV, n) key mask
  const int* order;      // (BHG · nb) query tiles, heaviest first
  float* out;            // (BHG, n, D)
  float* rowsum;         // (BHG, n)
  float* mt;             // (BHG, n)
  int G, n, m;
  float scale;
};

// Warps that share one 16-row slab (D > 128): each owns D / DS columns of
// the slab's accumulators (o, dq, dk and dv) and computes the slab's scores
// over the whole D itself, so no partial product crosses warps.
template <int D>
__host__ __device__ constexpr int col_split() { return D > 128 ? D / 128 : 1; }

// Rows a block (query rows of the forward and dq, key rows of dk/dv): 64,
// or all b when b < 64; 32 for fp32 inputs at D > 128, where the split
// planes of 64 rows would not fit a block's shared memory.
template <typename T, int D, int BS>
__host__ __device__ constexpr int block_rows() {
  return col_split<D>() > 1 && Terms<T>::n > 1 ? 32 : cmin(64, BS);
}

// Keys a stage of the forward (FWD) or dq: 64 in bf16, 32 in fp32, and at
// D > 128 what shared memory holds beside the q and do planes.
template <typename T, int D, int BS, bool FWD>
__host__ __device__ constexpr int stage_keys_of() {
  return col_split<D>() == 1 ? cmin(Terms<T>::n == 1 ? 64 : 32, BS)
         : Terms<T>::n > 1   ? 16
         : FWD               ? 64
                             : 32;
}

// Blocks an SM the launch bounds ask for: two of up to 128 threads (255
// registers a thread), one of 256 threads (a two-block bound would cap a
// thread at 128 registers)
__host__ __device__ constexpr int min_blocks(int threads) {
  return threads > 128 ? 1 : 2;
}

// Tile geometry of the kernels that walk a query tile's pairs over K/V
// stages (forward and dq); FwdGeo / DqGeo add their own shared memory, and
// the wrapper's kernel_plan() mirrors them.
template <typename T, int D, int BS, int KT_>
struct QueryGeo {
  static constexpr int NI = Terms<T>::n;                  // terms of q, k, v
  static constexpr int DS = col_split<D>();               // warps a 16-row slab
  static constexpr int DW = D / DS;                       // columns a warp owns
  static constexpr bool QREG = DS == 1;                   // q fragments in registers
  static constexpr int QR = block_rows<T, D, BS>();       // query rows a block
  static constexpr int NW = QR / 16 * DS;                 // warps
  static constexpr int NT = 32 * NW;                      // threads
  static constexpr int SUB = BS / QR;                     // blocks a query tile
  static constexpr int KT = KT_;                          // keys a stage
  static constexpr int SPP = BS / KT;                     // stages a pair
  static constexpr int RB = PlaneRow<D>::BYTES;           // bytes of a plane row
  static constexpr int RAW = D * (int)sizeof(T);          // bytes of an input row
  static constexpr int SROW = NI == 1 ? RB : RAW;         // ... of a staged k/v row
  static constexpr int PLANE = KT * RB;
  static constexpr int SLOT = (int)align16(2 * KT * SROW + KT * 4);  // k, v, mask
  static constexpr int PLANES = NI > 1 ? 2 * NI * PLANE : 0;        // split k, v
  static constexpr int RPLANE = QR * RB;  // a plane of the block's rows
  static_assert(D % 16 == 0 && BS % 16 == 0 && BS % QR == 0 && BS % KT == 0 &&
                    DW % 16 == 0,
                "tile shapes");
};

// shared memory: the K/V ring, split k and v (fp32), the fp32 q rows
// (fp32), then the q planes when q is not held in registers (D > 128)
template <typename T, int D, int BS>
struct FwdGeo : QueryGeo<T, D, BS, stage_keys_of<T, D, BS, true>()> {
  using G = QueryGeo<T, D, BS, stage_keys_of<T, D, BS, true>()>;
  static constexpr int QROW = D * 4 + 16;  // padded fp32 row of the q tile
  static constexpr int QTILE = G::NI > 1 ? G::QR * QROW : 0;  // fp32 q (recompute)
  static constexpr int QP = G::QREG ? 0 : G::NI * G::RPLANE;  // q planes
  static constexpr int SMEM = 2 * G::SLOT + G::PLANES + QTILE + QP;
};

// a stage of a query tile's pair list with no live score of the block's
// rows (from rblk): an invalid pair, or keys above every row of a diagonal
// block
template <typename Gm>
__device__ __forceinline__ bool stage_live(int fl, int st, int rblk) {
  return (fl & 1) && (!(fl & 2) || rblk + Gm::QR - 1 >= (st % Gm::SPP) * Gm::KT);
}

// stage st of a pair into a ring slot: the K and V rows of its keys (from
// key row kb) in their own type, then their key mask
template <typename Gm, typename T, int D>
__device__ __forceinline__ void stage_keys(unsigned char* dst, const void* k,
                                           const void* v, const int* km, size_t kb) {
  constexpr int KT = Gm::KT;
  stage<Gm::RAW, Gm::NI == 1, Gm::NT, KT>(dst, static_cast<const T*>(k) + kb * D);
  stage<Gm::RAW, Gm::NI == 1, Gm::NT, KT>(dst + KT * Gm::SROW,
                                          static_cast<const T*>(v) + kb * D);
  stage<KT * 4, false, Gm::NT, 1>(dst + 2 * KT * Gm::SROW, km + kb);
}

// An fp32 score recomputed with fp32 FMAs in ascending d, one thread: the
// forward's winning scores at fp32 inputs (see the softmax below).
template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    const float4 y = *reinterpret_cast<const float4*>(b + d);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// S[n], S[n + 1] += q·kᵀ of one 16-wide k-step ks (the forward's scores):
// the k-step's products summed from zero, then added in fp32
template <int NI, int D>
__device__ __forceinline__ void score_kstep(float (*s)[4], const uint32_t (&qa)[NI][4],
                                            uint32_t kp_s, int plane, int n, int ks,
                                            int lane) {
  float t[2][4] = {};
#pragma unroll
  for (int j = NI - 1; j >= 0; --j) {
    uint32_t b[4];
    ldb<D>(b, kp_s + j * plane, n * 8, ks * 16, lane);
    mma_plane<NI>(t[0], qa, b, j, 0);
    mma_plane<NI>(t[1], qa, b, j, 1);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    s[n][e] += t[0][e];
    s[n + 1][e] += t[1][e];
  }
}

// The same from rows qr and kr of two bf16 planes: the bf16 products are
// exact in fp32, so this sums what a plain fp32 product of the bf16 inputs
// sums, in ascending d.
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <int D>
__device__ __forceinline__ float dot_planes(const unsigned char* qp, int qr,
                                            const unsigned char* kp, int kr) {
  using P = PlaneRow<D>;
  float s = 0.f;
#pragma unroll 4
  for (int ch = 0; ch < D / 8; ++ch) {
    const uint4 x = *reinterpret_cast<const uint4*>(qp + P::at(qr, ch));
    const uint4 y = *reinterpret_cast<const uint4*>(kp + P::at(kr, ch));
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      s = fmaf(bf_lo(xs[w]), bf_lo(ys[w]), s);
      s = fmaf(bf_hi(xs[w]), bf_hi(ys[w]), s);
    }
  }
  return s;
}

template <typename T, int D, int BS>
__global__ void __launch_bounds__(FwdGeo<T, D, BS>::NT, min_blocks(FwdGeo<T, D, BS>::NT))
bsa_fwd_kernel(const FwdArgs p) {
  using Gm = FwdGeo<T, D, BS>;
  constexpr int NI = Gm::NI, KT = Gm::KT, SPP = Gm::SPP;
  constexpr int NTK = KT / 8, NTD = Gm::DW / 8, KSD = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nb = p.n / BS;
  const int tile = p.order[blockIdx.x / Gm::SUB], sub = blockIdx.x % Gm::SUB;
  const int bhg = tile / nb, xb = tile - bhg * nb, kvh = bhg / p.G;
  const int rblk = sub * Gm::QR;    // the block's first row in the query block
  const int wr = warp / Gm::DS * 16;  // the warp's first row in the block
  const int r0 = rblk + wr;           // ... in the query block
  const int c0 = warp % Gm::DS * Gm::DW;  // the warp's first column of o
  const size_t qbase = (size_t)bhg * p.n + (size_t)xb * BS;

  // bf16 q, the scores' A operand: the warp's 16 rows in registers, or (D >
  // 128) a plane of the block's rows read a k-step at a time
  constexpr bool QREG = NI == 1 && Gm::QREG;
  uint32_t qf[QREG ? KSD : 1][1][4];
  unsigned char* qpl = smem + 2 * Gm::SLOT + Gm::PLANES + Gm::QTILE;
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < KSD; ++ks)
      row_frag<T, D>(static_cast<const T*>(p.q) + (qbase + r0) * D, ks * 16, g,
                     t, qf[ks]);
  } else if constexpr (NI == 1) {
    stage<Gm::RAW, true, Gm::NT, Gm::QR>(
        qpl, static_cast<const T*>(p.q) + (qbase + rblk) * D);
    cp_commit();
  }
  const uint32_t qpl_s = smem_addr(qpl);

  // fp32 inputs: the block's q rows in fp32, the scores' q
  float* qtile = reinterpret_cast<float*>(smem + 2 * Gm::SLOT + Gm::PLANES);
  if constexpr (NI > 1) {
    const float* qsrc = static_cast<const float*>(p.q) + (qbase + rblk) * D;
    for (int i = threadIdx.x; i < Gm::QR * (D / 4); i += Gm::NT) {
      const int r = i / (D / 4), c4 = i - r * (D / 4);
      cp16(reinterpret_cast<unsigned char*>(qtile) + r * Gm::QROW + c4 * 16,
           qsrc + (size_t)r * D + 4 * c4, true);
    }
  }

  const float floor_c = p.c[(size_t)bhg * nb + xb];
  float mrow[2] = {floor_c, floor_c}, lrow[2] = {0.f, 0.f}, o[NTD][4];
#pragma unroll
  for (int nd = 0; nd < NTD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  const int p0 = p.row_ptr[(size_t)bhg * (nb + 1) + xb];
  const int p1 = p.row_ptr[(size_t)bhg * (nb + 1) + xb + 1];
  const int* ysr = p.ys + (size_t)bhg * p.m;
  const int* flr = p.fls + (size_t)bhg * p.m;
  auto live = [&](int st) { return stage_live<Gm>(flr[p0 + st / SPP], st, rblk); };
  auto load = [&](int st, int slot) {
    stage_keys<Gm, T, D>(smem + slot * Gm::SLOT, p.k, p.v, p.km,
                         (size_t)kvh * p.n + (size_t)ysr[p0 + st / SPP] * BS +
                             (st % SPP) * KT);
  };

  const int nst = (p1 - p0) * SPP;
  if (nst > 0 && live(0)) load(0, 0);
  cp_commit();
  for (int st = 0; st < nst; ++st) {
    cp_wait_all();
    __syncthreads();  // stage st landed; stage st - 1 is no longer read
    if (st + 1 < nst && live(st + 1)) load(st + 1, (st + 1) & 1);
    cp_commit();
    if (!live(st)) continue;  // block-uniform
    const unsigned char* slot = smem + (st & 1) * Gm::SLOT;
    const unsigned char* kp = slot;
    const unsigned char* vp = slot + KT * Gm::SROW;
    const int* kms = reinterpret_cast<const int*>(slot + 2 * KT * Gm::SROW);
    if constexpr (NI > 1) {  // v split for P·v (the scores read raw k)
      unsigned char* planes = smem + 2 * Gm::SLOT;
      split_rows<D, Gm::NT>(planes + NI * Gm::PLANE, Gm::PLANE,
                            reinterpret_cast<const float*>(vp), KT);
      __syncthreads();
      vp = planes + NI * Gm::PLANE;
    }
    const uint32_t kp_s = smem_addr(kp), vp_s = smem_addr(vp);

    // S = q·kᵀ for the warp's 16 rows x KT keys. fp32 inputs: every score
    // with sequential fp32 FMAs over d, the order a plain fp32 product sums
    // them (see the note at the top). bf16 inputs on tensor cores, whose
    // fp32 accumulation does not round to nearest at each step: each
    // k-step's products are summed from zero and added in fp32 (a long mma
    // chain errs more, and these scores set the stabilizer mt, held to 1e-5
    // absolute).
    float s[NTK][4];
#pragma unroll
    for (int n = 0; n < NTK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (NI > 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* qr = reinterpret_cast<const float*>(
            reinterpret_cast<const unsigned char*>(qtile) + (wr + g + 8 * h) * Gm::QROW);
#pragma unroll
        for (int n = 0; n < NTK; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            s[n][2 * h + e] = dot_rows<D>(
                qr, reinterpret_cast<const float*>(slot) + (size_t)(n * 8 + 2 * t + e) * D);
      }
    } else if constexpr (QREG) {
#pragma unroll
      for (int n = 0; n < NTK; n += 2)
#pragma unroll
        for (int ks = 0; ks < KSD; ++ks)
          score_kstep<1, D>(s, qf[ks], kp_s, Gm::PLANE, n, ks, lane);
    } else {
      // q in shared memory (D > 128): four k-steps unrolled; fully
      // unrolled, the q and k loads the scheduler hoists spill
#pragma unroll
      for (int n = 0; n < NTK; n += 2)
#pragma unroll 4
        for (int ks = 0; ks < KSD; ++ks) {
          uint32_t qa[1][4];
          lda<D>(qa[0], qpl_s, wr, ks * 16, lane);
          score_kstep<1, D>(s, qa, kp_s, Gm::PLANE, n, ks, lane);
        }
    }

    // mask, online rescale: raise the running max, shrink the accumulators,
    // then add this stage at the new stabilizer
    const int fl = flr[p0 + st / SPP], k0 = (st % SPP) * KT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = r0 + g + 8 * h;
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NTK; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = n * 8 + 2 * t + e;
          const bool ok = kms[j] > 0 && (!(fl & 2) || qi >= k0 + j);
          const float sv = ok ? s[n][2 * h + e] * p.scale : -INFINITY;
          s[n][2 * h + e] = sv;
          mx = fmaxf(mx, sv);
        }
      mx = quad_max(mx);
      if constexpr (NI == 1 && !Gm::QREG) {
        // bf16 inputs above D = 128 (256 terms a score): the tensor cores'
        // rounding of a score reaches the stabilizer's 1e-5 tolerance, so
        // the scores within a margin of the stage's maximum (far above the
        // tensor cores' error) are recomputed with sequential fp32 FMAs over
        // d, and the largest of them is the stage's maximum. A stage whose
        // maximum stays below the running one by the margin cannot raise
        // it (the exact scores lie within the margin of these), so it
        // skips the recompute: the same stabilizer, bit for bit.
        const float margin = 1e-5f * (1.f + fabsf(mx));
        const float thr = mx - margin;
        float best = kNegInf;
        const bool raise = mx >= mrow[h] - margin;  // quad-uniform
        if (raise) {
#pragma unroll
          for (int n = 0; n < NTK; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (s[n][2 * h + e] >= thr)
                best = fmaxf(best, dot_planes<D>(qpl, qi - rblk, kp, n * 8 + 2 * t + e) *
                                       p.scale);
        }
        best = quad_max(best);  // every lane: the shuffle takes the warp
        if (raise) mx = best;
      }
      const float m_new = fmaxf(mrow[h], mx);
      const float alpha = expf(mrow[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NTK; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sv = s[n][2 * h + e];
          const float a = sv == -INFINITY ? 0.f : expf(fminf(sv - m_new, 0.f));
          s[n][2 * h + e] = a;
          sum += a;
        }
      lrow[h] = lrow[h] * alpha + quad_sum(sum);
      mrow[h] = m_new;
#pragma unroll
      for (int nd = 0; nd < NTD; ++nd) {
        o[nd][2 * h] *= alpha;
        o[nd][2 * h + 1] *= alpha;
      }
    }

    // o += P·v, P split into three terms
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t pa[3][4];
      split_c(s[2 * kk], s[2 * kk + 1], pa);
#pragma unroll
      for (int nd = 0; nd < NTD; nd += 2)
#pragma unroll
        for (int j = NI - 1; j >= 0; --j) {
          uint32_t b[4];
          ldbt<D>(b, vp_s + j * Gm::PLANE, kk * 16, c0 + nd * 8, lane);
          mma_plane<3>(o[nd], pa, b, j, 0);
          mma_plane<3>(o[nd + 1], pa, b, j, 1);
        }
    }
  }
  cp_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = qbase + r0 + g + 8 * h;
    float* orow = p.out + row * D + c0 + 2 * t;
#pragma unroll
    for (int nd = 0; nd < NTD; ++nd)
      *reinterpret_cast<float2*>(orow + nd * 8) = make_float2(o[nd][2 * h], o[nd][2 * h + 1]);
    if (t == 0 && c0 == 0) {
      p.rowsum[row] = lrow[h];
      p.mt[row] = mrow[h];
    }
  }
}

// --------------------------------------------------------------------------
// backward, dk/dv: one block per (KV head, key block, 64-row sub-tile) over
// the pairs of all G groups of the KV head, sorted by key block
// --------------------------------------------------------------------------
struct DkvArgs {
  const void* q;         // (BHG, n, D) input type
  const void* k;         // (BHKV, n, D)
  const void* v;         // (BHKV, n, D)
  const float* mt;       // (BHG, n)
  const float* dout;     // (BHG, n, D)
  const float* dr;       // (BHG, n)
  const int* row_ptr;    // (BHKV, nb + 1) CSR offsets by key block
  const int* rows;       // (BHKV, m2) owning BHG row of each pair
  const int* xs;         // (BHKV, m2) query blocks
  const int* fls;        // (BHKV, m2) flags
  const int* km;         // (BHKV, n) key mask
  const int* order;      // (BHKV · nb) key tiles, heaviest first
  float* dk;             // (BHKV, n, D)
  float* dv;             // (BHKV, n, D)
  int n, m2;
  float scale;
};

// Tile geometry and shared-memory layout of one instantiation; the
// wrapper's kernel_plan() mirrors it.
template <typename T, int D, int BS>
struct DkvGeo {
  static constexpr int NI = Terms<T>::n;            // terms of q, k, v
  static constexpr int DS = col_split<D>();         // warps a 16-row slab
  static constexpr int DW = D / DS;                 // columns a warp owns
  static constexpr int KR = block_rows<T, D, BS>(); // key rows a block
  static constexpr int NW = KR / 16 * DS;           // warps
  static constexpr int NT = 32 * NW;                // threads
  static constexpr int SUB = BS / KR;               // blocks a key tile
  // queries a stage (16 for fp32 at D > 128: shared memory)
  static constexpr int QT = DS > 1 && NI > 1 ? 16 : cmin(32, BS);
  static constexpr int SPP = BS / QT;               // stages a pair
  static constexpr int RB = PlaneRow<D>::BYTES;     // bytes of a plane row
  static constexpr int RAW = D * (int)sizeof(T);    // bytes of an input row
  static constexpr int SROW = NI == 1 ? RB : RAW;   // ... of a staged q row
  static constexpr int RBF = D * 4;                 // bytes of an fp32 row
  static constexpr int KV = 2 * NI * KR * RB;       // k planes, then v planes
  // a ring slot: q (raw; a plane when bf16), do raw, mt, dr
  static constexpr int SLOT = (int)align16(QT * SROW + QT * RBF + 2 * QT * 4);
  // the ring also holds the raw k / v rows of an fp32 input, once
  static constexpr int RING = cmax(2 * SLOT, NI > 1 ? 2 * KR * RAW : 0);
  static constexpr int QPLANE = QT * RB;
  static constexpr int DOP = 3 * QPLANE;            // split do
  static constexpr int QP = NI > 1 ? NI * QPLANE : 0;  // split q (fp32 input)
  static constexpr int SMEM = KV + RING + DOP + QP;
  static_assert(D % 16 == 0 && BS % 16 == 0 && BS % KR == 0 && BS % QT == 0 &&
                    DW % 16 == 0,
                "tile shapes");
};

template <typename T, int D, int BS>
__global__ void __launch_bounds__(DkvGeo<T, D, BS>::NT, min_blocks(DkvGeo<T, D, BS>::NT))
bsa_bwd_dkv_kernel(const DkvArgs p) {
  using Gm = DkvGeo<T, D, BS>;
  constexpr int NI = Gm::NI, QT = Gm::QT, SPP = Gm::SPP, KR = Gm::KR;
  constexpr int NTD = Gm::DW / 8, KSD = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kvp = smem;
  unsigned char* ring = smem + Gm::KV;
  unsigned char* dop = ring + Gm::RING;
  unsigned char* qpl = dop + Gm::DOP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nb = p.n / BS;
  const int tile = p.order[blockIdx.x / Gm::SUB], sub = blockIdx.x % Gm::SUB;
  const int kvh = tile / nb, yb = tile - kvh * nb;
  const int kr0 = sub * KR;     // the block's first row in the key block
  const int wr = warp / Gm::DS * 16;      // the warp's first row in the block
  const int c0 = warp % Gm::DS * Gm::DW;  // its first column of dk and dv
  const size_t kbase = (size_t)kvh * p.n + (size_t)yb * BS + kr0;
  const T* qg = static_cast<const T*>(p.q);

  // the block's k and v rows, once, as planes (bf16); fp32 scores read the
  // warp's own rows from device memory
  if constexpr (NI == 1) {
    stage<Gm::RAW, true, Gm::NT, KR>(kvp, static_cast<const T*>(p.k) + kbase * D);
    stage<Gm::RAW, true, Gm::NT, KR>(kvp + KR * Gm::RB,
                                    static_cast<const T*>(p.v) + kbase * D);
    // committed with the first stage's group below
  }
  bool kok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) kok[h] = p.km[kbase + wr + g + 8 * h] > 0;
  float dk[NTD][4], dv[NTD][4];
#pragma unroll
  for (int nd = 0; nd < NTD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;

  const int p0 = p.row_ptr[(size_t)kvh * (nb + 1) + yb];
  const int p1 = p.row_ptr[(size_t)kvh * (nb + 1) + yb + 1];
  const size_t pb = (size_t)kvh * p.m2 + p0;
  // a stage with no live score of this block's rows: an invalid pair, or
  // queries below every key row of a diagonal block
  auto live = [&](int st) {
    const int fl = p.fls[pb + st / SPP];
    return (fl & 1) && (!(fl & 2) || (st % SPP) * QT + QT - 1 >= kr0);
  };
  auto load = [&](int st, int slot) {
    const size_t pi = pb + st / SPP;
    const size_t qb = (size_t)p.rows[pi] * p.n + (size_t)p.xs[pi] * BS + (st % SPP) * QT;
    unsigned char* dst = ring + slot * Gm::SLOT;
    stage<Gm::RAW, NI == 1, Gm::NT, QT>(dst, qg + qb * D);
    stage<Gm::RBF, false, Gm::NT, QT>(dst + QT * Gm::SROW, p.dout + qb * D);
    stage<QT * 4, false, Gm::NT, 1>(dst + QT * (Gm::SROW + Gm::RBF), p.mt + qb);
    stage<QT * 4, false, Gm::NT, 1>(dst + QT * (Gm::SROW + Gm::RBF + 4), p.dr + qb);
  };

  const int nst = (p1 - p0) * SPP;
  if (nst > 0 && live(0)) load(0, 0);
  cp_commit();
  for (int st = 0; st < nst; ++st) {
    cp_wait_all();
    __syncthreads();  // stage st landed; stage st - 1 is no longer read
    if (st + 1 < nst && live(st + 1)) load(st + 1, (st + 1) & 1);
    cp_commit();
    if (!live(st)) continue;  // block-uniform
    const unsigned char* slot = ring + (st & 1) * Gm::SLOT;
    const unsigned char* qs = slot;
    const float* qraw = reinterpret_cast<const float*>(slot);  // fp32 q rows
    const float* doraw = reinterpret_cast<const float*>(slot + QT * Gm::SROW);
    const float* mts = reinterpret_cast<const float*>(slot + QT * (Gm::SROW + Gm::RBF));
    const float* drs = mts + QT;
    split_rows<D, Gm::NT>(dop, Gm::QPLANE,
                          reinterpret_cast<const float*>(slot + QT * Gm::SROW), QT);
    if constexpr (NI > 1) {
      split_rows<D, Gm::NT>(qpl, Gm::QPLANE, reinterpret_cast<const float*>(qs), QT);
      qs = qpl;
    }
    __syncthreads();
    const uint32_t qs_s = smem_addr(qs), dop_s = smem_addr(dop), kv_s = smem_addr(kvp);

    // sixteen queries at a time: Sᵀ = k·qᵀ and dPᵀ = v·doᵀ for the warp's
    // 16 key rows, the weights, then dv += aᵀ·do and dk += dsᵀ·q
    const int fl = p.fls[pb + st / SPP], q0 = (st % SPP) * QT;
#pragma unroll 1
    for (int kk = 0; kk < QT / 16; ++kk) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      if constexpr (NI > 1) {
        // fp32 inputs: Sᵀ and dPᵀ with sequential fp32 FMAs over d, the
        // order of a plain fp32 product (the note at the top); one key row
        // at a time beside dk and dv's 128 registers
#pragma unroll 1
        for (int h = 0; h < 2; ++h) {
          const size_t row = (kbase + wr + g + 8 * h) * D;
          const float* kr = static_cast<const float*>(p.k) + row;
          const float* vr = static_cast<const float*>(p.v) + row;
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const size_t col = (size_t)(kk * 16 + n * 8 + 2 * t + e) * D;
              s[n][2 * h + e] = dot_rows<D>(kr, qraw + col);
              dp[n][2 * h + e] = dot_rows<D>(vr, doraw + col);
            }
        }
      } else {
        // four k-steps unrolled: fully unrolled, the loads the scheduler
        // hoists push the kernel past 255 registers and it spills
#pragma unroll 4
        for (int ks = 0; ks < KSD; ++ks) {
          uint32_t ak[NI][4], av[NI][4], b[4];
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            lda<D>(ak[i], kv_s + i * KR * Gm::RB, wr, ks * 16, lane);
            lda<D>(av[i], kv_s + (NI + i) * KR * Gm::RB, wr, ks * 16, lane);
          }
#pragma unroll
          for (int j = NI - 1; j >= 0; --j) {
            ldb<D>(b, qs_s + j * Gm::QPLANE, kk * 16, ks * 16, lane);
            mma_plane<NI>(s[0], ak, b, j, 0);
            mma_plane<NI>(s[1], ak, b, j, 1);
          }
#pragma unroll
          for (int j = 2; j >= 0; --j) {
            ldb<D>(b, dop_s + j * Gm::QPLANE, kk * 16, ks * 16, lane);
            mma_plane<NI>(dp[0], av, b, j, 0);
            mma_plane<NI>(dp[1], av, b, j, 1);
          }
        }
      }

      // aᵀ = mask·exp(min(s − mt, 0)) from the forward's stabilizer;
      // dsᵀ = aᵀ ⊙ (dPᵀ + dr)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kr = kr0 + wr + g + 8 * h;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = kk * 16 + n * 8 + 2 * t + e;
            const bool ok = kok[h] && (!(fl & 2) || q0 + col >= kr);
            const float a =
                ok ? expf(fminf(s[n][2 * h + e] * p.scale - mts[col], 0.f)) : 0.f;
            s[n][2 * h + e] = a;
            dp[n][2 * h + e] = a * (dp[n][2 * h + e] + drs[col]);
          }
      }

      uint32_t pa[3][4];
      split_c(s[0], s[1], pa);  // dv += aᵀ·do: six term products
#pragma unroll
      for (int nd = 0; nd < NTD; nd += 2) {
#pragma unroll
        for (int j = 2; j >= 0; --j) {
          uint32_t b[4];
          ldbt<D>(b, dop_s + j * Gm::QPLANE, kk * 16, c0 + nd * 8, lane);
          mma_plane<3>(dv[nd], pa, b, j, 0);
          mma_plane<3>(dv[nd + 1], pa, b, j, 1);
        }
      }
      split_c(dp[0], dp[1], pa);  // dk += dsᵀ·q
#pragma unroll
      for (int nd = 0; nd < NTD; nd += 2) {
#pragma unroll
        for (int j = NI - 1; j >= 0; --j) {
          uint32_t b[4];
          ldbt<D>(b, qs_s + j * Gm::QPLANE, kk * 16, c0 + nd * 8, lane);
          mma_plane<3>(dk[nd], pa, b, j, 0);
          mma_plane<3>(dk[nd + 1], pa, b, j, 1);
        }
      }
    }
  }
  cp_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = kbase + wr + g + 8 * h;
#pragma unroll
    for (int nd = 0; nd < NTD; ++nd) {
      const size_t i = row * D + c0 + nd * 8 + 2 * t;
      *reinterpret_cast<float2*>(p.dk + i) =
          make_float2(dk[nd][2 * h] * p.scale, dk[nd][2 * h + 1] * p.scale);
      *reinterpret_cast<float2*>(p.dv + i) = make_float2(dv[nd][2 * h], dv[nd][2 * h + 1]);
    }
  }
}

// --------------------------------------------------------------------------
// backward, dq: one block per (BHG row, query block, 64-row sub-tile), the
// forward's grid over the same pair lists
// --------------------------------------------------------------------------
struct DqArgs {
  const void* q;         // (BHG, n, D) input type
  const void* k;         // (BHKV, n, D)
  const void* v;         // (BHKV, n, D)
  const float* mt;       // (BHG, n)
  const float* dout;     // (BHG, n, D)
  const float* dr;       // (BHG, n)
  const int* row_ptr;    // (BHG, nb + 1) CSR offsets by query block
  const int* ys;         // (BHG, m) key blocks
  const int* fls;        // (BHG, m) flags
  const int* km;         // (BHKV, n) key mask
  const int* order;      // (BHG · nb) query tiles, heaviest first
  float* dq;             // (BHG, n, D)
  int G, n, m;
  float scale;
};

// shared memory: the K/V ring, split k and v (fp32), then three planes of
// split do and NI of q (split fp32, or bf16 when not held in registers)
template <typename T, int D, int BS>
struct DqGeo : QueryGeo<T, D, BS, stage_keys_of<T, D, BS, false>()> {
  using G = QueryGeo<T, D, BS, stage_keys_of<T, D, BS, false>()>;
  static constexpr int DOP = 3 * G::RPLANE;
  static constexpr int QP = G::NI > 1 || !G::QREG ? G::NI * G::RPLANE : 0;
  static constexpr int SMEM = 2 * G::SLOT + G::PLANES + DOP + QP;
};

template <typename T, int D, int BS>
__global__ void __launch_bounds__(DqGeo<T, D, BS>::NT, min_blocks(DqGeo<T, D, BS>::NT))
bsa_bwd_dq_kernel(const DqArgs p) {
  using Gm = DqGeo<T, D, BS>;
  constexpr int NI = Gm::NI, KT = Gm::KT, SPP = Gm::SPP;
  constexpr int NTK = KT / 8, NTD = Gm::DW / 8, KSD = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* dop = smem + 2 * Gm::SLOT + Gm::PLANES;
  unsigned char* qpl = dop + Gm::DOP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nb = p.n / BS;
  const int tile = p.order[blockIdx.x / Gm::SUB], sub = blockIdx.x % Gm::SUB;
  const int bhg = tile / nb, xb = tile - bhg * nb, kvh = bhg / p.G;
  const int rblk = sub * Gm::QR;    // the block's first row in the query block
  const int wr = warp / Gm::DS * 16;      // the warp's first row in the block
  const int r0 = rblk + wr;               // ... in the query block
  const int c0 = warp % Gm::DS * Gm::DW;  // the warp's first column of dq
  const size_t qbase = (size_t)bhg * p.n + (size_t)xb * BS + rblk;

  const int p0 = p.row_ptr[(size_t)bhg * (nb + 1) + xb];
  const int p1 = p.row_ptr[(size_t)bhg * (nb + 1) + xb + 1];
  const int* ysr = p.ys + (size_t)bhg * p.m;
  const int* flr = p.fls + (size_t)bhg * p.m;
  auto live = [&](int st) { return stage_live<Gm>(flr[p0 + st / SPP], st, rblk); };
  auto load = [&](int st, int slot) {
    stage_keys<Gm, T, D>(smem + slot * Gm::SLOT, p.k, p.v, p.km,
                         (size_t)kvh * p.n + (size_t)ysr[p0 + st / SPP] * BS +
                             (st % SPP) * KT);
  };

  const int nst = (p1 - p0) * SPP;
  float dq[NTD][4];
#pragma unroll
  for (int nd = 0; nd < NTD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nd][e] = 0.f;
  // bf16 q: the warp's fragments stay in registers (up to D = 128; above,
  // one bf16 plane of the block's rows), and do is split once into three
  // planes; fp32 scores and dP read the raw q and do rows
  constexpr bool QREG = NI == 1 && Gm::QREG;
  uint32_t qf[QREG ? KSD : 1][1][4];
  float mtr[2], drr[2];
  if (nst > 0) {
    if (live(0)) load(0, 0);
    cp_commit();
    if constexpr (QREG) {
#pragma unroll
      for (int ks = 0; ks < KSD; ++ks)
        row_frag<T, D>(static_cast<const T*>(p.q) + (qbase + wr) * D, ks * 16, g,
                       t, qf[ks]);
    } else if constexpr (NI == 1) {
      stage<Gm::RAW, true, Gm::NT, Gm::QR>(qpl, static_cast<const T*>(p.q) + qbase * D);
      cp_commit();
    }
    if constexpr (NI == 1)
      split_rows<D, Gm::NT>(dop, Gm::RPLANE, p.dout + qbase * D, Gm::QR);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = qbase + wr + g + 8 * h;
      mtr[h] = p.mt[row];
      drr[h] = p.dr[row];
    }
  }
  const uint32_t dop_s = smem_addr(dop), qpl_s = smem_addr(qpl);

  for (int st = 0; st < nst; ++st) {
    cp_wait_all();
    __syncthreads();  // stage st and the split do landed; st - 1 is not read
    if (st + 1 < nst && live(st + 1)) load(st + 1, (st + 1) & 1);
    cp_commit();
    if (!live(st)) continue;  // block-uniform
    const unsigned char* slot = smem + (st & 1) * Gm::SLOT;
    const unsigned char* kp = slot;
    const unsigned char* vp = slot + KT * Gm::SROW;
    const int* kms = reinterpret_cast<const int*>(slot + 2 * KT * Gm::SROW);
    const float* kraw = reinterpret_cast<const float*>(kp);  // fp32 rows
    const float* vraw = reinterpret_cast<const float*>(vp);
    if constexpr (NI > 1) {  // k split for dq += dS·k (S and dP read raw rows)
      unsigned char* planes = smem + 2 * Gm::SLOT;
      split_rows<D, Gm::NT>(planes, Gm::PLANE, kraw, KT);
      __syncthreads();
      kp = planes;
    }
    const uint32_t kp_s = smem_addr(kp), vp_s = smem_addr(vp);
    const int fl = flr[p0 + st / SPP], k0 = (st % SPP) * KT;

    // warp-uniform: on a diagonal block these keys lie above every row of
    // the warp
    if ((fl & 2) && r0 + 15 < k0) continue;

    // S = q·kᵀ and dP = do·vᵀ for the warp's 16 rows x KT keys: fp32 inputs
    // with sequential fp32 FMAs over d (the order of a plain fp32 product),
    // bf16 ones on tensor cores
    float s[NTK][4], dp[NTK][4];
#pragma unroll
    for (int n = 0; n < NTK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    if constexpr (NI > 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t row = (qbase + wr + g + 8 * h) * D;
        const float* qr = static_cast<const float*>(p.q) + row;
        const float* dor = p.dout + row;
#pragma unroll
        for (int n = 0; n < NTK; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const size_t j = (size_t)(n * 8 + 2 * t + e) * D;
            s[n][2 * h + e] = dot_rows<D>(qr, kraw + j);
            dp[n][2 * h + e] = dot_rows<D>(dor, vraw + j);
          }
      }
    } else {
      // four k-steps unrolled above D = 128 (as in the forward)
#pragma unroll (DqGeo<T, D, BS>::QREG ? D / 16 : 4)
      for (int ks = 0; ks < KSD; ++ks) {
        uint32_t qa[NI][4], da[3][4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[0][e] = qf[ks][0][e];
        } else {
#pragma unroll
          for (int i = 0; i < NI; ++i)
            lda<D>(qa[i], qpl_s + i * Gm::RPLANE, wr, ks * 16, lane);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i)
          lda<D>(da[i], dop_s + i * Gm::RPLANE, wr, ks * 16, lane);
#pragma unroll
        for (int n = 0; n < NTK; n += 2) {
          // the scores' products from zero at each k-step, added in fp32 (as
          // the forward's, which set mt)
          float tt[2][4] = {};
#pragma unroll
          for (int j = NI - 1; j >= 0; --j) {
            uint32_t b[4];
            ldb<D>(b, kp_s + j * Gm::PLANE, n * 8, ks * 16, lane);
            mma_plane<NI>(tt[0], qa, b, j, 0);
            mma_plane<NI>(tt[1], qa, b, j, 1);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] += tt[0][e];
            s[n + 1][e] += tt[1][e];
          }
#pragma unroll
          for (int j = NI - 1; j >= 0; --j) {
            uint32_t b[4];
            ldb<D>(b, vp_s + j * Gm::PLANE, n * 8, ks * 16, lane);
            mma_plane<3>(dp[n], da, b, j, 0);
            mma_plane<3>(dp[n + 1], da, b, j, 1);
          }
        }
      }
    }

    // a = mask·exp(min(s − mt, 0)) from the forward's stabilizer;
    // ds = a ⊙ (dP + dr)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = r0 + g + 8 * h;
#pragma unroll
      for (int n = 0; n < NTK; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = n * 8 + 2 * t + e;
          const bool ok = kms[j] > 0 && (!(fl & 2) || qi >= k0 + j);
          const float a =
              ok ? expf(fminf(s[n][2 * h + e] * p.scale - mtr[h], 0.f)) : 0.f;
          s[n][2 * h + e] = a * (dp[n][2 * h + e] + drr[h]);
        }
    }

    // dq += dS·k, dS split into three terms
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t pa[3][4];
      split_c(s[2 * kk], s[2 * kk + 1], pa);
#pragma unroll
      for (int nd = 0; nd < NTD; nd += 2)
#pragma unroll
        for (int j = NI - 1; j >= 0; --j) {
          uint32_t b[4];
          ldbt<D>(b, kp_s + j * Gm::PLANE, kk * 16, c0 + nd * 8, lane);
          mma_plane<3>(dq[nd], pa, b, j, 0);
          mma_plane<3>(dq[nd + 1], pa, b, j, 1);
        }
    }
  }
  cp_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* row = p.dq + (qbase + wr + g + 8 * h) * D + c0 + 2 * t;
#pragma unroll
    for (int nd = 0; nd < NTD; ++nd)
      *reinterpret_cast<float2*>(row + nd * 8) =
          make_float2(dq[nd][2 * h] * p.scale, dq[nd][2 * h + 1] * p.scale);
  }
}

// ==========================================================================
// host side
// ==========================================================================
struct KernelInfo {
  const void* fn;  // null for a (kernel, dtype, D, b) not instantiated
  int smem;
  int threads;
  int sub;         // blocks an output tile (row sub-tiles)
};

enum Kernel { kFwd = 0, kDkv = 1, kDq = 2 };

template <typename T, int D, int BS>
KernelInfo info_of(int kernel) {
  if (kernel == kFwd)
    return {reinterpret_cast<const void*>(bsa_fwd_kernel<T, D, BS>),
            FwdGeo<T, D, BS>::SMEM, FwdGeo<T, D, BS>::NT, FwdGeo<T, D, BS>::SUB};
  if (kernel == kDq)
    return {reinterpret_cast<const void*>(bsa_bwd_dq_kernel<T, D, BS>),
            DqGeo<T, D, BS>::SMEM, DqGeo<T, D, BS>::NT, DqGeo<T, D, BS>::SUB};
  return {reinterpret_cast<const void*>(bsa_bwd_dkv_kernel<T, D, BS>),
          DkvGeo<T, D, BS>::SMEM, DkvGeo<T, D, BS>::NT, DkvGeo<T, D, BS>::SUB};
}

template <typename T>
KernelInfo info_shape(int kernel, int D, int b) {
  if (D == 128 && b == 128) return info_of<T, 128, 128>(kernel);
  if (D == 64 && b == 64) return info_of<T, 64, 64>(kernel);
  if (D == 16 && b == 16) return info_of<T, 16, 16>(kernel);
  if (D == 64 && b == 128) return info_of<T, 64, 128>(kernel);
  if (D == 80 && b == 128) return info_of<T, 80, 128>(kernel);
  if (D == 64 && b == 32) return info_of<T, 64, 32>(kernel);
  if (D == 256 && b == 128) return info_of<T, 256, 128>(kernel);
  return {nullptr, 0, 0, 0};
}

// dtype: 0 = bf16, 1 = fp32 (q, k and v share it)
KernelInfo info(int kernel, int dtype, int D, int b) {
  if (kernel != kFwd && kernel != kDkv && kernel != kDq) return {nullptr, 0, 0, 0};
  if (dtype == 0) return info_shape<__nv_bfloat16>(kernel, D, b);
  if (dtype == 1) return info_shape<float>(kernel, D, b);
  return {nullptr, 0, 0, 0};
}

// the instantiations: three kernels x two types x the (D, b) of info_shape
constexpr int kShapes = 7;
constexpr int kInstantiations = 3 * 2 * kShapes;

// Allow the kernel's dynamic shared memory (and the largest carveout, so that
// two blocks fit on an SM); done once per kernel.
cudaError_t configure(const KernelInfo& k) {
  static const void* done[kInstantiations];
  static int ndone = 0;
  for (int i = 0; i < ndone; ++i)
    if (done[i] == k.fn) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k.fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (ndone < kInstantiations) done[ndone++] = k.fn;
  return cudaSuccess;
}

// one launch of `tiles` output tiles of a tensor-core kernel (a block per
// row sub-tile of each)
template <typename Args>
cudaError_t launch_tc(int kernel, int dtype, int D, int b, const Args& args,
                      int tiles, cudaStream_t st) {
  const KernelInfo k = info(kernel, dtype, D, b);
  if (!k.fn) return cudaErrorInvalidValue;
  cudaError_t err = configure(k);
  if (err != cudaSuccess) return err;
  void* params[] = {const_cast<Args*>(&args)};
  err = cudaLaunchKernel(k.fn, dim3(tiles * k.sub), dim3(k.threads), params,
                         k.smem, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool shape_ok(int rows, int n, int b) {
  return rows > 0 && b > 0 && n % b == 0 && n / b > 0;
}

}  // namespace

// Dynamic shared memory of one block of the forward (kernel 0), dk/dv
// (kernel 1) or dq (kernel 2) kernel, or 0 for a (dtype, D, b) not built.
extern "C" long long bsa_smem_bytes(int kernel, int dtype, int D, int b) {
  return info(kernel, dtype, D, b).smem;
}

// Blocks of the forward (0), dk/dv (1) or dq (2) kernel that fit on an SM
// (occupancy API: registers, threads and shared memory).
extern "C" int bsa_blocks_per_sm(int kernel, int dtype, int D, int b, int* blocks) {
  const KernelInfo k = info(kernel, dtype, D, b);
  if (!k.fn) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure(k);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k.fn, k.threads, k.smem));
}

// Each entry point returns the cudaError_t of its launch (0 = launched).
// `order` lists the output tiles (BHG·nb query tiles, BHKV·nb key tiles) in
// launch order; D is the head dim as stored (a built, padded one), and a
// (dtype, D, b) not built is refused (info()).
extern "C" int bsa_fwd_launch(const void* q, const void* k, const void* v,
                              const void* c, const void* ptr, const void* ys,
                              const void* fl, const void* km, const void* order,
                              void* out, void* rs, void* mt, int BHG, int G,
                              int n, int D, int b, int m, float scale, int dtype,
                              void* stream) {
  if (!shape_ok(BHG, n, b) || G <= 0 || BHG % G) return cudaErrorInvalidValue;
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.c = static_cast<const float*>(c);
  a.row_ptr = static_cast<const int*>(ptr);
  a.ys = static_cast<const int*>(ys);
  a.fls = static_cast<const int*>(fl);
  a.km = static_cast<const int*>(km);
  a.order = static_cast<const int*>(order);
  a.out = static_cast<float*>(out);
  a.rowsum = static_cast<float*>(rs);
  a.mt = static_cast<float*>(mt);
  a.G = G;
  a.n = n;
  a.m = m;
  a.scale = scale;
  return launch_tc(kFwd, dtype, D, b, a, BHG * (n / b),
                   static_cast<cudaStream_t>(stream));
}

extern "C" int bsa_bwd_dq_launch(const void* q, const void* k, const void* v,
                                 const void* mt, const void* dout, const void* dr,
                                 const void* ptr, const void* ys, const void* fl,
                                 const void* km, const void* order, void* dq,
                                 int BHG, int G, int n, int D, int b, int m,
                                 float scale, int dtype, void* stream) {
  if (!shape_ok(BHG, n, b) || G <= 0 || BHG % G) return cudaErrorInvalidValue;
  DqArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mt = static_cast<const float*>(mt);
  a.dout = static_cast<const float*>(dout);
  a.dr = static_cast<const float*>(dr);
  a.row_ptr = static_cast<const int*>(ptr);
  a.ys = static_cast<const int*>(ys);
  a.fls = static_cast<const int*>(fl);
  a.km = static_cast<const int*>(km);
  a.order = static_cast<const int*>(order);
  a.dq = static_cast<float*>(dq);
  a.G = G;
  a.n = n;
  a.m = m;
  a.scale = scale;
  return launch_tc(kDq, dtype, D, b, a, BHG * (n / b),
                   static_cast<cudaStream_t>(stream));
}

extern "C" int bsa_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                  const void* mt, const void* dout, const void* dr,
                                  const void* ptr, const void* rows, const void* xs,
                                  const void* fl, const void* km, const void* order,
                                  void* dk, void* dv, int BHKV, int n, int D, int b,
                                  int m2, float scale, int dtype, void* stream) {
  if (!shape_ok(BHKV, n, b)) return cudaErrorInvalidValue;
  DkvArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mt = static_cast<const float*>(mt);
  a.dout = static_cast<const float*>(dout);
  a.dr = static_cast<const float*>(dr);
  a.row_ptr = static_cast<const int*>(ptr);
  a.rows = static_cast<const int*>(rows);
  a.xs = static_cast<const int*>(xs);
  a.fls = static_cast<const int*>(fl);
  a.km = static_cast<const int*>(km);
  a.order = static_cast<const int*>(order);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.n = n;
  a.m2 = m2;
  a.scale = scale;
  return launch_tc(kDkv, dtype, D, b, a, BHKV * (n / b),
                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* bsa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
