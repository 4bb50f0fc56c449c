// chunk_attn.cu — MRA-2 chunk/decode serving attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/chunk_attn.py::_chunk_kernel (the
// pallas_call in _chunk_attention_call), both of its programs: the two-level
// one (with_upper=False) and the H-level fold (with_upper=True, compile-time
// UPPER here). For one (batch·kv-head row, query tile, split) per block:
//   1. coarse scores q · k̄_y · scale against every page mean, the causal
//      block mask (live ∧ pb <= q_pos // b, floor division: padded rows have
//      q_pos = -1 and see no page) and FORCE_BONUS on the own live block;
//   2. top-m per query row as m rounds of argmax, lowest page index winning
//      ties, picked entries knocked out with -2e9 (below NEG_INF), an invalid
//      pick selecting nothing — jax.lax.top_k's order, bit for bit. Steps 1-2
//      run on CUDA cores in fp32, one warp per (row, page) dot (lane-strided
//      partial sums, then a butterfly) and one warp per row of argmax
//      rounds: a fixed order that no tiling or split changes, so every
//      split of a row selects the same pages;
//   3. the exact term over the split's part of the union of the tile's
//      selected pages, in ascending physical page order, each row masked to
//      its own selection and to pos <= q_pos, with a flash-style online
//      softmax (running max, row sum, fp32 accumulator) on tensor cores;
//   4. the coarse background Σ exp(μ − c)·count·v̄ over live, allowed,
//      unselected, non-own pages and, at UPPER (levels >= 3, DESIGN.md §14),
//      the collapsed levels + tail: pass 1 takes the live entries' scores
//      hmu = q·hk·scale into c before any exp, pass 2 adds
//      Σ exp(hmu − c)·count·hv. Then the two-level stabilizer
//      c_tok = max(c, running max) and normalization; rows with no live key
//      (window or collapsed) come out as exact zeros.
//
// What bounds it on this card. At decode, bytes: a row reads its selected
// bf16 K/V pages (64 KB each) and does 2·G·D operations per key. At C = 512
// the 64 query tiles of a row each re-read their union from L2, and the
// tensor cores' issue rate (mma.sync, split operands) sets the pace.
//
// What the design does about it.
//   * Pages are staged in the cache's own type (bf16; int8 codes + per-token
//     fp32 scales; fp32) with 16-byte cp.async copies into a two-slot ring:
//     the next stage (64 keys of bf16 / int8, 32 of fp32) is in flight while
//     the current one is computed. Rows are XOR-swizzled in 16-byte chunks
//     (chunk ^ row % 8), so ldmatrix and the int8 / fp32 fragment loads are
//     free of bank conflicts.
//   * Both products run as mma.sync.m16n8k16 bf16 with fp32 accumulators.
//     fp32 accuracy comes from split operands: the fp32 query is three bf16
//     terms (q0 + q1 + q2 == q exactly); bf16 K and int8 codes are exact in
//     bf16, so S = Σ qi·K takes three products (the int8 K scale multiplies
//     the score column afterwards); P = exp(s − m) is split likewise against
//     V (the int8 V scale is folded into P first). An fp32 cache, and the
//     fp32 collapsed means, are split too, and the six products with terms
//     above 2^-24 relative are kept. The term count is a property of the
//     storage type, fixed at compile time.
//   * The four warps split D: each owns 32 of the 128 columns, keeps its
//     query fragments in registers for the whole block, and forms a partial
//     score tile; the partials meet in shared memory (summed in one order, so
//     every warp holds the same scores and the same softmax state) and each
//     warp then accumulates P·V for its own columns. Rows are padded to 16
//     (one or two m16 tiles; pad rows have q_pos = -1 and select nothing).
//   * At decode the grid is too small for the card (B·Hkv blocks), so the
//     wrapper splits each row's pages into nsplit contiguous physical ranges
//     (grid z). Every split recomputes the (cheap) selection and walks only
//     its range of the union; it writes its partial (acc, running max, row
//     sum) to fp32 scratch, and split 0 also the parts that do not depend on
//     the running max (c after fold pass 1, the background numerator and
//     its sum). chunk_attn_combine_kernel merges the splits in ascending
//     order (deterministic, no atomics) and normalizes. With nsplit = 1 the
//     block normalizes itself and no combine runs.
//   * At most ~108 KB of shared memory per block (D = b = 128, 32 rows), so
//     two blocks share an SM. D and b are template parameters, instantiated
//     for (128, 128) and (16, 16); the fold streams hk / hv through the ring
//     in tiles of 16 entries, so shared memory does not grow with NU.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas=-v (repro_torch/kernels/build.py); plain C
//        entry points, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr int kThreads = 128;   // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kMTiles = 2;      // m16 row tiles: at most 32 query rows a tile
constexpr int kEntryTile = 16;  // fp32 entries (collapsed means) per tile
constexpr int kSlots = 2;       // cp.async ring depth

constexpr float kNegInf = -1e9f;     // repro NEG_INF
constexpr float kForceBonus = 2e9f;  // repro FORCE_BONUS
constexpr float kPicked = -2e9f;     // knock-out of already-picked pages

struct Params {
  const float* q;       // (BKV, G, C, D)
  const int* qpos;      // (B, C)
  const float* kds;     // (BKV, nb, D)
  const float* vds;     // (BKV, nb, D)
  const float* counts;  // (B, nb)
  const int* pb;        // (B, nb)
  const void* k;        // (BKV, nb * b, D) cache type
  const void* v;        // (BKV, nb * b, D)
  const float* ks;      // (BKV, nb * b) int8 scales or null
  const float* vs;      // (BKV, nb * b)
  const float* hk;      // (BKV, NU, D) or null
  const float* hv;      // (BKV, NU, D) or null
  const float* hcnt;    // (B, NU) or null
  float* out;           // (BKV, G, C, D)
  float* part;          // split scratch (nsplit > 1) or null
  int Hkv, G, C, nb, m, c_tile, NU, nsplit, rows, mtiles, include_bg;
  float scale;
};

// Python/JAX floor division: -1 // b == -1 (C++ '/' would give 0).
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return ((a % b) != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// ---- storage types ---------------------------------------------------------
template <typename T>
struct Cache;
template <>
struct Cache<__nv_bfloat16> {  // exact in bf16; ldmatrix fragments
  static constexpr int kKeys = 64, kTerms = 1;
  static constexpr bool kPerm = false, kQuant = false;
};
template <>
struct Cache<int8_t> {  // codes exact in bf16; per-token fp32 scales
  static constexpr int kKeys = 64, kTerms = 1;
  static constexpr bool kPerm = true, kQuant = true;
};
template <>
struct Cache<float> {  // three bf16 terms
  static constexpr int kKeys = 32, kTerms = 3;
  static constexpr bool kPerm = true, kQuant = false;
};

// Tile geometry of one instantiation; the wrapper's smem_bytes() mirrors it.
template <typename T, int D, int BS>
struct Geo {
  static constexpr int KT = cmin(Cache<T>::kKeys, BS);  // keys per stage
  static constexpr int SPP = BS / KT;                   // stages per page
  static constexpr int NWD = D < 32 ? 1 : cmin(4, D / 32);  // warps over D
  static constexpr int DS = D / NWD;                    // columns per warp
  static constexpr int KSD = DS / 16;                   // k-steps of q·k
  static constexpr int NTD = DS / 8;                    // n-tiles of p·v
  static constexpr int XW = cmax(KT, kEntryTile);       // exchange columns
  static constexpr int XS = XW + 8;  // padded row stride: conflict-free float2
  static constexpr int RB = D * (int)sizeof(T);         // bytes of a cache row
  static constexpr int RBF = D * 4;                     // bytes of an fp32 row
  static constexpr int STAGE =
      2 * KT * RB + (Cache<T>::kQuant ? 2 * KT * 4 : 0);
  static constexpr int FTILE = 2 * kEntryTile * RBF;    // hk + hv tile
  static constexpr int SLOT = (int)align16(cmax(STAGE, FTILE));
  static_assert(BS % KT == 0 && KT % 16 == 0, "stage keys");
  static_assert(D % NWD == 0 && DS % 16 == 0, "warp columns");
  static_assert(RB % 16 == 0, "16-byte rows");
};

// Shared-memory layout; the wrapper's smem_bytes() mirrors it.
struct Smem {
  unsigned char* ring;  // kSlots x SLOT cp.async ring (first the fp32 q tile)
  float* q;             // RP x D fp32 query tile (aliases the ring)
  float* xch;           // NWD x RP x XS partial scores (NWD > 1)
  float* cm;            // rows x nb masked coarse scores (coarse_m)
  float* ss;            // rows x nb selection scores, then background w
  int* qp;              // RP query positions (-1 = padded row)
  float* c;             // RP coarse stabilizer c
  float* bgs;           // RP background row sums
  uint8_t* sel;         // rows x nb selected pages
  uint8_t* any;         // nb union of the tile's selections
  int* ul;              // nb the split's union pages, ascending
  int* npages;          // their count
};

template <typename T, int D, int BS>
__device__ __forceinline__ Smem smem_layout(unsigned char* raw, int rows,
                                            int RP, int nb) {
  using G = Geo<T, D, BS>;
  Smem m;
  size_t off = 0;
  m.ring = raw;
  m.q = reinterpret_cast<float*>(raw);
  off += align16(cmax(kSlots * G::SLOT, RP * D * 4));
  m.xch = reinterpret_cast<float*>(raw + off);
  off += G::NWD > 1 ? align16((size_t)G::NWD * RP * G::XS * 4) : 0;
  m.cm = reinterpret_cast<float*>(raw + off);   off += align16((size_t)rows * nb * 4);
  m.ss = reinterpret_cast<float*>(raw + off);   off += align16((size_t)rows * nb * 4);
  m.qp = reinterpret_cast<int*>(raw + off);     off += align16((size_t)RP * 4);
  m.c = reinterpret_cast<float*>(raw + off);    off += align16((size_t)RP * 4);
  m.bgs = reinterpret_cast<float*>(raw + off);  off += align16((size_t)RP * 4);
  m.sel = raw + off;                            off += align16((size_t)rows * nb);
  m.any = raw + off;                            off += align16((size_t)nb);
  m.ul = reinterpret_cast<int*>(raw + off);     off += align16((size_t)nb * 4);
  m.npages = reinterpret_cast<int*>(raw + off);
  return m;
}

template <typename T, int D, int BS>
size_t smem_bytes(int rows, int RP, int nb) {
  using G = Geo<T, D, BS>;
  return align16(cmax(kSlots * G::SLOT, RP * D * 4)) +
         (G::NWD > 1 ? align16((size_t)G::NWD * RP * G::XS * 4) : 0) +
         2 * align16((size_t)rows * nb * 4) + 3 * align16((size_t)RP * 4) +
         align16((size_t)rows * nb) + align16((size_t)nb) +
         align16((size_t)nb * 4) + 16;
}

// ---- operand helpers (PTX wrappers and split3: sm90_mma.cuh) -------------
__device__ __forceinline__ uint32_t pack_codes(int c0, int c1) {
  return pack(__float2bfloat16_rn(static_cast<float>(c0)),
              __float2bfloat16_rn(static_cast<float>(c1)));
}

// address of element d of row `row` in a swizzled tile of U rows of width D
template <typename U, int D>
__device__ __forceinline__ const U* elem(const unsigned char* tile, int row,
                                         int d) {
  constexpr int RB = D * (int)sizeof(U), EPC = 16 / (int)sizeof(U);
  return reinterpret_cast<const U*>(tile + row * RB +
                                    swz<RB / 16>(row, d / EPC) * 16) +
         d % EPC;
}

// copy `nrows` rows of RB bytes from src (row stride RB) into a swizzled
// tile; rows >= valid are zero-filled
template <int RB>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const void* src,
                                           int nrows, int valid) {
  constexpr int CPR = RB / 16;
  const char* s = static_cast<const char*>(src);
  for (int i = threadIdx.x; i < nrows * CPR; i += kThreads) {
    const int row = i / CPR, ch = i - row * CPR;
    const bool ok = row < valid;
    cp16(dst + row * RB + swz<CPR>(row, ch) * 16,
         ok ? s + (size_t)row * RB + ch * 16 : s, ok);
  }
}

// ---- fragments --------------------------------------------------------------
// (the mma fragment layouts are listed in sm90_mma.cuh) For q·k the k index
// runs over D. bf16 pages use it as it stands (ldmatrix); int8 and fp32 pages
// permute it inside each 16-column step so that a lane's four columns are
// adjacent (one 4-byte / 16-byte load): k = 2t + {0, 1} is column 4t + {0, 1}
// and k = 2t + 8 + {0, 1} is column 4t + 2 + {0, 1}. The query fragments use
// the same map; a sum over k does not see the order.

// B fragments of k^T for the 8 keys from `key0` at columns d0..d0+15 of an
// int8 / fp32 tile: b[term][reg]
template <typename U, int D, bool PERM>
__device__ __forceinline__ void kfrag(const unsigned char* tile, int key,
                                      int d0, int t, uint32_t (&b)[3][2]) {
  if constexpr (PERM) {
    const int d = d0 + 4 * t;
    if constexpr (sizeof(U) == 1) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
          elem<int8_t, D>(tile, key, d));
      b[0][0] = pack_codes((int8_t)(w & 0xff), (int8_t)((w >> 8) & 0xff));
      b[0][1] = pack_codes((int8_t)((w >> 16) & 0xff), (int8_t)(w >> 24));
    } else {
      const float4 x = *reinterpret_cast<const float4*>(elem<float, D>(tile, key, d));
      uint32_t lo[3], hi[3];
      split3(x.x, x.y, lo);
      split3(x.z, x.w, hi);
      for (int i = 0; i < 3; ++i) { b[i][0] = lo[i]; b[i][1] = hi[i]; }
    }
  } else {  // fp32 means against bf16-page query fragments
    const float2 x = *reinterpret_cast<const float2*>(elem<float, D>(tile, key, d0 + 2 * t));
    const float2 y = *reinterpret_cast<const float2*>(elem<float, D>(tile, key, d0 + 2 * t + 8));
    uint32_t lo[3], hi[3];
    split3(x.x, x.y, lo);
    split3(y.x, y.y, hi);
    for (int i = 0; i < 3; ++i) { b[i][0] = lo[i]; b[i][1] = hi[i]; }
  }
}

// B fragments of v for keys k0..k0+15 at column d of an int8 / fp32 tile
template <typename U, int D>
__device__ __forceinline__ void vfrag(const unsigned char* tile, int k0, int d,
                                      int t, uint32_t (&b)[3][2]) {
  const int kr = k0 + 2 * t;
  const U x0 = *elem<U, D>(tile, kr, d), x1 = *elem<U, D>(tile, kr + 1, d);
  const U x2 = *elem<U, D>(tile, kr + 8, d), x3 = *elem<U, D>(tile, kr + 9, d);
  if constexpr (sizeof(U) == 1) {
    b[0][0] = pack_codes(x0, x1);
    b[0][1] = pack_codes(x2, x3);
  } else {
    uint32_t lo[3], hi[3];
    split3(x0, x1, lo);
    split3(x2, x3, hi);
    for (int i = 0; i < 3; ++i) { b[i][0] = lo[i]; b[i][1] = hi[i]; }
  }
}

// s[mt][n] = this warp's columns of q · k^T for the NT n-tiles of keys of a
// tile of U rows; qf[mt][ks][term] are the query's split A fragments. Products
// of terms i + j <= 2 (NK terms of k), smallest first.
template <typename U, typename Gm, bool PERM, int NT, int NK>
__device__ __forceinline__ void tile_scores(
    const unsigned char* tile, const uint32_t (&qf)[kMTiles][Gm::KSD][3][4],
    float (&s)[kMTiles][NT][4], int MT, int warp, int lane) {
  constexpr int D = Gm::DS * Gm::NWD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < Gm::KSD; ++ks) {
    const int d0 = warp * Gm::DS + ks * 16;
    if constexpr (sizeof(U) == 2) {  // bf16 page: ldmatrix, two n-tiles
      static_assert(NT % 2 == 0, "key tiles in pairs");
      constexpr int RB = D * 2;
      const int i = lane >> 3;
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        const int key = n * 8 + ((i >> 1) << 3) + (lane & 7);
        uint32_t b[4];
        ldsm4(b, tile + key * RB + swz<RB / 16>(key, d0 / 8 + (i & 1)) * 16);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          if (mt >= MT) continue;
#pragma unroll
          for (int L = 2; L >= 0; --L) {
            mma(s[mt][n], qf[mt][ks][L], b[0], b[1]);
            mma(s[mt][n + 1], qf[mt][ks][L], b[2], b[3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b[3][2];
        kfrag<U, D, PERM>(tile, n * 8 + g, d0, t, b);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          if (mt >= MT) continue;
#pragma unroll
          for (int L = 2; L >= 0; --L)
#pragma unroll
            for (int j = 0; j < NK; ++j)
              if (j <= L) mma(s[mt][n], qf[mt][ks][L - j], b[j][0], b[j][1]);
        }
      }
    }
  }
}

// acc[mt][nd] += w · v over the NT n-tiles of keys (weights in C layout) of a
// tile of U rows, this warp's columns; w split into three bf16 terms, v into
// NV terms, products of terms i + j <= 2, smallest first.
template <typename U, typename Gm, int NT, int NV>
__device__ __forceinline__ void tile_pv(const unsigned char* tile,
                                        const float (&w)[kMTiles][NT][4],
                                        float (&acc)[kMTiles][Gm::NTD][4],
                                        int MT, int warp, int lane) {
  constexpr int D = Gm::DS * Gm::NWD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t pa[kMTiles][3][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
      uint32_t x[3];
      split3(w[mt][2 * kk][0], w[mt][2 * kk][1], x);
      for (int i = 0; i < 3; ++i) pa[mt][i][0] = x[i];
      split3(w[mt][2 * kk][2], w[mt][2 * kk][3], x);
      for (int i = 0; i < 3; ++i) pa[mt][i][1] = x[i];
      split3(w[mt][2 * kk + 1][0], w[mt][2 * kk + 1][1], x);
      for (int i = 0; i < 3; ++i) pa[mt][i][2] = x[i];
      split3(w[mt][2 * kk + 1][2], w[mt][2 * kk + 1][3], x);
      for (int i = 0; i < 3; ++i) pa[mt][i][3] = x[i];
    }
    if constexpr (sizeof(U) == 2) {  // bf16 page: ldmatrix.trans
      static_assert(Gm::NTD % 2 == 0, "column tiles in pairs");
      constexpr int RB = D * 2;
      const int i = lane >> 3;
      const int key = kk * 16 + ((i & 1) << 3) + (lane & 7);
#pragma unroll
      for (int nd = 0; nd < Gm::NTD; nd += 2) {
        uint32_t b[4];
        const int ch = (warp * Gm::DS + nd * 8) / 8 + (i >> 1);
        ldsm4t(b, tile + key * RB + swz<RB / 16>(key, ch) * 16);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          if (mt >= MT) continue;
#pragma unroll
          for (int L = 2; L >= 0; --L) {
            mma(acc[mt][nd], pa[mt][L], b[0], b[1]);
            mma(acc[mt][nd + 1], pa[mt][L], b[2], b[3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int nd = 0; nd < Gm::NTD; ++nd) {
        uint32_t b[3][2];
        vfrag<U, D>(tile, kk * 16, warp * Gm::DS + nd * 8 + g, t, b);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          if (mt >= MT) continue;
#pragma unroll
          for (int L = 2; L >= 0; --L)
#pragma unroll
            for (int j = 0; j < NV; ++j)
              if (j <= L) mma(acc[mt][nd], pa[mt][L - j], b[j][0], b[j][1]);
        }
      }
    }
  }
}

// The column warps' partial scores meet in shared memory: afterwards every
// compute warp holds the full scores, summed over the warps in one order.
// Every thread of the block must call it (it holds a __syncthreads).
template <typename Gm, int NT>
__device__ __forceinline__ void exchange(float (&s)[kMTiles][NT][4], float* xch,
                                         int MT, int RP, int warp, int lane) {
  if constexpr (Gm::NWD > 1) {
    const int g = lane >> 2, t = lane & 3;
    if (warp < Gm::NWD) {
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        if (mt >= MT) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* row = xch + (size_t)(warp * RP + mt * 16 + g + 8 * h) * Gm::XS;
#pragma unroll
          for (int n = 0; n < NT; ++n)
            *reinterpret_cast<float2*>(row + n * 8 + 2 * t) =
                make_float2(s[mt][n][2 * h], s[mt][n][2 * h + 1]);
        }
      }
    }
    __syncthreads();
    if (warp < Gm::NWD) {
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        if (mt >= MT) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            float x = 0.f, y = 0.f;
#pragma unroll
            for (int w = 0; w < Gm::NWD; ++w) {
              const float2 v = *reinterpret_cast<const float2*>(
                  xch + (size_t)(w * RP + mt * 16 + g + 8 * h) * Gm::XS +
                  n * 8 + 2 * t);
              x += v.x;
              y += v.y;
            }
            s[mt][n][2 * h] = x;
            s[mt][n][2 * h + 1] = y;
          }
        }
      }
    }
  }
}

// ---- the kernel -------------------------------------------------------------
// Split scratch of one (row, tile) block, R query rows: nsplit partial
// accumulators (R x D) and (running max, row sum) pairs (R x 2), then split
// 0's background numerator (R x D) and (c, background row sum) pairs.
__host__ __device__ __forceinline__ size_t part_stride(int nsplit, int R, int D) {
  return (size_t)(nsplit + 1) * R * (D + 2);
}

template <typename T, int D, int BS, bool UPPER>
__global__ void __launch_bounds__(kThreads, 2)
chunk_attn_kernel(const Params p) {
  using Gm = Geo<T, D, BS>;
  using CT = Cache<T>;
  constexpr int KT = Gm::KT, NTK = KT / 8, NTE = kEntryTile / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int r = blockIdx.x, tile = blockIdx.y, split = blockIdx.z;
  const int bi = r / p.Hkv;
  const int R = p.rows, MT = p.mtiles, RP = 16 * MT;
  const int G = p.G, C = p.C, nb = p.nb, c_tile = p.c_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool compute = warp < Gm::NWD;  // this warp owns columns
  const bool bg_here = p.include_bg && split == 0;
  const int S = nb * BS;
  Smem sm = smem_layout<T, D, BS>(smem_raw, R, RP, nb);

  const float* kds_r = p.kds + (size_t)r * nb * D;
  const float* vds_r = p.vds + (size_t)r * nb * D;
  const float* cnt_r = p.counts + (size_t)bi * nb;
  const int* pb_r = p.pb + (size_t)bi * nb;

  // ---- query tile (rows padded to RP with zeros), positions ---------------
  for (int i = tid; i < RP * D; i += kThreads) {
    const int rr = i / D, d = i - rr * D;
    const int gg = rr / c_tile, c = tile * c_tile + rr % c_tile;
    sm.q[i] = rr < R && c < C ? p.q[((size_t)(r * G + gg) * C + c) * D + d] : 0.f;
  }
  for (int rr = tid; rr < RP; rr += kThreads) {
    const int c = tile * c_tile + rr % c_tile;
    sm.qp[rr] = rr < R && c < C ? p.qpos[(size_t)bi * C + c] : -1;
    sm.c[rr] = kNegInf * 0.5f;
    sm.bgs[rr] = 0.f;
  }
  for (int y = tid; y < nb; y += kThreads) sm.any[y] = 0;
  __syncthreads();

  // ---- coarse scores + causal/validity masks: one warp per (row, page) -----
  for (int pidx = warp; pidx < R * nb; pidx += kWarps) {
    const int rr = pidx / nb, y = pidx - rr * nb;
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) dot += sm.q[rr * D + d] * kds_r[(size_t)y * D + d];
    dot = warp_sum(dot);
    if (lane == 0) {
      const int jq = floor_div(sm.qp[rr], BS);
      const int pby = pb_r[y];
      const bool live = cnt_r[y] > 0.f;
      const bool allowed = live && pby <= jq;
      const bool ownl = pby == jq && pby >= 0 && live;
      const float cmv = allowed ? dot * p.scale : kNegInf;
      sm.cm[pidx] = cmv;
      sm.ss[pidx] = cmv + (ownl ? kForceBonus : 0.f);
      sm.sel[pidx] = 0;
    }
  }
  __syncthreads();

  // ---- top-m: m rounds of (row max, lowest index among ties), warp per row -
  for (int rr = warp; rr < R; rr += kWarps) {
    const float* cm = sm.cm + rr * nb;
    float* ss = sm.ss + rr * nb;
    const int jq = floor_div(sm.qp[rr], BS);
    float cmx = -INFINITY;
    for (int y = lane; y < nb; y += 32) cmx = fmaxf(cmx, cm[y]);
    cmx = warp_max(cmx);
    if (lane == 0) sm.c[rr] = fmaxf(cmx, kNegInf * 0.5f);
    for (int round = 0; round < p.m; ++round) {
      float bv = -INFINITY;
      int bidx = nb;
      for (int y = lane; y < nb; y += 32) {
        const float v = ss[y];
        if (v > bv) { bv = v; bidx = y; }  // ascending y: first among equals
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, o);
        const int oi = __shfl_xor_sync(kFull, bidx, o);
        if (ov > bv || (ov == bv && oi < bidx)) { bv = ov; bidx = oi; }
      }
      if (lane == 0) {
        const int pby = pb_r[bidx];
        if (cnt_r[bidx] > 0.f && pby <= jq) {  // an invalid pick selects nothing
          sm.sel[rr * nb + bidx] = 1;
          sm.any[bidx] = 1;
        }
        ss[bidx] = kPicked;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- query fragments (three bf16 terms) and the split's union pages ------
  uint32_t qf[kMTiles][Gm::KSD][3][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int ks = 0; ks < Gm::KSD; ++ks) {
      const int c0 = CT::kPerm ? 4 * t : 2 * t, c1 = CT::kPerm ? 4 * t + 2 : 2 * t + 8;
      const float* qa = sm.q + (mt * 16 + g) * D + warp * Gm::DS + ks * 16;
      const float* qb = qa + 8 * D;
      const bool ok = compute && mt < MT;
      uint32_t x[4][3];
      split3(ok ? qa[c0] : 0.f, ok ? qa[c0 + 1] : 0.f, x[0]);
      split3(ok ? qb[c0] : 0.f, ok ? qb[c0 + 1] : 0.f, x[1]);
      split3(ok ? qa[c1] : 0.f, ok ? qa[c1 + 1] : 0.f, x[2]);
      split3(ok ? qb[c1] : 0.f, ok ? qb[c1 + 1] : 0.f, x[3]);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[mt][ks][i][e] = x[e][i];
    }
  if (warp == 0) {
    const int p0 = (int)((long long)split * nb / p.nsplit);
    const int p1 = (int)((long long)(split + 1) * nb / p.nsplit);
    int cnt = 0;
    for (int base = p0; base < p1; base += 32) {
      const int j = base + lane;
      const bool f = j < p1 && sm.any[j];
      const unsigned bal = __ballot_sync(kFull, f);
      if (f) sm.ul[cnt + __popc(bal & ((1u << lane) - 1u))] = j;
      cnt += __popc(bal);
    }
    if (lane == 0) *sm.npages = cnt;
  }
  // per fragment row (mt, h): running max, row sum, stabilizer c, bg row sum
  float mrow[kMTiles][2], lrow[kMTiles][2], crow[kMTiles][2], brow[kMTiles][2];
  float acc[kMTiles][Gm::NTD][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mrow[mt][h] = kNegInf;
      lrow[mt][h] = 0.f;
      brow[mt][h] = 0.f;
      crow[mt][h] = mt < MT ? sm.c[mt * 16 + g + 8 * h] : kNegInf * 0.5f;
    }
#pragma unroll
    for (int nd = 0; nd < Gm::NTD; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nd][e] = 0.f;
  }
  __syncthreads();  // q tile read; the ring is free; union list visible

  // ---- exact term: stages of KT keys of the union's pages, two-slot ring ---
  const size_t cache_row = (size_t)r * S;
  auto load_stage = [&](int st, int slot) {
    const int j = sm.ul[st / Gm::SPP], k0 = (st % Gm::SPP) * KT;
    const size_t tok = cache_row + (size_t)j * BS + k0;
    unsigned char* dst = sm.ring + slot * Gm::SLOT;
    stage_rows<Gm::RB>(dst, static_cast<const T*>(p.k) + tok * D, KT, KT);
    stage_rows<Gm::RB>(dst + KT * Gm::RB, static_cast<const T*>(p.v) + tok * D, KT, KT);
    if constexpr (CT::kQuant) {
      float* sc = reinterpret_cast<float*>(dst + 2 * KT * Gm::RB);
      for (int i = tid; i < KT / 2; i += kThreads) {  // KT/4 chunks each
        const bool isv = i >= KT / 4;
        const int ch = isv ? i - KT / 4 : i;
        cp16(sc + (isv ? KT : 0) + 4 * ch, (isv ? p.vs : p.ks) + tok + 4 * ch, true);
      }
    }
  };
  const int nstage = *sm.npages * Gm::SPP;
  if (nstage > 0) load_stage(0, 0);
  cp_commit();
  for (int st = 0; st < nstage; ++st) {
    cp_wait_all();
    __syncthreads();
    if (st + 1 < nstage) load_stage(st + 1, (st + 1) & 1);
    cp_commit();
    const unsigned char* kt = sm.ring + (st & 1) * Gm::SLOT;
    const unsigned char* vt = kt + KT * Gm::RB;
    const float* sks = reinterpret_cast<const float*>(vt + KT * Gm::RB);
    const int j = sm.ul[st / Gm::SPP], k0 = (st % Gm::SPP) * KT;
    const int pos0 = pb_r[j] * BS + k0;  // logical position of the stage's key 0
    float s[kMTiles][NTK][4];
    if (compute)
      tile_scores<T, Gm, CT::kPerm, NTK, CT::kTerms>(kt, qf, s, MT, warp, lane);
    exchange<Gm, NTK>(s, sm.xch, MT, RP, warp, lane);
    if (!compute) continue;
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
      if (mt >= MT) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = mt * 16 + g + 8 * h;
        const bool selr = rr < R && sm.sel[rr * nb + j];
        const int qpr = sm.qp[rr];
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NTK; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kk = n * 8 + 2 * t + e, pos = pos0 + kk;
            float sv = -INFINITY;  // -inf: position not attended by this row
            if (selr && pos >= 0 && pos <= qpr) {
              sv = s[mt][n][2 * h + e];
              if constexpr (CT::kQuant) sv *= sks[kk];
              sv *= p.scale;
            }
            s[mt][n][2 * h + e] = sv;
            mx = fmaxf(mx, sv);
          }
        mx = quad_max(mx);
        const float m_old = mrow[mt][h];
        const float m_new = fmaxf(m_old, mx);  // m_old >= NEG_INF: finite
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NTK; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sv = s[mt][n][2 * h + e];
            const float a = sv == -INFINITY ? 0.f : expf(sv - m_new);
            sum += a;
            s[mt][n][2 * h + e] = CT::kQuant ? a * sks[KT + n * 8 + 2 * t + e] : a;
          }
        sum = quad_sum(sum);
        const float alpha = expf(m_old - m_new);
        lrow[mt][h] = lrow[mt][h] * alpha + sum;
        mrow[mt][h] = m_new;
#pragma unroll
        for (int nd = 0; nd < Gm::NTD; ++nd) {
          acc[mt][nd][2 * h] *= alpha;
          acc[mt][nd][2 * h + 1] *= alpha;
        }
      }
    }
    tile_pv<T, Gm, NTK, CT::kTerms>(vt, s, acc, MT, warp, lane);
  }
  cp_wait_all();
  __syncthreads();  // the ring is free again

  // ---- split 0: H-level fold and background (independent of the max) ------
  float bga[kMTiles][Gm::NTD][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nd = 0; nd < Gm::NTD; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) bga[mt][nd][e] = 0.f;
  const float* hk_r = UPPER ? p.hk + (size_t)r * p.NU * D : nullptr;
  const float* hv_r = UPPER ? p.hv + (size_t)r * p.NU * D : nullptr;
  const float* hc_r = UPPER ? p.hcnt + (size_t)bi * p.NU : nullptr;
  const int ntile = UPPER ? (p.NU + kEntryTile - 1) / kEntryTile : 0;
  auto load_entries = [&](int ti, int slot, bool values) {
    const int e0 = ti * kEntryTile, ne = min(kEntryTile, p.NU - e0);
    unsigned char* dst = sm.ring + slot * Gm::SLOT;
    stage_rows<Gm::RBF>(dst, hk_r + (size_t)e0 * D, kEntryTile, ne);
    if (values)
      stage_rows<Gm::RBF>(dst + kEntryTile * Gm::RBF, hv_r + (size_t)e0 * D,
                          kEntryTile, ne);
  };
  if (UPPER && bg_here) {
    // pass 1: the live entries' maxima join c
    load_entries(0, 0, false);
    cp_commit();
    for (int ti = 0; ti < ntile; ++ti) {
      cp_wait_all();
      __syncthreads();
      if (ti + 1 < ntile) load_entries(ti + 1, (ti + 1) & 1, false);
      cp_commit();
      float s[kMTiles][NTE][4];
      if (compute)
        tile_scores<float, Gm, CT::kPerm, NTE, 3>(sm.ring + (ti & 1) * Gm::SLOT,
                                                  qf, s, MT, warp, lane);
      exchange<Gm, NTE>(s, sm.xch, MT, RP, warp, lane);
      if (!compute) continue;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < NTE; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = ti * kEntryTile + n * 8 + 2 * t + e;
              if (idx < p.NU && hc_r[idx] > 0.f)
                mx = fmaxf(mx, s[mt][n][2 * h + e] * p.scale);
            }
          crow[mt][h] = fmaxf(crow[mt][h], quad_max(mx));
        }
    }
    cp_wait_all();
    __syncthreads();
    if (warp == 0 && t == 0)  // every compute warp holds the same c
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (mt < MT) sm.c[mt * 16 + g + 8 * h] = crow[mt][h];
    __syncthreads();
  }
  if (bg_here) {
    // page background weights w = exp(cm − c)·count (ss now holds w)
    for (int rr = warp; rr < R; rr += kWarps) {
      const float c = sm.c[rr];
      const int jq = floor_div(sm.qp[rr], BS);
      float wsum = 0.f;
      for (int y = lane; y < nb; y += 32) {
        const int pby = pb_r[y];
        const float cnt = cnt_r[y];
        const bool live = cnt > 0.f;
        const bool allowed = live && pby <= jq;
        const bool ownl = pby == jq && pby >= 0 && live;
        const bool bg = allowed && !ownl && !sm.sel[rr * nb + y];
        const float w = bg ? expf(sm.cm[rr * nb + y] - c) * cnt : 0.f;
        sm.ss[rr * nb + y] = w;
        wsum += w;
      }
      wsum = warp_sum(wsum);
      if (lane == 0) sm.bgs[rr] = wsum;
    }
    __syncthreads();
    if (compute) {  // Σ_y w·v̄ on CUDA cores, into this thread's C fragments
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        if (mt >= MT) continue;
        const int ra = mt * 16 + g, rb = ra + 8;
        brow[mt][0] = sm.bgs[ra];
        brow[mt][1] = sm.bgs[rb];
        const float* wa = ra < R ? sm.ss + ra * nb : nullptr;
        const float* wb = rb < R ? sm.ss + rb * nb : nullptr;
        for (int y = 0; y < nb; ++y) {
          const float xa = wa ? wa[y] : 0.f, xb = wb ? wb[y] : 0.f;
          const float* vy = vds_r + (size_t)y * D + warp * Gm::DS + 2 * t;
#pragma unroll
          for (int nd = 0; nd < Gm::NTD; ++nd) {
            const float2 v = *reinterpret_cast<const float2*>(vy + nd * 8);
            bga[mt][nd][0] += xa * v.x;
            bga[mt][nd][1] += xa * v.y;
            bga[mt][nd][2] += xb * v.x;
            bga[mt][nd][3] += xb * v.y;
          }
        }
      }
    }
  }
  if (UPPER && bg_here) {
    // pass 2: Σ exp(hmu − c)·count·hv and its row sum
    load_entries(0, 0, true);
    cp_commit();
    for (int ti = 0; ti < ntile; ++ti) {
      cp_wait_all();
      __syncthreads();
      if (ti + 1 < ntile) load_entries(ti + 1, (ti + 1) & 1, true);
      cp_commit();
      const unsigned char* ht = sm.ring + (ti & 1) * Gm::SLOT;
      float s[kMTiles][NTE][4];
      if (compute)
        tile_scores<float, Gm, CT::kPerm, NTE, 3>(ht, qf, s, MT, warp, lane);
      exchange<Gm, NTE>(s, sm.xch, MT, RP, warp, lane);
      if (!compute) continue;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < NTE; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = ti * kEntryTile + n * 8 + 2 * t + e;
              const float cnt = idx < p.NU ? hc_r[idx] : 0.f;
              const float w = cnt > 0.f
                  ? expf(s[mt][n][2 * h + e] * p.scale - crow[mt][h]) * cnt : 0.f;
              s[mt][n][2 * h + e] = w;
              sum += w;
            }
          brow[mt][h] += quad_sum(sum);
        }
      tile_pv<float, Gm, NTE, 3>(ht + kEntryTile * Gm::RBF, s, bga, MT, warp, lane);
    }
    cp_wait_all();
  }
  if (!compute) return;

  // ---- normalize here, or hand the partial to the combine ------------------
  if (p.nsplit == 1) {
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
      if (mt >= MT) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = mt * 16 + g + 8 * h;
        const int gg = rr / c_tile, c = tile * c_tile + rr % c_tile;
        if (rr >= R || c >= C) continue;  // pad row, or past a ragged last tile
        const float c_tok = fmaxf(crow[mt][h], mrow[mt][h]);
        const float fine_adj = expf(mrow[mt][h] - c_tok);  // <= 1
        const float adj = expf(crow[mt][h] - c_tok);
        const float rs = lrow[mt][h] * fine_adj + adj * brow[mt][h];
        float* o = p.out + ((size_t)(r * G + gg) * C + c) * D + warp * Gm::DS + 2 * t;
#pragma unroll
        for (int nd = 0; nd < Gm::NTD; ++nd) {
          const float x = acc[mt][nd][2 * h] * fine_adj + adj * bga[mt][nd][2 * h];
          const float y = acc[mt][nd][2 * h + 1] * fine_adj + adj * bga[mt][nd][2 * h + 1];
          *reinterpret_cast<float2*>(o + nd * 8) =
              rs > 0.f ? make_float2(x / rs, y / rs) : make_float2(0.f, 0.f);
        }
      }
    }
    return;
  }
  float* base = p.part + (size_t)(r * gridDim.y + tile) * part_stride(p.nsplit, R, D);
  float* acc_s = base + (size_t)split * R * D;
  float* ml_s = base + (size_t)p.nsplit * R * D + (size_t)split * R * 2;
  float* bgn = base + (size_t)p.nsplit * R * (D + 2);
  float* cb = bgn + (size_t)R * D;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
    if (mt >= MT) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = mt * 16 + g + 8 * h;
      if (rr >= R) continue;
      const int col = warp * Gm::DS + 2 * t;
#pragma unroll
      for (int nd = 0; nd < Gm::NTD; ++nd) {
        *reinterpret_cast<float2*>(acc_s + (size_t)rr * D + col + nd * 8) =
            make_float2(acc[mt][nd][2 * h], acc[mt][nd][2 * h + 1]);
        if (split == 0)
          *reinterpret_cast<float2*>(bgn + (size_t)rr * D + col + nd * 8) =
              make_float2(bga[mt][nd][2 * h], bga[mt][nd][2 * h + 1]);
      }
      if (warp == 0 && t == 0) {
        *reinterpret_cast<float2*>(ml_s + rr * 2) = make_float2(mrow[mt][h], lrow[mt][h]);
        if (split == 0)
          *reinterpret_cast<float2*>(cb + rr * 2) = make_float2(crow[mt][h], brow[mt][h]);
      }
    }
  }
}

// Merge the splits of one (row, tile) in ascending order and normalize with
// the two-level stabilizer: M = max mt_s, rs = Σ rs_s·exp(mt_s − M), acc
// likewise; c_tok = max(c, M); out = (acc·exp(M − c_tok) + exp(c − c_tok)·bg)
// / (rs·exp(M − c_tok) + exp(c − c_tok)·bg_sum), zero where that sum is 0.
__global__ void __launch_bounds__(kThreads)
chunk_attn_combine_kernel(const float* __restrict__ part, float* __restrict__ out,
                          int G, int C, int D, int R, int c_tile, int nsplit) {
  const int r = blockIdx.x, tile = blockIdx.y;
  const float* base = part + (size_t)(r * gridDim.y + tile) * part_stride(nsplit, R, D);
  const float* ml = base + (size_t)nsplit * R * D;
  const float* bgn = base + (size_t)nsplit * R * (D + 2);
  const float* cb = bgn + (size_t)R * D;
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int rr = i / D, d = i - rr * D;
    const int gg = rr / c_tile, c = tile * c_tile + rr % c_tile;
    if (c >= C) continue;
    float M = -INFINITY;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ml[(size_t)s * R * 2 + rr * 2]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(ml[(size_t)s * R * 2 + rr * 2] - M);
      l += ml[(size_t)s * R * 2 + rr * 2 + 1] * w;
      a += base[(size_t)s * R * D + i] * w;
    }
    const float cc = cb[rr * 2], bs = cb[rr * 2 + 1];
    const float c_tok = fmaxf(cc, M);
    const float fine_adj = expf(M - c_tok), adj = expf(cc - c_tok);
    const float rs = l * fine_adj + adj * bs;
    const float o = a * fine_adj + adj * bgn[i];
    out[((size_t)(r * G + gg) * C + c) * D + d] = rs > 0.f ? o / rs : 0.f;
  }
}

// ---- host side ----------------------------------------------------------------
using KernelFn = void (*)(Params);

template <typename T, int D>
KernelFn pick_upper(bool upper) {
  return upper ? chunk_attn_kernel<T, D, D, true> : chunk_attn_kernel<T, D, D, false>;
}

template <typename T>
KernelFn pick_shape(int D, int b, bool upper) {
  if (D == 128 && b == 128) return pick_upper<T, 128>(upper);
  if (D == 16 && b == 16) return pick_upper<T, 16>(upper);
  return nullptr;
}

// dtype: 0 = bf16, 1 = fp32, 2 = int8; null for a shape not instantiated
KernelFn pick(int dtype, int D, int b, bool upper) {
  if (dtype == 0) return pick_shape<__nv_bfloat16>(D, b, upper);
  if (dtype == 1) return pick_shape<float>(D, b, upper);
  if (dtype == 2) return pick_shape<int8_t>(D, b, upper);
  return nullptr;
}

template <typename T>
size_t smem_of_shape(int D, int b, int rows, int RP, int nb) {
  if (D == 128 && b == 128) return smem_bytes<T, 128, 128>(rows, RP, nb);
  if (D == 16 && b == 16) return smem_bytes<T, 16, 16>(rows, RP, nb);
  return 0;
}

size_t smem_of(int dtype, int D, int b, int rows, int nb) {
  const int RP = 16 * ((rows + 15) / 16);
  if (dtype == 0) return smem_of_shape<__nv_bfloat16>(D, b, rows, RP, nb);
  if (dtype == 1) return smem_of_shape<float>(D, b, rows, RP, nb);
  if (dtype == 2) return smem_of_shape<int8_t>(D, b, rows, RP, nb);
  return 0;
}

// Allow `smem` bytes of dynamic shared memory (and the largest carveout, so
// that two blocks fit on an SM); done once per kernel and size.
cudaError_t configure(KernelFn kernel, int smem) {
  static KernelFn done_fn[16];
  static int done_smem[16];
  int slot = 0;
  while (slot < 16 && done_fn[slot] && done_fn[slot] != kernel) ++slot;
  if (slot < 16 && done_fn[slot] == kernel && done_smem[slot] >= smem)
    return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (slot < 16) {
    done_fn[slot] = kernel;
    done_smem[slot] = smem;
  }
  return cudaSuccess;
}

}  // namespace

// Dynamic shared memory of one block, or 0 for a (dtype, D, b) not built.
extern "C" long long chunk_attn_smem_bytes(int dtype, int D, int b, int rows,
                                           int nb) {
  return static_cast<long long>(smem_of(dtype, D, b, rows, nb));
}

// Blocks of one program that fit on an SM at `smem` bytes (occupancy API).
extern "C" int chunk_attn_blocks_per_sm(int dtype, int D, int b, int upper,
                                        int smem, int* blocks) {
  KernelFn kernel = pick(dtype, D, b, upper != 0);
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, reinterpret_cast<const void*>(kernel), kThreads, smem));
}

// One launch of the chunk kernel on grid (B·Hkv, ceil(C / c_tile), nsplit).
// NU > 0 launches the H-level program over hk / hv / hcnt (background on
// only); NU = 0 the two-level one (the three pointers unused). nsplit > 1
// writes partials to `part` (part_stride floats per (row, tile)) for
// chunk_attn_combine_launch; nsplit = 1 writes `out`.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int chunk_attn_launch(const void* q, const void* qpos,
                                 const void* kds, const void* vds,
                                 const void* counts, const void* pb,
                                 const void* k, const void* v, const void* ks,
                                 const void* vs, const void* hk,
                                 const void* hv, const void* hcnt, void* out,
                                 void* part, int B, int Hkv, int G, int C,
                                 int D, int nb, int b, int m, int c_tile,
                                 int NU, int nsplit, float scale, int dtype,
                                 int include_bg, int smem, void* stream) {
  const int rows = G * c_tile, mtiles = (rows + 15) / 16;
  KernelFn kernel = pick(dtype, D, b, NU > 0);
  if (!kernel || NU < 0 || (NU > 0 && !include_bg) || mtiles > kMTiles ||
      nsplit < 1 || nsplit > nb || (nsplit > 1 && !part) ||
      (size_t)smem < smem_of(dtype, D, b, rows, nb))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.q = static_cast<const float*>(q);
  p.qpos = static_cast<const int*>(qpos);
  p.kds = static_cast<const float*>(kds);
  p.vds = static_cast<const float*>(vds);
  p.counts = static_cast<const float*>(counts);
  p.pb = static_cast<const int*>(pb);
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.hk = static_cast<const float*>(hk);
  p.hv = static_cast<const float*>(hv);
  p.hcnt = static_cast<const float*>(hcnt);
  p.out = static_cast<float*>(out);
  p.part = static_cast<float*>(part);
  p.Hkv = Hkv;
  p.G = G;
  p.C = C;
  p.nb = nb;
  p.m = m;
  p.c_tile = c_tile;
  p.NU = NU;
  p.nsplit = nsplit;
  p.rows = rows;
  p.mtiles = mtiles;
  p.include_bg = include_bg;
  p.scale = scale;
  dim3 grid(B * Hkv, (C + c_tile - 1) / c_tile, nsplit);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Merge the nsplit partials of every (row, tile) into `out`.
extern "C" int chunk_attn_combine_launch(const void* part, void* out, int B,
                                         int Hkv, int G, int C, int D,
                                         int c_tile, int nsplit, void* stream) {
  if (nsplit < 2) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(B * Hkv, (C + c_tile - 1) / c_tile);
  chunk_attn_combine_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), G, C, D,
      G * c_tile, c_tile, nsplit);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* chunk_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
