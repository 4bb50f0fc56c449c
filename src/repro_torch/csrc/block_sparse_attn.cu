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
// Design. The TPU grid runs in order and keeps an output tile resident in
// VMEM while consecutive grid steps revisit it (first-visit flags, coverage
// padding). Here every output tile has exactly one owning thread block that
// walks that tile's CSR list of pairs (row_ptr offsets built by the
// wrapper) and zero-initializes its accumulators itself: no atomics, no
// first-visit flags, no coverage padding, and results that are bitwise the
// same from run to run. A block is 256 threads over a tile of 32 rows (query
// rows for fwd / dq, key rows for dk/dv) by up to 128 columns; each thread
// owns 2 rows x 8 columns of every score tile and of its accumulators, and
// the 16 threads of a row group reduce row maxima and sums by warp
// shuffles. K/V (fwd, dq) or q/do (dkv) of the pair's block are staged in
// shared memory in the input dtype (bf16 or fp32) with padded rows (no bank
// conflicts on the score loop); all arithmetic and accumulation is fp32,
// as the reference's preferred_element_type=float32. Shapes: b <= 128,
// head dim <= 128; shared memory is sized for those maxima and zeroed once
// per block, so smaller shapes read zeros in the padding.
//
// What bounds it on this card: operations. A pair costs 2·b²·d
// multiply-adds per product (2 in the forward, 3 in dq, 4 in dk/dv), and
// at b = d = 128 the forward does about 250 FLOP per byte it must move,
// above the fp32 ridge point (67 TFLOP/s over 3.35 TB/s = 20) though below
// the bf16 tensor-core one (295). This first version runs fp32 FMAs on CUDA
// cores from shared memory and restages each pair's block with plain loads
// (no overlap); the block-stabilizer never leaves the block, the scores and
// weights never reach device memory, and each staged block is reused by
// all 32 rows of the tile. Tensor cores (wgmma), TMA and pipelined staging
// are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py); plain C entry
//        points, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kRT = 32;        // rows of a tile
constexpr int kRPT = 2;        // rows per thread: rg and rg + 16
constexpr int kCPT = 8;        // columns per thread: cg + 16 t
constexpr int kMaxB = 128;     // largest block size
constexpr int kMaxD = 128;     // largest head dim
constexpr int kFS = kMaxD + 1; // row stride of fp32 [row][d] tiles
constexpr int kPS = kMaxB + 1; // row stride of fp32 [row][key] tiles
constexpr float kNegInf = -1e9f;  // repro NEG_INF
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads == 16 * 16, "16 x 16 thread layout");
static_assert(kRT == 16 * kRPT, "tile rows");
static_assert(kMaxB == 16 * kCPT && kMaxD == 16 * kCPT, "tile columns");

// row stride (elements) of a [row][d] tile staged in the input dtype: one
// 4-byte word of padding per row
template <typename T>
constexpr int tile_stride() { return kMaxD + static_cast<int>(4 / sizeof(T)); }

constexpr size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// max / sum over the 16 lanes of a row group (lanes differ in bits 0-3)
__device__ __forceinline__ float group_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void zero_smem(unsigned char* smem, size_t bytes) {
  float4* p = reinterpret_cast<float4*>(smem);
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (size_t i = threadIdx.x; i < bytes / 16; i += kThreads) p[i] = z;
}

// mask of one score: pair valid, causal triangle on a diagonal block
// (query row >= key row within the block), key valid, inside the block
__device__ __forceinline__ bool pair_ok(int flags, int qrow, int krow, int b,
                                       bool key_valid) {
  return (flags & 1) && qrow < b && krow < b && key_valid &&
         (!(flags & 2) || qrow >= krow);
}

// --------------------------------------------------------------------------
// forward
// --------------------------------------------------------------------------
template <typename T>
struct FwdLayout {
  static constexpr int KS = tile_stride<T>();
  static constexpr size_t q = 0;                                        // float [kRT][kFS]
  static constexpr size_t k = align16(q + sizeof(float) * kRT * kFS);   // T [kMaxB][KS]
  static constexpr size_t v = align16(k + sizeof(T) * kMaxB * KS);      // T [kMaxB][kMaxD]
  static constexpr size_t p = align16(v + sizeof(T) * kMaxB * kMaxD);   // float [kRT][kPS]
  static constexpr size_t km = align16(p + sizeof(float) * kRT * kPS);  // int [kMaxB]
  static constexpr size_t bytes = align16(km + sizeof(int) * kMaxB);
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ c,
               const int* __restrict__ row_ptr, const int* __restrict__ ys,
               const int* __restrict__ fls, const int* __restrict__ km,
               float* __restrict__ out, float* __restrict__ rowsum,
               float* __restrict__ mt_out, int G, int n, int D, int b, int m,
               float scale) {
  using L = FwdLayout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q);
  T* Ks = reinterpret_cast<T*>(smem + L::k);
  T* Vs = reinterpret_cast<T*>(smem + L::v);
  float* Ps = reinterpret_cast<float*>(smem + L::p);
  int* Km = reinterpret_cast<int*>(smem + L::km);

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int bhg = blockIdx.x, xb = blockIdx.y, row0 = blockIdx.z * kRT;
  const int nb = n / b, kvh = bhg / G;
  const int rows = min(kRT, b - row0);
  const size_t qbase = static_cast<size_t>(bhg) * n + static_cast<size_t>(xb) * b + row0;

  zero_smem(smem, L::bytes);
  __syncthreads();
  for (int e = tid; e < rows * D; e += kThreads) {
    const int i = e / D, d = e - i * D;
    Qs[i * kFS + d] = to_f32(q[(qbase + i) * D + d]);
  }

  const float floor_c = c[static_cast<size_t>(bhg) * nb + xb];
  float o[kRPT][kCPT], mrow[kRPT], lrow[kRPT];
#pragma unroll
  for (int r = 0; r < kRPT; ++r) {
    mrow[r] = floor_c;
    lrow[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kCPT; ++t) o[r][t] = 0.f;
  }

  const int p0 = row_ptr[static_cast<size_t>(bhg) * (nb + 1) + xb];
  const int p1 = row_ptr[static_cast<size_t>(bhg) * (nb + 1) + xb + 1];
  for (int p = p0; p < p1; ++p) {
    const int y = ys[static_cast<size_t>(bhg) * m + p];
    const int fl = fls[static_cast<size_t>(bhg) * m + p];
    const size_t kbase = static_cast<size_t>(kvh) * n + static_cast<size_t>(y) * b;
    __syncthreads();  // the previous pair's tiles are no longer read
#pragma unroll 4
    for (int e = tid; e < b * D; e += kThreads) {
      const int j = e / D, d = e - j * D;
      const size_t g = (kbase + j) * D + d;
      Ks[j * L::KS + d] = k[g];
      Vs[j * kMaxD + d] = v[g];
    }
    for (int j = tid; j < b; j += kThreads) Km[j] = km[kbase + j] > 0;
    __syncthreads();

    float s[kRPT][kCPT];
#pragma unroll
    for (int r = 0; r < kRPT; ++r)
#pragma unroll
      for (int t = 0; t < kCPT; ++t) s[r][t] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRPT], kv[kCPT];
#pragma unroll
      for (int r = 0; r < kRPT; ++r) qv[r] = Qs[(rg + 16 * r) * kFS + d];
#pragma unroll
      for (int t = 0; t < kCPT; ++t) kv[t] = to_f32(Ks[(cg + 16 * t) * L::KS + d]);
#pragma unroll
      for (int r = 0; r < kRPT; ++r)
#pragma unroll
        for (int t = 0; t < kCPT; ++t) s[r][t] = fmaf(qv[r], kv[t], s[r][t]);
    }

    // mask, online rescale (flash-attention): raise the running max, shrink
    // the accumulators, then add this block at the new stabilizer
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const int i = rg + 16 * r, qrow = row0 + i;
      unsigned ok = 0;
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < kCPT; ++t) {
        const int j = cg + 16 * t;
        s[r][t] *= scale;
        if (pair_ok(fl, qrow, j, b, j < b && Km[j])) {
          ok |= 1u << t;
          mx = fmaxf(mx, s[r][t]);
        }
      }
      const float m_new = fmaxf(mrow[r], group_max(mx));
      const float alpha = expf(mrow[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kCPT; ++t) {
        const float a = (ok >> t) & 1u ? expf(fminf(s[r][t] - m_new, 0.f)) : 0.f;
        Ps[i * kPS + cg + 16 * t] = a;
        sum += a;
      }
      lrow[r] = lrow[r] * alpha + group_sum(sum);
      mrow[r] = m_new;
#pragma unroll
      for (int t = 0; t < kCPT; ++t) o[r][t] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < b; ++j) {
      float pv[kRPT], vv[kCPT];
#pragma unroll
      for (int r = 0; r < kRPT; ++r) pv[r] = Ps[(rg + 16 * r) * kPS + j];
#pragma unroll
      for (int t = 0; t < kCPT; ++t) vv[t] = to_f32(Vs[j * kMaxD + cg + 16 * t]);
#pragma unroll
      for (int r = 0; r < kRPT; ++r)
#pragma unroll
        for (int t = 0; t < kCPT; ++t) o[r][t] = fmaf(pv[r], vv[t], o[r][t]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRPT; ++r) {
    const int i = rg + 16 * r;
    if (i >= rows) continue;
    const size_t row = qbase + i;
#pragma unroll
    for (int t = 0; t < kCPT; ++t) {
      const int col = cg + 16 * t;
      if (col < D) out[row * D + col] = o[r][t];
    }
    if (cg == 0) {
      rowsum[row] = lrow[r];
      mt_out[row] = mrow[r];
    }
  }
}

// --------------------------------------------------------------------------
// backward, dq: same grid and pair lists as the forward
// --------------------------------------------------------------------------
template <typename T>
struct DqLayout {
  static constexpr int KS = tile_stride<T>();
  static constexpr size_t q = 0;                                        // float [kRT][kFS]
  static constexpr size_t dout = align16(q + sizeof(float) * kRT * kFS);// float [kRT][kFS]
  static constexpr size_t k = align16(dout + sizeof(float) * kRT * kFS);// T [kMaxB][KS]
  static constexpr size_t v = align16(k + sizeof(T) * kMaxB * KS);      // T [kMaxB][KS]
  static constexpr size_t ds = align16(v + sizeof(T) * kMaxB * KS);     // float [kRT][kPS]
  static constexpr size_t km = align16(ds + sizeof(float) * kRT * kPS); // int [kMaxB]
  static constexpr size_t bytes = align16(km + sizeof(int) * kMaxB);
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ mt,
                  const float* __restrict__ dout, const float* __restrict__ dr,
                  const int* __restrict__ row_ptr, const int* __restrict__ ys,
                  const int* __restrict__ fls, const int* __restrict__ km,
                  float* __restrict__ dq, int G, int n, int D, int b, int m,
                  float scale) {
  using L = DqLayout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q);
  float* dOs = reinterpret_cast<float*>(smem + L::dout);
  T* Ks = reinterpret_cast<T*>(smem + L::k);
  T* Vs = reinterpret_cast<T*>(smem + L::v);
  float* dSs = reinterpret_cast<float*>(smem + L::ds);
  int* Km = reinterpret_cast<int*>(smem + L::km);

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int bhg = blockIdx.x, xb = blockIdx.y, row0 = blockIdx.z * kRT;
  const int nb = n / b, kvh = bhg / G;
  const int rows = min(kRT, b - row0);
  const size_t qbase = static_cast<size_t>(bhg) * n + static_cast<size_t>(xb) * b + row0;

  zero_smem(smem, L::bytes);
  __syncthreads();
  for (int e = tid; e < rows * D; e += kThreads) {
    const int i = e / D, d = e - i * D;
    Qs[i * kFS + d] = to_f32(q[(qbase + i) * D + d]);
    dOs[i * kFS + d] = dout[(qbase + i) * D + d];
  }
  float mt_r[kRPT], dr_r[kRPT], acc[kRPT][kCPT];
#pragma unroll
  for (int r = 0; r < kRPT; ++r) {
    const int i = rg + 16 * r;
    mt_r[r] = i < rows ? mt[qbase + i] : 0.f;
    dr_r[r] = i < rows ? dr[qbase + i] : 0.f;
#pragma unroll
    for (int t = 0; t < kCPT; ++t) acc[r][t] = 0.f;
  }

  const int p0 = row_ptr[static_cast<size_t>(bhg) * (nb + 1) + xb];
  const int p1 = row_ptr[static_cast<size_t>(bhg) * (nb + 1) + xb + 1];
  for (int p = p0; p < p1; ++p) {
    const int y = ys[static_cast<size_t>(bhg) * m + p];
    const int fl = fls[static_cast<size_t>(bhg) * m + p];
    const size_t kbase = static_cast<size_t>(kvh) * n + static_cast<size_t>(y) * b;
    __syncthreads();
#pragma unroll 4
    for (int e = tid; e < b * D; e += kThreads) {
      const int j = e / D, d = e - j * D;
      const size_t g = (kbase + j) * D + d;
      Ks[j * L::KS + d] = k[g];
      Vs[j * L::KS + d] = v[g];
    }
    for (int j = tid; j < b; j += kThreads) Km[j] = km[kbase + j] > 0;
    __syncthreads();

    float s[kRPT][kCPT], dp[kRPT][kCPT];
#pragma unroll
    for (int r = 0; r < kRPT; ++r)
#pragma unroll
      for (int t = 0; t < kCPT; ++t) s[r][t] = dp[r][t] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRPT], ov[kRPT], kv[kCPT], vv[kCPT];
#pragma unroll
      for (int r = 0; r < kRPT; ++r) {
        qv[r] = Qs[(rg + 16 * r) * kFS + d];
        ov[r] = dOs[(rg + 16 * r) * kFS + d];
      }
#pragma unroll
      for (int t = 0; t < kCPT; ++t) {
        kv[t] = to_f32(Ks[(cg + 16 * t) * L::KS + d]);
        vv[t] = to_f32(Vs[(cg + 16 * t) * L::KS + d]);
      }
#pragma unroll
      for (int r = 0; r < kRPT; ++r)
#pragma unroll
        for (int t = 0; t < kCPT; ++t) {
          s[r][t] = fmaf(qv[r], kv[t], s[r][t]);
          dp[r][t] = fmaf(ov[r], vv[t], dp[r][t]);
        }
    }
    // a = mask·exp(min(s − mt, 0)) from the forward's stabilizer;
    // ds = a ⊙ (do·vᵀ + dr)
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const int i = rg + 16 * r, qrow = row0 + i;
#pragma unroll
      for (int t = 0; t < kCPT; ++t) {
        const int j = cg + 16 * t;
        float ds = 0.f;
        if (pair_ok(fl, qrow, j, b, j < b && Km[j])) {
          const float a = expf(fminf(s[r][t] * scale - mt_r[r], 0.f));
          ds = a * (dp[r][t] + dr_r[r]);
        }
        dSs[i * kPS + j] = ds;
      }
    }
    __syncthreads();

    for (int j = 0; j < b; ++j) {
      float dv_[kRPT], kv[kCPT];
#pragma unroll
      for (int r = 0; r < kRPT; ++r) dv_[r] = dSs[(rg + 16 * r) * kPS + j];
#pragma unroll
      for (int t = 0; t < kCPT; ++t) kv[t] = to_f32(Ks[j * L::KS + cg + 16 * t]);
#pragma unroll
      for (int r = 0; r < kRPT; ++r)
#pragma unroll
        for (int t = 0; t < kCPT; ++t) acc[r][t] = fmaf(dv_[r], kv[t], acc[r][t]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRPT; ++r) {
    const int i = rg + 16 * r;
    if (i >= rows) continue;
#pragma unroll
    for (int t = 0; t < kCPT; ++t) {
      const int col = cg + 16 * t;
      if (col < D) dq[(qbase + i) * D + col] = acc[r][t] * scale;
    }
  }
}

// --------------------------------------------------------------------------
// backward, dk/dv: grid (BHKV, key block, key-row sub-tile) over the pairs
// of all G groups of a KV head, sorted by key block
// --------------------------------------------------------------------------
template <typename T>
struct DkvLayout {
  static constexpr int QS = tile_stride<T>();
  static constexpr size_t k = 0;                                        // float [kRT][kFS]
  static constexpr size_t v = align16(k + sizeof(float) * kRT * kFS);   // float [kRT][kFS]
  static constexpr size_t q = align16(v + sizeof(float) * kRT * kFS);   // T [kMaxB][QS]
  static constexpr size_t dout = align16(q + sizeof(T) * kMaxB * QS);   // float [kMaxB][kFS]
  static constexpr size_t a = align16(dout + sizeof(float) * kMaxB * kFS); // float [kRT][kPS]
  static constexpr size_t ds = align16(a + sizeof(float) * kRT * kPS);  // float [kRT][kPS]
  static constexpr size_t mt = align16(ds + sizeof(float) * kRT * kPS); // float [kMaxB]
  static constexpr size_t dr = align16(mt + sizeof(float) * kMaxB);     // float [kMaxB]
  static constexpr size_t bytes = align16(dr + sizeof(float) * kMaxB);
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ mt,
                   const float* __restrict__ dout, const float* __restrict__ dr,
                   const int* __restrict__ row_ptr, const int* __restrict__ rows_k,
                   const int* __restrict__ xs, const int* __restrict__ fls,
                   const int* __restrict__ km, float* __restrict__ dk,
                   float* __restrict__ dv, int n, int D, int b, int m2,
                   float scale) {
  using L = DkvLayout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Kt = reinterpret_cast<float*>(smem + L::k);
  float* Vt = reinterpret_cast<float*>(smem + L::v);
  T* Qb = reinterpret_cast<T*>(smem + L::q);
  float* dOb = reinterpret_cast<float*>(smem + L::dout);
  float* At = reinterpret_cast<float*>(smem + L::a);
  float* dSt = reinterpret_cast<float*>(smem + L::ds);
  float* Mts = reinterpret_cast<float*>(smem + L::mt);
  float* Drs = reinterpret_cast<float*>(smem + L::dr);

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int kvh = blockIdx.x, yb = blockIdx.y, row0 = blockIdx.z * kRT;
  const int nb = n / b;
  const int rows = min(kRT, b - row0);
  const size_t kbase = static_cast<size_t>(kvh) * n + static_cast<size_t>(yb) * b + row0;

  zero_smem(smem, L::bytes);
  __syncthreads();
  for (int e = tid; e < rows * D; e += kThreads) {
    const int i = e / D, d = e - i * D;
    Kt[i * kFS + d] = to_f32(k[(kbase + i) * D + d]);
    Vt[i * kFS + d] = to_f32(v[(kbase + i) * D + d]);
  }
  bool kvalid[kRPT];
  float dk_acc[kRPT][kCPT], dv_acc[kRPT][kCPT];
#pragma unroll
  for (int r = 0; r < kRPT; ++r) {
    const int i = rg + 16 * r;
    kvalid[r] = i < rows && km[kbase + i] > 0;
#pragma unroll
    for (int t = 0; t < kCPT; ++t) dk_acc[r][t] = dv_acc[r][t] = 0.f;
  }

  const int p0 = row_ptr[static_cast<size_t>(kvh) * (nb + 1) + yb];
  const int p1 = row_ptr[static_cast<size_t>(kvh) * (nb + 1) + yb + 1];
  for (int p = p0; p < p1; ++p) {
    const size_t pi = static_cast<size_t>(kvh) * m2 + p;
    const int owner = rows_k[pi], x = xs[pi], fl = fls[pi];
    const size_t qbase = static_cast<size_t>(owner) * n + static_cast<size_t>(x) * b;
    __syncthreads();
#pragma unroll 4
    for (int e = tid; e < b * D; e += kThreads) {
      const int j = e / D, d = e - j * D;
      const size_t g = (qbase + j) * D + d;
      Qb[j * L::QS + d] = q[g];
      dOb[j * kFS + d] = dout[g];
    }
    for (int j = tid; j < b; j += kThreads) {
      Mts[j] = mt[qbase + j];
      Drs[j] = dr[qbase + j];
    }
    __syncthreads();

    // transposed scores: rows are this tile's keys, columns the pair's
    // queries
    float s[kRPT][kCPT], dp[kRPT][kCPT];
#pragma unroll
    for (int r = 0; r < kRPT; ++r)
#pragma unroll
      for (int t = 0; t < kCPT; ++t) s[r][t] = dp[r][t] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[kRPT], vv[kRPT], qv[kCPT], ov[kCPT];
#pragma unroll
      for (int r = 0; r < kRPT; ++r) {
        kv[r] = Kt[(rg + 16 * r) * kFS + d];
        vv[r] = Vt[(rg + 16 * r) * kFS + d];
      }
#pragma unroll
      for (int t = 0; t < kCPT; ++t) {
        qv[t] = to_f32(Qb[(cg + 16 * t) * L::QS + d]);
        ov[t] = dOb[(cg + 16 * t) * kFS + d];
      }
#pragma unroll
      for (int r = 0; r < kRPT; ++r)
#pragma unroll
        for (int t = 0; t < kCPT; ++t) {
          s[r][t] = fmaf(kv[r], qv[t], s[r][t]);
          dp[r][t] = fmaf(vv[r], ov[t], dp[r][t]);
        }
    }
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const int i = rg + 16 * r, krow = row0 + i;
#pragma unroll
      for (int t = 0; t < kCPT; ++t) {
        const int j = cg + 16 * t;
        float a = 0.f, ds = 0.f;
        if (pair_ok(fl, j, krow, b, kvalid[r])) {
          a = expf(fminf(s[r][t] * scale - Mts[j], 0.f));
          ds = a * (dp[r][t] + Drs[j]);
        }
        At[i * kPS + j] = a;
        dSt[i * kPS + j] = ds;
      }
    }
    __syncthreads();

    for (int j = 0; j < b; ++j) {
      float av[kRPT], sv[kRPT], ov[kCPT], qv[kCPT];
#pragma unroll
      for (int r = 0; r < kRPT; ++r) {
        av[r] = At[(rg + 16 * r) * kPS + j];
        sv[r] = dSt[(rg + 16 * r) * kPS + j];
      }
#pragma unroll
      for (int t = 0; t < kCPT; ++t) {
        ov[t] = dOb[j * kFS + cg + 16 * t];
        qv[t] = to_f32(Qb[j * L::QS + cg + 16 * t]);
      }
#pragma unroll
      for (int r = 0; r < kRPT; ++r)
#pragma unroll
        for (int t = 0; t < kCPT; ++t) {
          dv_acc[r][t] = fmaf(av[r], ov[t], dv_acc[r][t]);
          dk_acc[r][t] = fmaf(sv[r], qv[t], dk_acc[r][t]);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < kRPT; ++r) {
    const int i = rg + 16 * r;
    if (i >= rows) continue;
#pragma unroll
    for (int t = 0; t < kCPT; ++t) {
      const int col = cg + 16 * t;
      if (col < D) {
        dk[(kbase + i) * D + col] = dk_acc[r][t] * scale;
        dv[(kbase + i) * D + col] = dv_acc[r][t];
      }
    }
  }
}

bool shape_ok(int rows, int n, int D, int b) {
  return rows > 0 && b > 0 && b <= kMaxB && D > 0 && D <= kMaxD && n % b == 0 &&
         n / b > 0 && n / b <= 65535;
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* c,
                       const void* ptr, const void* ys, const void* fl,
                       const void* km, void* out, void* rs, void* mt, int BHG,
                       int G, int n, int D, int b, int m, float scale,
                       cudaStream_t st) {
  const size_t smem = FwdLayout<T>::bytes;
  cudaError_t err = opt_in(bsa_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BHG, n / b, (b + kRT - 1) / kRT);
  bsa_fwd_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(c), static_cast<const int*>(ptr),
      static_cast<const int*>(ys), static_cast<const int*>(fl),
      static_cast<const int*>(km), static_cast<float*>(out),
      static_cast<float*>(rs), static_cast<float*>(mt), G, n, D, b, m, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* mt,
                      const void* dout, const void* dr, const void* ptr,
                      const void* ys, const void* fl, const void* km, void* dq,
                      int BHG, int G, int n, int D, int b, int m, float scale,
                      cudaStream_t st) {
  const size_t smem = DqLayout<T>::bytes;
  cudaError_t err = opt_in(bsa_bwd_dq_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BHG, n / b, (b + kRT - 1) / kRT);
  bsa_bwd_dq_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mt), static_cast<const float*>(dout),
      static_cast<const float*>(dr), static_cast<const int*>(ptr),
      static_cast<const int*>(ys), static_cast<const int*>(fl),
      static_cast<const int*>(km), static_cast<float*>(dq), G, n, D, b, m, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* mt,
                       const void* dout, const void* dr, const void* ptr,
                       const void* rows, const void* xs, const void* fl,
                       const void* km, void* dk, void* dv, int BHKV, int n,
                       int D, int b, int m2, float scale, cudaStream_t st) {
  const size_t smem = DkvLayout<T>::bytes;
  cudaError_t err = opt_in(bsa_bwd_dkv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BHKV, n / b, (b + kRT - 1) / kRT);
  bsa_bwd_dkv_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mt), static_cast<const float*>(dout),
      static_cast<const float*>(dr), static_cast<const int*>(ptr),
      static_cast<const int*>(rows), static_cast<const int*>(xs),
      static_cast<const int*>(fl), static_cast<const int*>(km),
      static_cast<float*>(dk), static_cast<float*>(dv), n, D, b, m2, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32 (q, k and v share it). Each entry point returns
// the cudaError_t of its launch (0 = launched).
extern "C" int bsa_fwd_launch(const void* q, const void* k, const void* v,
                              const void* c, const void* ptr, const void* ys,
                              const void* fl, const void* km, void* out, void* rs,
                              void* mt, int BHG, int G, int n, int D, int b, int m,
                              float scale, int dtype, void* stream) {
  if (!shape_ok(BHG, n, D, b) || G <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<__nv_bfloat16>(q, k, v, c, ptr, ys, fl, km, out, rs, mt, BHG,
                                     G, n, D, b, m, scale, st);
  if (dtype == 1)
    return launch_fwd<float>(q, k, v, c, ptr, ys, fl, km, out, rs, mt, BHG, G, n,
                             D, b, m, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" int bsa_bwd_dq_launch(const void* q, const void* k, const void* v,
                                 const void* mt, const void* dout, const void* dr,
                                 const void* ptr, const void* ys, const void* fl,
                                 const void* km, void* dq, int BHG, int G, int n,
                                 int D, int b, int m, float scale, int dtype,
                                 void* stream) {
  if (!shape_ok(BHG, n, D, b) || G <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dq<__nv_bfloat16>(q, k, v, mt, dout, dr, ptr, ys, fl, km, dq, BHG,
                                    G, n, D, b, m, scale, st);
  if (dtype == 1)
    return launch_dq<float>(q, k, v, mt, dout, dr, ptr, ys, fl, km, dq, BHG, G, n,
                            D, b, m, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" int bsa_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                  const void* mt, const void* dout, const void* dr,
                                  const void* ptr, const void* rows, const void* xs,
                                  const void* fl, const void* km, void* dk, void* dv,
                                  int BHKV, int n, int D, int b, int m2,
                                  float scale, int dtype, void* stream) {
  if (!shape_ok(BHKV, n, D, b)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dkv<__nv_bfloat16>(q, k, v, mt, dout, dr, ptr, rows, xs, fl, km,
                                     dk, dv, BHKV, n, D, b, m2, scale, st);
  if (dtype == 1)
    return launch_dkv<float>(q, k, v, mt, dout, dr, ptr, rows, xs, fl, km, dk, dv,
                             BHKV, n, D, b, m2, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* bsa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
