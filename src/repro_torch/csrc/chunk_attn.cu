// chunk_attn.cu — MRA-2 chunk/decode serving attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/chunk_attn.py::_chunk_kernel (the
// pallas_call in _chunk_attention_call), both of its programs: the two-level
// one (with_upper=False) and the H-level fold (with_upper=True, compile-time
// UPPER here). It computes, for one (batch·kv-head row, query tile) per
// thread block:
//   1. coarse scores q · k̄_y · scale against every page mean, the causal
//      block mask (live ∧ pb <= q_pos // b, floor division: padded rows have
//      q_pos = -1 and see no page) and FORCE_BONUS on the own live block;
//   2. top-m per query row as m rounds of argmax, lowest page index winning
//      ties, picked entries knocked out with -2e9 (below NEG_INF), an invalid
//      pick selecting nothing — jax.lax.top_k's order, bit for bit;
//   3. the exact term over the union of the tile's selected pages, visited in
//      ascending physical page order: each page's K and V are staged once in
//      shared memory as fp32 (int8 pages dequantized with their per-token
//      scales), only the rows that picked the page use it, under the exact
//      pos <= q_pos mask, with a flash-style online softmax (per-row running
//      max, fp32 accumulator and row sum);
//   4. the coarse background Σ exp(μ − c)·count·v̄ over live, allowed,
//      unselected, non-own pages on the two-level stabilizer
//      c_tok = max(c, running max), then normalization; rows with no live
//      key come out as exact zeros.
//   UPPER (levels >= 3, DESIGN.md §14) adds the collapsed levels + tail:
//   NU per-entry fp32 means hk / hv per (batch·kv-head) row and counts hcnt
//   per batch row. Pass 1 takes the live entries' scores hmu = q·hk·scale
//   into c before any exp (c = max(c_coarse, max_live hmu), then
//   c_tok = max(c, running max)); after the live-page background, pass 2
//   adds adj·Σ exp(hmu − c)·hcnt·hv and the matching row sum. The entries
//   are strictly older than every query, so liveness (hcnt > 0) is the only
//   gate, and a row with no live window key but live entries is not zero.
//   Both passes stream the entries through the K/V page and score buffers
//   (free after the page loop) in tiles of at most b entries, so the fold
//   needs no shared memory of its own for any NU.
//
// What bounds it on this card: bytes. A block must read the K/V pages in the
// union of its rows' selections plus the page means, counts and page table;
// the arithmetic per byte read (about 2·rows FLOP per staged fp32 element)
// stays far below the H100's ridge point. What the design does about it:
// each selected page is read from device memory once per tile and reused by
// every row of the tile that picked it; the coarse-score tensor, the
// selection and the gathered pages never reach device memory; one block owns
// each output tile, so there are no atomics and no second pass. The H-level
// fold reads 2·NU·D more fp32 per block (33 KB at NU = 33, D = 128). This first
// version uses CUDA cores in fp32 and one block per SM (a block takes 135,568
// bytes of shared memory at b = D = 128 in latency mode, 163,232 with 16 rows);
// tensor cores, TMA and overlapped page loads are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py); plain C entry
//        points, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define CHUNK_ATTN_THREADS 256

namespace {

constexpr float kNegInf = -1e9f;     // repro NEG_INF
constexpr float kForceBonus = 2e9f;  // repro FORCE_BONUS
constexpr float kPicked = -2e9f;     // knock-out of already-picked pages
constexpr unsigned kFull = 0xffffffffu;

// Python/JAX floor division: -1 // b == -1 (C++ '/' would give 0).
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return ((a % b) != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Shared-memory layout; the wrapper's smem_bytes() mirrors it.
struct Smem {
  float* q;      // rows x D query tile
  float* kp;     // b x (D + 1) K page (padded rows: conflict-free dots)
  float* vp;     // b x D V page
  float* s;      // rows x b page scores, then softmax weights
  float* cm;     // rows x nb masked coarse scores (coarse_m)
  float* ss;     // rows x nb selection scores (coarse_m + FORCE_BONUS·own)
  float* w;      // rows x nb background weights
  float* acc;    // rows x D exact-term numerator
  int* qp;       // rows query positions (-1 = padded row)
  float* mt;     // rows running fine-score max
  float* rs;     // rows row sums
  float* c;      // rows coarse stabilizer c
  float* al;     // rows per-page rescale, then fine_adj
  float* adj;    // rows background rescale exp(c - c_tok)
  uint8_t* sel;  // rows x nb selected pages
  uint8_t* any;  // nb union of the tile's selections
};

__device__ __forceinline__ Smem smem_layout(unsigned char* raw, int rows,
                                            int D, int b, int nb) {
  Smem m;
  float* f = reinterpret_cast<float*>(raw);
  m.q = f;           f += rows * D;
  m.kp = f;          f += b * (D + 1);
  m.vp = f;          f += b * D;
  m.s = f;           f += rows * b;
  m.cm = f;          f += rows * nb;
  m.ss = f;          f += rows * nb;
  m.w = f;           f += rows * nb;
  m.acc = f;         f += rows * D;
  m.qp = reinterpret_cast<int*>(f);  f += rows;
  m.mt = f;          f += rows;
  m.rs = f;          f += rows;
  m.c = f;           f += rows;
  m.al = f;          f += rows;
  m.adj = f;         f += rows;
  m.sel = reinterpret_cast<uint8_t*>(f);
  m.any = m.sel + rows * nb;
  return m;
}

// One tile of ne <= b collapsed entries starting at e0: hk rows staged into
// kp (and hv rows into vp when WEIGHTS), then per (row, entry) into s either
// the live score hmu (-inf for a dead entry; pass 1) or, with WEIGHTS, the
// background weight exp(hmu - c)·count (0 for a dead entry; pass 2).
template <bool WEIGHTS>
__device__ __forceinline__ void upper_tile(const Smem& sm,
                                           const float* __restrict__ hk_r,
                                           const float* __restrict__ hv_r,
                                           const float* __restrict__ hc_r,
                                           int e0, int ne, int rows, int D,
                                           int b, float scale) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  __syncthreads();  // earlier readers of kp / vp / s are done
  for (int i = tid; i < ne * D; i += nthreads) {
    const int t = i / D, d = i - t * D;
    sm.kp[t * (D + 1) + d] = hk_r[(size_t)(e0 + t) * D + d];
    if (WEIGHTS) sm.vp[i] = hv_r[(size_t)e0 * D + i];
  }
  __syncthreads();
  for (int i = tid; i < rows * ne; i += nthreads) {
    const int rr = i / ne, t = i - rr * ne;
    const float cnt = hc_r[e0 + t];
    float sv = WEIGHTS ? 0.f : -INFINITY;
    if (cnt > 0.f) {
      const float* qr = sm.q + rr * D;
      const float* kr = sm.kp + t * (D + 1);
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
      sv = dot * scale;
      if (WEIGHTS) sv = expf(sv - sm.c[rr]) * cnt;
    }
    sm.s[rr * b + t] = sv;
  }
  __syncthreads();
}

template <typename T, bool QUANT, bool BG, bool UPPER>
__global__ void __launch_bounds__(CHUNK_ATTN_THREADS)
chunk_attn_kernel(const float* __restrict__ q,       // (BKV, G, C, D)
                  const int* __restrict__ qpos,      // (B, C)
                  const float* __restrict__ kds,     // (BKV, nb, D)
                  const float* __restrict__ vds,     // (BKV, nb, D)
                  const float* __restrict__ counts,  // (B, nb)
                  const int* __restrict__ pb,        // (B, nb)
                  const T* __restrict__ kc,          // (BKV, nb * b, D)
                  const T* __restrict__ vc,          // (BKV, nb * b, D)
                  const float* __restrict__ ks,      // (BKV, nb * b) or null
                  const float* __restrict__ vs,      // (BKV, nb * b) or null
                  const float* __restrict__ hk,      // (BKV, NU, D) or null
                  const float* __restrict__ hv,      // (BKV, NU, D) or null
                  const float* __restrict__ hcnt,    // (B, NU) or null
                  float* __restrict__ out,           // (BKV, G, C, D)
                  int Hkv, int G, int C, int D, int nb, int b, int m,
                  int c_tile, int NU, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int r = blockIdx.x;  // batch·kv-head row
  const int tile = blockIdx.y;
  const int bi = r / Hkv;
  const int rows = G * c_tile;  // query row rr = g * c_tile + ci
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int S = nb * b;
  Smem sm = smem_layout(smem_raw, rows, D, b, nb);

  const float* kds_r = kds + (size_t)r * nb * D;
  const float* vds_r = vds + (size_t)r * nb * D;
  const float* cnt_r = counts + (size_t)bi * nb;
  const int* pb_r = pb + (size_t)bi * nb;

  // ---- query tile, positions, accumulators ---------------------------------
  for (int i = tid; i < rows * D; i += nthreads) {
    const int rr = i / D, d = i - rr * D;
    const int g = rr / c_tile, c = tile * c_tile + rr % c_tile;
    sm.q[i] = c < C ? q[((size_t)(r * G + g) * C + c) * D + d] : 0.f;
    sm.acc[i] = 0.f;
  }
  for (int rr = tid; rr < rows; rr += nthreads) {
    const int c = tile * c_tile + rr % c_tile;
    sm.qp[rr] = c < C ? qpos[(size_t)bi * C + c] : -1;
    sm.mt[rr] = kNegInf;
    sm.rs[rr] = 0.f;
  }
  for (int y = tid; y < nb; y += nthreads) sm.any[y] = 0;
  __syncthreads();

  // ---- coarse scores + causal/validity masks: one warp per (row, page) -----
  for (int p = warp; p < rows * nb; p += nwarps) {
    const int rr = p / nb, y = p - rr * nb;
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) dot += sm.q[rr * D + d] * kds_r[(size_t)y * D + d];
    dot = warp_sum(dot);
    if (lane == 0) {
      const int jq = floor_div(sm.qp[rr], b);
      const int pby = pb_r[y];
      const bool live = cnt_r[y] > 0.f;
      const bool allowed = live && pby <= jq;
      const bool ownl = pby == jq && pby >= 0 && live;
      const float cmv = allowed ? dot * scale : kNegInf;
      sm.cm[p] = cmv;
      sm.ss[p] = cmv + (ownl ? kForceBonus : 0.f);
      sm.sel[p] = 0;
    }
  }
  __syncthreads();

  // ---- top-m: m rounds of (row max, lowest index among ties), warp per row -
  for (int rr = warp; rr < rows; rr += nwarps) {
    const float* cm = sm.cm + rr * nb;
    float* ss = sm.ss + rr * nb;
    const int jq = floor_div(sm.qp[rr], b);
    float cmax = -INFINITY;
    for (int y = lane; y < nb; y += 32) cmax = fmaxf(cmax, cm[y]);
    cmax = warp_max(cmax);
    if (lane == 0) sm.c[rr] = fmaxf(cmax, kNegInf * 0.5f);
    for (int round = 0; round < m; ++round) {
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

  // ---- exact term: the tile's selection union, ascending page order --------
  const T* kc_r = kc + (size_t)r * S * D;
  const T* vc_r = vc + (size_t)r * S * D;
  for (int j = 0; j < nb; ++j) {
    if (!sm.any[j]) continue;  // block-uniform: read from shared memory
    __syncthreads();           // the previous page is no longer read
    const size_t base = (size_t)j * b * D;
    for (int i = tid; i < b * D; i += nthreads) {
      const int t = i / D, d = i - t * D;
      float kv = to_f32(kc_r[base + i]);
      float vv = to_f32(vc_r[base + i]);
      if (QUANT) {
        kv *= ks[(size_t)r * S + (size_t)j * b + t];
        vv *= vs[(size_t)r * S + (size_t)j * b + t];
      }
      sm.kp[t * (D + 1) + d] = kv;
      sm.vp[i] = vv;
    }
    __syncthreads();
    const int blk = pb_r[j];  // logical block held by physical page j
    for (int i = tid; i < rows * b; i += nthreads) {
      const int rr = i / b, t = i - rr * b;
      float sv = -INFINITY;  // -inf: position not attended by this row
      const int pos = blk * b + t;
      if (sm.sel[rr * nb + j] && pos >= 0 && pos <= sm.qp[rr]) {
        const float* qr = sm.q + rr * D;
        const float* kr = sm.kp + t * (D + 1);
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        sv = dot * scale;
      }
      sm.s[i] = sv;
    }
    __syncthreads();
    for (int rr = warp; rr < rows; rr += nwarps) {
      if (!sm.sel[rr * nb + j]) continue;
      float* sr = sm.s + rr * b;
      float mx = -INFINITY;
      for (int t = lane; t < b; t += 32) mx = fmaxf(mx, sr[t]);
      mx = warp_max(mx);
      const float m_old = sm.mt[rr];
      const float m_new = fmaxf(m_old, mx);  // m_old >= NEG_INF: finite
      float sum = 0.f;
      for (int t = lane; t < b; t += 32) {
        const float a = sr[t] == -INFINITY ? 0.f : expf(sr[t] - m_new);
        sr[t] = a;
        sum += a;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sm.al[rr] = alpha;
        sm.rs[rr] = sm.rs[rr] * alpha + sum;
        sm.mt[rr] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < rows * D; i += nthreads) {
      const int rr = i / D, d = i - rr * D;
      if (!sm.sel[rr * nb + j]) continue;
      const float* ar = sm.s + rr * b;
      float pv = 0.f;
      for (int t = 0; t < b; ++t) pv += ar[t] * sm.vp[t * D + d];
      sm.acc[i] = sm.acc[i] * sm.al[rr] + pv;
    }
  }
  __syncthreads();

  // ---- H-level fold, pass 1: live collapsed maxima join c -----------------
  const float* hk_r = UPPER ? hk + (size_t)r * NU * D : nullptr;
  const float* hv_r = UPPER ? hv + (size_t)r * NU * D : nullptr;
  const float* hc_r = UPPER ? hcnt + (size_t)bi * NU : nullptr;
  if (UPPER) {
    for (int e0 = 0; e0 < NU; e0 += b) {
      const int ne = min(b, NU - e0);
      upper_tile<false>(sm, hk_r, hv_r, hc_r, e0, ne, rows, D, b, scale);
      for (int rr = warp; rr < rows; rr += nwarps) {
        float mx = -INFINITY;
        for (int t = lane; t < ne; t += 32) mx = fmaxf(mx, sm.s[rr * b + t]);
        mx = warp_max(mx);
        if (lane == 0) sm.c[rr] = fmaxf(sm.c[rr], mx);
      }
    }
    __syncthreads();
  }

  // ---- background + two-level stabilizer + normalize -----------------------
  for (int rr = warp; rr < rows; rr += nwarps) {
    const float c = sm.c[rr];
    const float mt = sm.mt[rr];
    const float c_tok = fmaxf(c, mt);
    float wsum = 0.f;
    if (BG) {
      const int jq = floor_div(sm.qp[rr], b);
      for (int y = lane; y < nb; y += 32) {
        const int pby = pb_r[y];
        const float cnt = cnt_r[y];
        const bool live = cnt > 0.f;
        const bool allowed = live && pby <= jq;
        const bool ownl = pby == jq && pby >= 0 && live;
        const bool bg = allowed && !ownl && !sm.sel[rr * nb + y];
        const float w = bg ? expf(sm.cm[rr * nb + y] - c) * cnt : 0.f;
        sm.w[rr * nb + y] = w;
        wsum += w;
      }
      wsum = warp_sum(wsum);
    }
    if (lane == 0) {
      const float fine_adj = expf(mt - c_tok);  // mt <= c_tok, so <= 1
      const float adj = expf(c - c_tok);
      sm.al[rr] = fine_adj;
      sm.adj[rr] = adj;
      sm.rs[rr] = sm.rs[rr] * fine_adj + adj * wsum;
    }
  }
  __syncthreads();
  if (UPPER) {
    // ---- H-level fold, pass 2: adj · Σ exp(hmu − c)·count·v̄ into acc, rs --
    // acc is brought onto c_tok first; element i stays with thread i below
    for (int i = tid; i < rows * D; i += nthreads) sm.acc[i] *= sm.al[i / D];
    for (int e0 = 0; e0 < NU; e0 += b) {
      const int ne = min(b, NU - e0);
      upper_tile<true>(sm, hk_r, hv_r, hc_r, e0, ne, rows, D, b, scale);
      for (int rr = warp; rr < rows; rr += nwarps) {
        float sum = 0.f;
        for (int t = lane; t < ne; t += 32) sum += sm.s[rr * b + t];
        sum = warp_sum(sum);
        if (lane == 0) sm.rs[rr] += sm.adj[rr] * sum;
      }
      for (int i = tid; i < rows * D; i += nthreads) {
        const int rr = i / D, d = i - rr * D;
        const float* wr = sm.s + rr * b;
        float pv = 0.f;
        for (int t = 0; t < ne; ++t) pv += wr[t] * sm.vp[t * D + d];
        sm.acc[i] += sm.adj[rr] * pv;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < rows * D; i += nthreads) {
    const int rr = i / D, d = i - rr * D;
    const int g = rr / c_tile, c = tile * c_tile + rr % c_tile;
    if (c >= C) continue;  // padded row of a ragged last tile
    float o = UPPER ? sm.acc[i] : sm.acc[i] * sm.al[rr];
    if (BG) {
      const float* wr = sm.w + rr * nb;
      float bgv = 0.f;
      for (int y = 0; y < nb; ++y) bgv += wr[y] * vds_r[(size_t)y * D + d];
      o += sm.adj[rr] * bgv;
    }
    const float rsum = sm.rs[rr];
    out[((size_t)(r * G + g) * C + c) * D + d] = rsum > 0.f ? o / rsum : 0.f;
  }
}

template <typename T, bool QUANT, bool BG, bool UPPER>
cudaError_t launch(const void* q, const void* qpos, const void* kds,
                   const void* vds, const void* counts, const void* pb,
                   const void* k, const void* v, const void* ks,
                   const void* vs, const void* hk, const void* hv,
                   const void* hcnt, void* out, int B, int Hkv, int G, int C,
                   int D, int nb, int b, int m, int c_tile, int NU,
                   float scale, int smem, cudaStream_t stream) {
  auto kernel = chunk_attn_kernel<T, QUANT, BG, UPPER>;
  static int configured = 0;  // dynamic shared memory already allowed
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  dim3 grid(B * Hkv, (C + c_tile - 1) / c_tile);
  kernel<<<grid, CHUNK_ATTN_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int*>(qpos),
      static_cast<const float*>(kds), static_cast<const float*>(vds),
      static_cast<const float*>(counts), static_cast<const int*>(pb),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const float*>(hk), static_cast<const float*>(hv),
      static_cast<const float*>(hcnt), static_cast<float*>(out), Hkv, G, C,
      D, nb, b, m, c_tile, NU, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32, 2 = int8 (with per-token scales ks/vs).
// NU > 0 launches the H-level program over hk / hv / hcnt (background on
// only); NU = 0 the two-level one (the three pointers unused).
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int chunk_attn_launch(const void* q, const void* qpos,
                                 const void* kds, const void* vds,
                                 const void* counts, const void* pb,
                                 const void* k, const void* v, const void* ks,
                                 const void* vs, const void* hk,
                                 const void* hv, const void* hcnt, void* out,
                                 int B, int Hkv, int G, int C, int D, int nb,
                                 int b, int m, int c_tile, int NU,
                                 float scale, int dtype, int include_bg,
                                 int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CHUNK_ATTN_ARGS                                                     \
  q, qpos, kds, vds, counts, pb, k, v, ks, vs, hk, hv, hcnt, out, B, Hkv, G, \
      C, D, nb, b, m, c_tile, NU, scale, smem, st
  cudaError_t err;
  if (NU < 0 || (NU > 0 && !include_bg)) {
    err = cudaErrorInvalidValue;
  } else if (dtype == 0) {
    err = NU > 0       ? launch<__nv_bfloat16, false, true, true>(CHUNK_ATTN_ARGS)
          : include_bg ? launch<__nv_bfloat16, false, true, false>(CHUNK_ATTN_ARGS)
                       : launch<__nv_bfloat16, false, false, false>(CHUNK_ATTN_ARGS);
  } else if (dtype == 1) {
    err = NU > 0       ? launch<float, false, true, true>(CHUNK_ATTN_ARGS)
          : include_bg ? launch<float, false, true, false>(CHUNK_ATTN_ARGS)
                       : launch<float, false, false, false>(CHUNK_ATTN_ARGS);
  } else if (dtype == 2) {
    err = NU > 0       ? launch<int8_t, true, true, true>(CHUNK_ATTN_ARGS)
          : include_bg ? launch<int8_t, true, true, false>(CHUNK_ATTN_ARGS)
                       : launch<int8_t, true, false, false>(CHUNK_ATTN_ARGS);
  } else {
    err = cudaErrorInvalidValue;
  }
#undef CHUNK_ATTN_ARGS
  return static_cast<int>(err);
}

extern "C" const char* chunk_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
