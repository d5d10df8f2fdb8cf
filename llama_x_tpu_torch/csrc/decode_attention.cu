// K3: decode attention, a few queries per row (Sq <= 8) over the static KV cache,
// bf16 cache or int8 cache with per-position f32 scales, bf16 queries and output.
//
// Replaces the Pallas TPU kernel llama_x_tpu/ops/decode_attention.py:_kernel
// (through _decode_call, decode_attention and decode_attention_int8), which every
// decode step of the JAX model runs (llama_x_tpu/models/llama.py:248-264).
//
// What it computes, as that kernel: the Sq queries x the GQA group of one kv head are
// packed query-major into rows (row r is query r / group, head r % group), each row
// masked at its own window (the staircase of speculative verify), scores in f32 times
// scale, a natural-exp online softmax in f32, P rounded to bf16 before P V, l == 0
// guarded; the int8 side dequantized as bf16(bf16(x) * bf16(scale)).
//
// What bounds it on an H100: the cache bytes that the windows cover, read once (B 4,
// 8 kv heads, D 128, windows up to 4096: 2 x 27 MB for bf16, 8.2 us at 3.35 TB/s; half
// that for the int8 cache plus its scales). The products are 4 * rows * D operations a
// position, far below the tensor cores.
//
// Design: split-KV on tensor cores. The grid is (splits, Hkv, B); the wrapper picks the
// splits from S_max and B * Hkv alone (ops/decode_attention.py:decode_split_plan, about
// four CTAs per SM) and never reads the windows on the host, so a launch needs no sync.
// A CTA takes one kv range, a multiple of 64 positions; one whose range starts at or
// past its batch row's longest window writes an empty partial (m -1e30, l 0) and exits.
// The rows are padded to RT 16-row tiles (RT 1, 2 or 4) and the 4 warps split as RT
// row tiles x 4 / RT kv slices of every 64-position tile; each warp holds its rows of Q
// as mma.m16n8k16 A fragments for the whole loop, computes S = Q K^T with K read by
// ldmatrix, and O += P V with P repacked from the S accumulator and V read by
// ldmatrix.trans. K and V tiles arrive by 16-byte cp.async through a ring of 3 stages
// (bf16) or 4 (int8), rows XOR-swizzled against bank conflicts; an int8 stage and its
// scales are dequantized once per CTA into a bf16 staging tile in the same layout. At
// the end the warps of a row tile merge their (m, l, acc) in shared memory; with one
// split the CTA writes bf16 out, else f32 partials that the merge kernel combines in
// split order: out = sum acc_i e^(m_i - M) / sum l_i e^(m_i - M), empty splits skipped,
// the l == 0 guard last. No atomics: the bits do not depend on the schedule.
//
// The design before this one (one CTA of 8 warps per (kv head, batch row), 32 CTAs on
// 132 SMs, f32 FMA products from shared memory) took, in chip_smoke.py on NVIDIA H100
// 80GB HBM3, 700.00 W, at B 4, 32/8 heads, D 128, lens 1/513/2048/4096: 0.316198 ms at
// Sq 1 (int8 cache 0.369821) and 1.037123 ms at Sq 5.

#include "common.cuh"

namespace {

constexpr int BKV = 64, THREADS = 128, WARPS = 4;
constexpr float NEG_INF = -1e30f;

struct Params {
  const __nv_bfloat16* q;
  const void *k, *v;
  const float *k_scale, *v_scale;  // int8 cache only
  const int* lens;                 // [B, Sq] per-query window lengths
  __nv_bfloat16* out;              // [B, Sq, Hq, D]
  float* part_acc;                 // [B, Hkv, splits, rows, D] (splits > 1)
  float* part_ml;                  // [B, Hkv, splits, rows, 2]
  int Sq, Hq, Hkv, S_max, rows, splits, split_len;
  float scale;
};

template <bool QUANT, int D>
struct Cfg {
  static constexpr int ROW = QUANT ? D : 2 * D;  // bytes of one cache row in the ring
  static constexpr int SIDE = BKV * ROW;
  static constexpr int STAGES = QUANT ? 4 : 3;
  static constexpr int STAGE = 2 * SIDE + (QUANT ? 2 * BKV * 4 : 0);  // K, V (+ their scales)
  static constexpr int RING = STAGES * STAGE;
  static constexpr int TILE = BKV * D * 2;  // one bf16 tile, swizzled rows of 2D bytes
  static constexpr int STAGING = QUANT ? 2 * TILE : 0;
  static constexpr int MERGE = WARPS * 16 * (D + 2) * 4;  // each warp's (m, l, acc) of its 16 rows
  static constexpr int SMEM = (RING + STAGING > MERGE ? RING + STAGING : MERGE);
};

// the ring stage of tile `kt`: 16-byte copies, positions past S_max zero-filled
template <bool QUANT, int D>
__device__ __forceinline__ void load_stage(const Params& p, unsigned char* st, size_t head_row0, int p0, int tid) {
  using C = Cfg<QUANT, D>;
  constexpr int CH = C::ROW / 16;  // 16-byte chunks per cache row
#pragma unroll
  for (int i = 0; i < BKV * CH / THREADS; ++i) {
    const int c = tid + i * THREADS, r = c / CH, ch = c % CH;
    const bool ok = p0 + r < p.S_max;
    const size_t off = (head_row0 + p0 + r) * C::ROW + ch * 16;
    // bf16 rows land swizzled (ldmatrix reads them); int8 rows land as they are (the
    // dequant pass reads them row-wise)
    const int dst = QUANT ? r * C::ROW + ch * 16 : lxt::swz(r, ch, C::ROW);
    lxt::cp_async_16(st + dst, ok ? static_cast<const char*>(p.k) + off : p.k, ok);
    lxt::cp_async_16(st + C::SIDE + dst, ok ? static_cast<const char*>(p.v) + off : p.v, ok);
  }
  if (QUANT) {  // one scale per thread: K for threads 0..63, V for 64..127
    const int r = tid % BKV;
    const bool ok = p0 + r < p.S_max;
    const float* src = (tid < BKV ? p.k_scale : p.v_scale) + head_row0 + p0 + r;
    lxt::cp_async_4(st + 2 * C::SIDE + (tid / BKV) * BKV * 4 + r * 4, ok ? src : p.k_scale, ok);
  }
}

// int8 stage -> bf16 staging tiles (K then V), bf16(bf16(x) * bf16(scale)) per element
template <int D>
__device__ __forceinline__ void dequant_stage(const unsigned char* st, unsigned char* staging, int tid) {
  constexpr int CH8 = D / 16;  // 16-byte int8 chunks per row
  const float* scales = reinterpret_cast<const float*>(st + 2 * BKV * D);
#pragma unroll
  for (int side = 0; side < 2; ++side) {
#pragma unroll
    for (int i = 0; i < BKV * CH8 / THREADS; ++i) {
      const int c = tid + i * THREADS, r = c / CH8, ch = c % CH8;
      const uint4 raw = *reinterpret_cast<const uint4*>(st + side * BKV * D + r * D + ch * 16);
      const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
      // bf16(x) is exact for |x| <= 127 and the bf16 product rounds once: bf16(bf16(x) * bf16(scale))
      const __nv_bfloat162 sc = __float2bfloat162_rn(scales[side * BKV + r]);
      uint4 lo, hi;
      __nv_bfloat162* l2 = reinterpret_cast<__nv_bfloat162*>(&lo);
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&hi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        l2[e] = __hmul2(__floats2bfloat162_rn(static_cast<float>(x[2 * e]), static_cast<float>(x[2 * e + 1])), sc);
        h2[e] = __hmul2(__floats2bfloat162_rn(static_cast<float>(x[8 + 2 * e]), static_cast<float>(x[9 + 2 * e])), sc);
      }
      unsigned char* tile = staging + side * Cfg<true, D>::TILE;
      *reinterpret_cast<uint4*>(tile + lxt::swz(r, 2 * ch, 2 * D)) = lo;
      *reinterpret_cast<uint4*>(tile + lxt::swz(r, 2 * ch + 1, 2 * D)) = hi;
    }
  }
}

template <bool QUANT, int D, int RT>
__global__ void __launch_bounds__(THREADS) decode_kernel(Params p) {
  using C = Cfg<QUANT, D>;
  constexpr int KS = WARPS / RT, SL = BKV / KS;  // kv slices per row tile, positions per slice
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rt = warp / KS, ks = warp % KS;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv, rows = p.rows;
  const size_t head_row0 = ((size_t)b * p.Hkv + hk) * p.S_max;  // first cache row of this head
  const size_t part_row0 = (((size_t)b * p.Hkv + hk) * p.splits + split) * rows;

  int max_len = 0;
  for (int i = 0; i < p.Sq; ++i) max_len = max(max_len, p.lens[b * p.Sq + i]);
  max_len = min(max_len, p.S_max);
  const int kv_start = split * p.split_len;
  const int live_end = min(kv_start + p.split_len, max_len);
  const int n_tiles = live_end > kv_start ? (live_end - kv_start + BKV - 1) / BKV : 0;

  if (n_tiles == 0) {
    if (p.splits > 1) {
      for (int r = tid; r < rows; r += THREADS) {
        p.part_ml[(part_row0 + r) * 2] = NEG_INF;
        p.part_ml[(part_row0 + r) * 2 + 1] = 0.f;
      }
    } else {
      for (int idx = tid; idx < rows * D; idx += THREADS) {
        const int r = idx / D, d = idx % D;
        p.out[(((size_t)b * p.Sq + r / group) * p.Hq + hk * group + r % group) * D + d] = __float2bfloat16(0.f);
      }
    }
    return;
  }

  // this thread's two rows (g and g + 8 of the warp's row tile): window and Q fragments
  int lim[2];
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = rt * 16 + g + 8 * h;
    lim[h] = R < rows ? min(p.lens[b * p.Sq + R / group], p.S_max) : 0;
    const __nv_bfloat16* qrow =
        p.q + (((size_t)b * p.Sq + (R < rows ? R / group : 0)) * p.Hq + hk * group + R % group) * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][h] = R < rows ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 2 * t) : 0u;
      qf[kk][2 + h] = R < rows ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 8 + 2 * t) : 0u;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};  // l_i: this thread's share of the row sum

  unsigned char* staging = smem + C::RING;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_tiles) load_stage<QUANT, D>(p, smem + s * C::STAGE, head_row0, kv_start + s * BKV, tid);
    lxt::cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    lxt::cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // tile it landed for every thread; the stage of tile it - 1 is free
    const int nxt = it + C::STAGES - 1;
    if (nxt < n_tiles) load_stage<QUANT, D>(p, smem + (nxt % C::STAGES) * C::STAGE, head_row0, kv_start + nxt * BKV, tid);
    lxt::cp_async_commit();
    const unsigned char* st = smem + (it % C::STAGES) * C::STAGE;
    const unsigned char *kt = st, *vt = st + C::SIDE;
    if (QUANT) {
      dequant_stage<D>(st, staging, tid);
      __syncthreads();
      kt = staging;
      vt = staging + C::TILE;
    }
    const int p0 = kv_start + it * BKV + ks * SL;  // first position of this warp's slice

    // S = Q K^T over the slice: 16 rows x SL positions
    float s[SL / 8][4];
#pragma unroll
    for (int i = 0; i < SL / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < SL / 16; ++np) {
        uint32_t bf[4];
        lxt::ldmatrix_x4(bf, kt + lxt::swz(ks * SL + np * 16 + (lane >> 4) * 8 + (lane & 7), 2 * kk + ((lane >> 3) & 1), 2 * D));
        lxt::mma_bf16_16816(s[2 * np], qf[kk], bf[0], bf[1]);
        lxt::mma_bf16_16816(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scale, the per-row window, the online softmax (a row lives in the 4 lanes of a quad)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < SL / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pos = p0 + i * 8 + 2 * t + e;
          float& x = s[i][2 * h + e];
          x = pos < lim[h] ? x * p.scale : NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[h], mx);
      const float alpha = expf(m_i[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < SL / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[i][2 * h + e];
          x = expf(x - m_new);
          sum += x;
        }
      l_i[h] = l_i[h] * alpha + sum;
      m_i[h] = m_new;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[i][2 * h] *= alpha;
        acc[i][2 * h + 1] *= alpha;
      }
    }

    // O += P V: P rounded to bf16 as the A operand, V through ldmatrix.trans
#pragma unroll
    for (int j = 0; j < SL / 16; ++j) {
      uint32_t pa[4];
      pa[0] = lxt::pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = lxt::pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = lxt::pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = lxt::pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];
        const int i4 = lane >> 3;
        lxt::ldmatrix_x4_trans(bf, vt + lxt::swz(ks * SL + 16 * j + (i4 & 1) * 8 + (lane & 7), 2 * dp + (i4 >> 1), 2 * D));
        lxt::mma_bf16_16816(acc[2 * dp], pa, bf[0], bf[1]);
        lxt::mma_bf16_16816(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
  }
  lxt::cp_async_wait<0>();
  __syncthreads();  // the ring is idle: its bytes now hold each warp's (m, l, acc)

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_i[h] += __shfl_xor_sync(0xffffffffu, l_i[h], 1);
    l_i[h] += __shfl_xor_sync(0xffffffffu, l_i[h], 2);
  }
  float* wm = reinterpret_cast<float*>(smem);  // [WARPS][16] m, then l, then acc [WARPS][16][D]
  float* wl = wm + WARPS * 16;
  float* wacc = wl + WARPS * 16;
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      wm[warp * 16 + g + 8 * h] = m_i[h];
      wl[warp * 16 + g + 8 * h] = l_i[h];
    }
  }
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) wacc[(warp * 16 + g + 8 * (e >> 1)) * D + i * 8 + 2 * t + (e & 1)] = acc[i][e];
  __syncthreads();

  // merge the kv slices of each row tile in slice order, then out or the split's partial
  for (int idx = tid; idx < rows * D; idx += THREADS) {
    const int R = idx / D, d = idx % D, rr = R % 16, w0 = (R / 16) * KS;
    float M = NEG_INF;
#pragma unroll
    for (int k = 0; k < KS; ++k) M = fmaxf(M, wm[(w0 + k) * 16 + rr]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const float w = expf(wm[(w0 + k) * 16 + rr] - M);
      L += wl[(w0 + k) * 16 + rr] * w;
      A += wacc[((w0 + k) * 16 + rr) * D + d] * w;
    }
    if (p.splits == 1) {
      p.out[(((size_t)b * p.Sq + R / group) * p.Hq + hk * group + R % group) * D + d] =
          __float2bfloat16(A / (L == 0.f ? 1.f : L));
    } else {
      p.part_acc[(part_row0 + R) * D + d] = A;
      if (d == 0) {
        p.part_ml[(part_row0 + R) * 2] = M;
        p.part_ml[(part_row0 + R) * 2 + 1] = L;
      }
    }
  }
}

// grid (rows, Hkv, B), D threads: the splits of one row in split order. The splits' (m, l)
// are staged in shared memory first, so the acc loads of all splits are in flight at once.
__global__ void decode_merge_kernel(Params p, int D) {
  extern __shared__ float ml_s[];  // [splits][2]
  const int R = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int group = p.Hq / p.Hkv, rows = p.rows;
  const size_t row0 = ((size_t)b * p.Hkv + hk) * p.splits * rows + R;
  for (int s = d; s < p.splits; s += blockDim.x) {
    ml_s[2 * s] = p.part_ml[(row0 + (size_t)s * rows) * 2];
    ml_s[2 * s + 1] = p.part_ml[(row0 + (size_t)s * rows) * 2 + 1];
  }
  __syncthreads();
  float M = NEG_INF;
  for (int s = 0; s < p.splits; ++s) M = fmaxf(M, ml_s[2 * s]);
  float L = 0.f, A = 0.f;
#pragma unroll 8
  for (int s = 0; s < p.splits; ++s) {
    const float l = ml_s[2 * s + 1];
    if (l == 0.f) continue;  // an empty split (its range starts past every window)
    const float w = expf(ml_s[2 * s] - M);
    L += l * w;
    A += p.part_acc[(row0 + (size_t)s * rows) * D + d] * w;
  }
  p.out[(((size_t)b * p.Sq + R / group) * p.Hq + hk * group + R % group) * D + d] =
      __float2bfloat16(A / (L == 0.f ? 1.f : L));
}

template <bool QUANT, int D, int RT>
int launch_rt(const Params& p, int B, cudaStream_t st) {
  constexpr int bytes = Cfg<QUANT, D>::SMEM;
  static const cudaError_t attr =  // once per instantiation and process (one card a process)
      cudaFuncSetAttribute(decode_kernel<QUANT, D, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  decode_kernel<QUANT, D, RT><<<dim3(p.splits, p.Hkv, B), THREADS, bytes, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  decode_merge_kernel<<<dim3(p.rows, p.Hkv, B), D, 2 * p.splits * sizeof(float), st>>>(p, D);
  return static_cast<int>(cudaGetLastError());
}

template <bool QUANT, int D>
int launch(const Params& p, int B, cudaStream_t st) {
  const int rt = (p.rows + 15) / 16;
  if (rt == 1) return launch_rt<QUANT, D, 1>(p, B, st);
  if (rt == 2) return launch_rt<QUANT, D, 2>(p, B, st);
  if (rt <= 4) return launch_rt<QUANT, D, 4>(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// splits and split_len: ops/decode_attention.py:decode_split_plan (split_len a multiple
// of 64, splits * split_len >= S_max); part_acc / part_ml: f32 scratch, unused with one split
extern "C" int lxt_decode_attention(const void* q, const void* k, const void* v, const void* k_scale,
                                    const void* v_scale, const void* lens, void* out, void* part_acc, void* part_ml,
                                    int B, int Sq, int Hq, int Hkv, int S_max, int D, float scale, int quantized,
                                    int splits, int split_len, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lens = static_cast<const int*>(lens);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.Sq = Sq;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.S_max = S_max;
  p.rows = Sq * (Hq / Hkv);
  p.splits = splits;
  p.split_len = split_len;
  p.scale = scale;
  if (splits < 1 || split_len % BKV || (long long)splits * split_len < S_max || (splits > 1 && (!part_acc || !part_ml)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 128) return quantized ? launch<true, 128>(p, B, st) : launch<false, 128>(p, B, st);
  if (D == 64) return quantized ? launch<true, 64>(p, B, st) : launch<false, 64>(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
