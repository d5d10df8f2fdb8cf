// K1: int8 x int8 GEMM with the weight in its stored [N, K] layout and a fused
// row-scale x col-scale dequant epilogue:
//   C[m, n] = float(sum_k a[m, k] * b[n, k]) * row_scale[m] * col_scale[n]   (bf16 or f32 out)
//
// Replaces the Pallas TPU kernel llama_x_tpu/ops/int8_mm.py:_kernel as reached
// through int8_mm_dequant_nt_pallas (b_nk=True): the forward of every frozen-base
// projection when LlamaConfig.dynamic_int8_act is set (llama_x_tpu/ops/int8.py:155-157),
// and the int8 head's logits in the fused cross-entropy.
//
// What bounds it on an H100: at decode (M = batch, 1 to 16 rows) the weight bytes, N*K
// read once (the 14336x4096 w1 is 58.7 MB, 17.5 us at 3.35 TB/s; 218 MB a layer at the
// 8B shapes); at prefill and in training (M = B*S) the int8 tensor-core rate, 2*M*N*K
// operations at 1979 TOP/s (0.243 ms at M 4096, N 14336, K 4096).
//
// Design: two paths, chosen by ops/int8_mm.py:int8_mm_plan (the one place the M
// threshold lives), which hands this entry point (path, tile width, splits).
// - wgmma path (M above the threshold): a persistent, warp-specialized kernel, one CTA
//   per SM walking output tiles of 128 x BN (BN 256, or 128 where 256 leaves SMs idle)
//   in grouped order (GROUP_M row tiles share a column sweep, so the weight strips are
//   read from L2). One producer warp issues TMA loads of 128-byte-deep K boxes of a and
//   b (2-D tensor maps over [M, K] and [N, K] as they lie, 128-byte swizzle, boxes past
//   any edge zero-filled: ragged M, N and K need no mask in the loop) into a ring of 4
//   (BN 256) or 6 (BN 128) stages; two consumer warpgroups (setmaxnreg 232, producer 40)
//   each multiply 64 rows with wgmma m64nBNk32 s32.s8.s8, both operands K-major from
//   shared memory (the only layout wgmma takes for 8-bit types, and the weight's stored
//   one), one group of products kept in flight while the previous stage is released.
//   The epilogue runs from the accumulator registers while the producer already loads
//   the next tile. Where the tiles are fewer than half the SMs, K is split.
// - weight-streaming path (decode, M up to the threshold): a CTA of 4 warps streams a
//   strip of 64 weight rows over one K slice, 128 bytes deep per stage, through a
//   6-stage cp.async ring (16-byte loads, XOR-swizzled rows); a is padded to 16-row
//   tiles; ldmatrix feeds mma.sync m16n8k32 s8. Where the strips are fewer than the
//   SMs (N 4096 and 1024), split-K brings the grid to about one CTA per SM.
// Split-K on either path: every split writes its exact int32 partial to a scratch
// [splits, M, N]; the last split of a tile to arrive (an int32 counter per tile, reset
// by that split) adds the others' partials and runs the epilogue. int32 sums are exact,
// so the result is bit for bit the plain version's in any order, and one launch does it.
// The counters start at zero (the wrapper's cached tensor) and are left at zero.
//
// The design before this one (one CTA of 8 warps per 128 x 128 tile, a 2-stage cp.async
// ring, mma.sync m16n8k32 for every M) took, in chip_smoke.py on NVIDIA H100 80GB HBM3,
// 700.00 W: 1.1532 ms at M 4096, N 14336, K 4096; 0.589941 ms at M 2048, N 14336, K 4096;
// 1.3622 ms for the CE logits (M 512, N 128256, K 4096, f32 out); 0.048134 ms at M 4,
// N 14336, K 4096 and 0.138075 ms at M 4, N 4096, K 14336.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int PATH_STREAM = 0, PATH_WGMMA = 1;

struct Args {
  const int8_t* a;
  const int8_t* b;
  const float* rs;
  const float* cs;
  void* out;
  int* part;      // [splits, M, N] int32 partials (splits > 1)
  int* counters;  // one per output tile or strip, zero between launches
  int M, N, K, out_f32, splits;
};

__device__ __forceinline__ void store_out(const Args& p, int m, int n, float v0, float v1, bool pair) {
  const size_t off = (size_t)m * p.N + n;
  if (p.out_f32) {
    float* o = static_cast<float*>(p.out) + off;
    if (pair && !(p.N & 1)) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      o[0] = v0;
      if (pair) o[1] = v1;
    }
  } else {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + off;
    if (pair && !(p.N & 1)) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
    } else {
      o[0] = __float2bfloat16(v0);
      if (pair) o[1] = __float2bfloat16(v1);
    }
  }
}

// The scales an epilogue needs, loaded before its first store: the compiler cannot tell
// that `out` does not alias them, so a load after a store would wait for that store.
__device__ __forceinline__ float row_scale(const Args& p, int m) { return m < p.M ? __ldg(p.rs + m) : 0.f; }
__device__ __forceinline__ float2 col_scales(const Args& p, int n) {
  return make_float2(n < p.N ? __ldg(p.cs + n) : 0.f, n + 1 < p.N ? __ldg(p.cs + n + 1) : 0.f);
}

// the epilogue of two neighbouring columns n, n + 1 (n + 1 may lie past N) of row m,
// float(acc) * row scale * column scale in that order (the plain version's)
__device__ __forceinline__ void epilogue_pair(const Args& p, int m, int n, int acc0, int acc1, float r, float2 c) {
  if (m >= p.M || n >= p.N) return;
  store_out(p, m, n, static_cast<float>(acc0) * r * c.x, static_cast<float>(acc1) * r * c.y, n + 1 < p.N);
}

// Split-K arrival: after this thread's partials are written, the `threads` threads of
// the caller sync (barrier `bar_id`, or the whole CTA for 0); one counts the arrival
// and the return value says whether this split came last (it then resets the counter).
__device__ __forceinline__ bool arrive_last(int* counter, int splits, int* flag, int leader, int bar_id, int threads) {
  __threadfence();
  if (bar_id) lxt::named_sync(bar_id, threads); else __syncthreads();
  if (leader) {
    const int old = atomicAdd(counter, 1);
    const int last = old == splits - 1;
    if (last) *counter = 0;
    *flag = last;
  }
  if (bar_id) lxt::named_sync(bar_id, threads); else __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// ================= weight-streaming path (decode) =================

constexpr int S_BN = 64, S_BK = 128, S_STAGES = 6, S_THREADS = 128;

template <int MT>
constexpr int stream_smem() {
  return S_STAGES * (S_BN + MT * 16) * S_BK;
}

// grid (strips of 64 weight rows, splits); warp w owns rows 16w..16w+15 of the strip
template <int MT>
__global__ void __launch_bounds__(S_THREADS) int8_mm_nt_stream_kernel(const Args p, int kb_per_split) {
  extern __shared__ __align__(128) int8_t smem[];
  int8_t* bs = smem;                         // [S_STAGES][S_BN][S_BK] swizzled
  int8_t* as = smem + S_STAGES * S_BN * S_BK;  // [S_STAGES][MT * 16][S_BK] swizzled
  __shared__ int flag;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * S_BN, split = blockIdx.y;
  const int kbs = (p.K + S_BK - 1) / S_BK;
  const int kb0 = split * kb_per_split, nkb = min(kb0 + kb_per_split, kbs) - kb0;

  auto load = [&](int kb, int stage) {
    const int k0 = kb * S_BK;
#pragma unroll
    for (int i = 0; i < S_BN * S_BK / 16 / S_THREADS; ++i) {
      const int c = tid + i * S_THREADS, r = c >> 3, ch = c & 7;
      const int n = n0 + r, k = k0 + ch * 16;
      const bool ok = n < p.N && k < p.K;
      lxt::cp_async_16(bs + stage * S_BN * S_BK + lxt::swz(r, ch, S_BK), ok ? p.b + (size_t)n * p.K + k : p.b, ok);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int c = tid + i * S_THREADS, r = c >> 3, ch = c & 7;
      const int k = k0 + ch * 16;
      const bool ok = r < p.M && k < p.K;
      lxt::cp_async_16(as + stage * MT * 16 * S_BK + lxt::swz(r, ch, S_BK), ok ? p.a + (size_t)r * p.K + k : p.a, ok);
    }
  };

  int acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < S_STAGES - 1; ++s) {
    if (s < nkb) load(kb0 + s, s);
    lxt::cp_async_commit();
  }
  for (int i = 0; i < nkb; ++i) {
    lxt::cp_async_wait<S_STAGES - 2>();
    __syncthreads();  // stage i landed for every thread; stage i - 1 is free
    if (i + S_STAGES - 1 < nkb) load(kb0 + i + S_STAGES - 1, (i + S_STAGES - 1) % S_STAGES);
    lxt::cp_async_commit();
    const int8_t* bst = bs + (i % S_STAGES) * S_BN * S_BK;
    const int8_t* ast = as + (i % S_STAGES) * MT * 16 * S_BK;
#pragma unroll
    for (int ks = 0; ks < S_BK / 32; ++ks) {
      uint32_t bf[4];  // n-tile 0: bf[0], bf[1]; n-tile 1: bf[2], bf[3]
      lxt::ldmatrix_x4(bf, bst + lxt::swz(16 * warp + (lane >> 4) * 8 + (lane & 7), 2 * ks + ((lane >> 3) & 1), S_BK));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        lxt::ldmatrix_x4(af, ast + lxt::swz(mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7), 2 * ks + (lane >> 4), S_BK));
        lxt::mma_s8_16832(acc[mt][0], af, bf[0], bf[1]);
        lxt::mma_s8_16832(acc[mt][1], af, bf[2], bf[3]);
      }
    }
  }
  lxt::cp_async_wait<0>();

  // element e of acc[mt][nt]: row mt * 16 + g + 8 (e >> 1), column n0 + 16 warp + 8 nt + 2t + (e & 1)
  if (p.splits > 1) {
    int* part = p.part + (size_t)split * p.M * p.N;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = mt * 16 + g + 8 * (e >> 1), n = n0 + 16 * warp + 8 * nt + 2 * t + (e & 1);
          if (m < p.M && n < p.N) part[(size_t)m * p.N + n] = acc[mt][nt][e];
        }
    if (!arrive_last(p.counters + blockIdx.x, p.splits, &flag, tid == 0, 0, S_THREADS)) return;
    // the strip's M x 64 sums spread over the CTA, each thread's split loads all in flight
    for (int idx = tid; idx < p.M * S_BN; idx += S_THREADS) {
      const int m = idx / S_BN, n = n0 + idx % S_BN;
      if (n >= p.N) continue;
      const int* src = p.part + (size_t)m * p.N + n;
      const size_t stride = (size_t)p.M * p.N;
      int sum = 0;
#pragma unroll 8
      for (int s = 0; s < p.splits; ++s) sum += __ldcg(src + s * stride);
      const float v = static_cast<float>(sum) * __ldg(p.rs + m) * __ldg(p.cs + n);
      if (p.out_f32)
        static_cast<float*>(p.out)[(size_t)m * p.N + n] = v;
      else
        static_cast<__nv_bfloat16*>(p.out)[(size_t)m * p.N + n] = __float2bfloat16(v);
    }
    return;
  }
  float r[MT][2];
  float2 c[2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) r[mt][h] = row_scale(p, mt * 16 + g + 8 * h);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) c[nt] = col_scales(p, n0 + 16 * warp + 8 * nt + 2 * t);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epilogue_pair(p, mt * 16 + g + 8 * h, n0 + 16 * warp + 8 * nt + 2 * t, acc[mt][nt][2 * h],
                      acc[mt][nt][2 * h + 1], r[mt][h], c[nt]);
}

// ================= wgmma path (prefill, training, the CE logits) =================

constexpr int W_BM = 128, W_BK = 128, W_THREADS = 384, GROUP_M = 8;

template <int BN>
struct WSmem {  // every tile 1024-aligned (the 128-byte swizzle's period)
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  int8_t a[STAGES][W_BM * W_BK];
  int8_t b[STAGES][BN * W_BK];
  uint64_t full[STAGES], empty[STAGES];
  int flag;
};

// unit u of the persistent walk -> (row tile, column tile, split): splits of one tile
// are neighbours; tiles go in groups of GROUP_M row tiles, each group sweeping the
// column tiles (ops/int8_mm.py:tile_order mirrors this)
__device__ __forceinline__ void unit_coords(int u, int splits, int mtn, int ntn, int& mt, int& nt, int& s) {
  s = u % splits;
  const int tile = u / splits, width = GROUP_M * ntn, first = (tile / width) * GROUP_M;
  const int gsize = min(mtn - first, GROUP_M), r = tile % width;
  mt = first + r % gsize;
  nt = r / gsize;
}

template <int BN>
__global__ void __launch_bounds__(W_THREADS, 1)
    int8_mm_nt_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                            const Args p, int kb_per_split) {
  using Smem = WSmem<BN>;
  constexpr int STAGES = Smem::STAGES;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int mtn = (p.M + W_BM - 1) / W_BM, ntn = (p.N + BN - 1) / BN, kbs = (p.K + W_BK - 1) / W_BK;
  const int units = mtn * ntn * p.splits;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      lxt::mbar_init(&sm.full[s], 1);
      lxt::mbar_init(&sm.empty[s], 8);  // one per consumer warp
    }
    lxt::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer: one thread issues every TMA load ----------------
    lxt::setmaxnreg_dec<40>();
    if (tid != 0) return;
    lxt::tma_prefetch_map(&ta);
    lxt::tma_prefetch_map(&tb);
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int mt, nt, s;
      unit_coords(u, p.splits, mtn, ntn, mt, nt, s);
      const int kb0 = s * kb_per_split, kb1 = min(kb0 + kb_per_split, kbs);
      for (int kb = kb0; kb < kb1; ++kb) {
        lxt::mbar_wait(&sm.empty[stage], phase ^ 1);
        lxt::mbar_arrive_expect_tx(&sm.full[stage], (W_BM + BN) * W_BK);
        lxt::tma_load_2d(sm.a[stage], &ta, &sm.full[stage], kb * W_BK, mt * W_BM);
        lxt::tma_load_2d(sm.b[stage], &tb, &sm.full[stage], kb * W_BK, nt * BN);
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // ---------------- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile ----------------
  lxt::setmaxnreg_inc<232>();
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  int stage = 0;
  uint32_t phase = 0;
  int acc[BN / 2];
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int mt, nt, s;
    unit_coords(u, p.splits, mtn, ntn, mt, nt, s);
    const int kb0 = s * kb_per_split, nkb = min(kb0 + kb_per_split, kbs) - kb0;
    int prev = 0;
    for (int i = 0; i < nkb; ++i) {
      lxt::mbar_wait(&sm.full[stage], phase);
      const int8_t* at = sm.a[stage] + wg * 64 * W_BK;
      lxt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W_BK / 32; ++kk)
        lxt::wgmma_ss_s8<BN>(acc, lxt::desc_sw128(at + 32 * kk, 16, 1024), lxt::desc_sw128(sm.b[stage] + 32 * kk, 16, 1024),
                             i > 0 || kk > 0);
      lxt::wgmma_commit();
      if (i > 0) {  // the previous stage's products are done: hand it back
        lxt::wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) lxt::mbar_arrive(&sm.empty[prev]);
      }
      prev = stage;
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }
    lxt::wgmma_wait<0>();
    lxt::fence_regs(acc);
    __syncwarp();
    if (lane == 0) lxt::mbar_arrive(&sm.empty[prev]);

    // d[4i + e]: row m0 + 8 (e >> 1), column n0 + 8i + 2c + (e & 1)
    const int m0 = mt * W_BM + wg * 64 + warp * 16 + g, n0 = nt * BN + 2 * c;
    if (p.splits > 1) {
      int* part = p.part + (size_t)s * p.M * p.N;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + 8 * (e >> 1), n = n0 + 8 * i + (e & 1);
          if (m < p.M && n < p.N) part[(size_t)m * p.N + n] = acc[4 * i + e];
        }
      if (!arrive_last(p.counters + u / p.splits, p.splits, &sm.flag, threadIdx.x == 0, 1, 256)) continue;
      for (int o = 0; o < p.splits; ++o) {  // a split at a time, its BN / 2 loads all in flight
        if (o == s) continue;
        const int* src = p.part + (size_t)o * p.M * p.N;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = m0 + 8 * (e >> 1), n = n0 + 8 * i + (e & 1);
            if (m < p.M && n < p.N) acc[4 * i + e] += __ldcg(src + (size_t)m * p.N + n);
          }
      }
    }
    const float r[2] = {row_scale(p, m0), row_scale(p, m0 + 8)};
#pragma unroll
    for (int i0 = 0; i0 < BN / 8; i0 += 8) {  // eight column pairs' scales in registers, then their stores
      float2 c[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) c[j] = col_scales(p, n0 + 8 * (i0 + j));
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          epilogue_pair(p, m0 + 8 * h, n0 + 8 * (i0 + j), acc[4 * (i0 + j) + 2 * h], acc[4 * (i0 + j) + 2 * h + 1], r[h],
                        c[j]);
    }
  }
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int BN>
int launch_wgmma(const Args& p, int kb_per_split, cudaStream_t st) {
  CUtensorMap ta, tb;
  if (!lxt::make_u8_2d_map(&ta, p.a, p.M, p.K, W_BM) || !lxt::make_u8_2d_map(&tb, p.b, p.N, p.K, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = sizeof(WSmem<BN>) + 1024;
  static const cudaError_t attr =  // once per instantiation and process (one card a process)
      cudaFuncSetAttribute(int8_mm_nt_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int units = ((p.M + W_BM - 1) / W_BM) * ((p.N + BN - 1) / BN) * p.splits;
  int8_mm_nt_wgmma_kernel<BN><<<min(units, sm_count()), W_THREADS, bytes, st>>>(ta, tb, p, kb_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_stream(const Args& p, int kb_per_split, cudaStream_t st) {
  constexpr int bytes = stream_smem<MT>();
  static const cudaError_t attr =
      cudaFuncSetAttribute(int8_mm_nt_stream_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((p.N + S_BN - 1) / S_BN, p.splits);
  int8_mm_nt_stream_kernel<MT><<<grid, S_THREADS, bytes, st>>>(p, kb_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// path, bn and splits: ops/int8_mm.py:int8_mm_plan. part: int32 [splits, M, N] when
// splits > 1; counters: int32 zeros, one per output tile (wgmma) or strip (stream).
extern "C" int lxt_int8_mm_dequant_nt(const void* a, const void* b, const void* row_scale, const void* col_scale,
                                      void* out, int M, int N, int K, int out_f32, int path, int bn, int splits,
                                      void* part, void* counters, void* stream) {
  Args p{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<const float*>(row_scale),
         static_cast<const float*>(col_scale), out, static_cast<int*>(part), static_cast<int*>(counters),
         M, N, K, out_f32, splits};
  auto st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || (splits > 1 && (!part || !counters))) return static_cast<int>(cudaErrorInvalidValue);
  const int bk = path == PATH_WGMMA ? W_BK : S_BK;
  const int kbs = (K + bk - 1) / bk, per = (kbs + splits - 1) / splits;
  if ((kbs + per - 1) / per != splits) return static_cast<int>(cudaErrorInvalidValue);  // an empty split
  if (path == PATH_WGMMA) {
    if (bn == 256) return launch_wgmma<256>(p, per, st);
    if (bn == 128) return launch_wgmma<128>(p, per, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (path != PATH_STREAM || bn != S_BN) return static_cast<int>(cudaErrorInvalidValue);
  switch ((M + 15) / 16) {
    case 1: return launch_stream<1>(p, per, st);
    case 2: return launch_stream<2>(p, per, st);
    case 3: return launch_stream<3>(p, per, st);
    case 4: return launch_stream<4>(p, per, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
