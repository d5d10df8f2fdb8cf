// K4: int8 x int8 GEMM with the right operand in [K, N] layout and a fused
// row-scale x col-scale dequant epilogue:
//   C[m, n] = float(sum_k a[m, k] * b[k, n]) * row_scale[m] * col_scale[n]   (bf16 or f32 out)
//
// Replaces the Pallas TPU kernel llama_x_tpu/ops/int8_mm.py:_kernel as reached
// through int8_mm_dequant_pallas (b in KN layout): the input gradient through every
// frozen int8 projection when LlamaConfig.dynamic_int8_bwd is set
// (llama_x_tpu/ops/int8.py:171-185: a = q(g * w_scale) [tokens, out], b = the stored
// int_data [out, in], col_scale = ones), and the fused cross-entropy head's dH
// (llama_x_tpu/ops/cross_entropy.py:81-94, f32 out, K = the vocabulary). The frozen base
// keeps ONE layout for the forward (K1 reads it as [N, K]) and the backward (this kernel
// reads the same bytes as [K, N]); no transposed copy of the 7 GB base exists.
//
// What bounds it on an H100: at the training shapes (M = 4096 tokens) the int8
// tensor-core rate, 2*M*N*K operations at 1979 TOP/s (0.2431 ms at M 4096, N 4096,
// K 14336); the bytes (a and b once, C once) are a few tens of MB.
//
// The difficulty: integer wgmma reads a shared-memory operand only K-major (the transpose
// bit exists for 16-bit types), and b is N-major. So each output tile is computed
// transposed, out^T[n, m] = sum_k b^T[n, k] a[m, k]: b^T is wgmma's A operand, which may
// come from registers, and a's box is its B operand, K-major as it lies.
//
// Design (Hopper): a persistent, warp-specialized kernel, one CTA per SM walking output
// tiles of BM (m) x 128 (n) in grouped order (GROUP_M m tiles share a sweep of the n
// tiles, so the strips of b are read from L2), K split where the tiles fill fewer than
// half of the SMs; ops/int8_mm.py:int8_mm_kn_plan picks BM (256, or 128 where 256 leaves
// SMs idle) and the splits, and is the one place K4's thresholds live. One producer
// warp issues TMA loads of 128-byte-deep K blocks: a's [BM m][128 k] box through a 2-D
// tensor map over [M, K] (as K1 loads it) and b's [128 k][128 n] box through one over
// [K, N] (N % 16 keeps its stride legal), both in the 128-byte swizzle, boxes past any
// edge zero-filled, so ragged M, N and K need no mask in the loop (a last m tile reads the
// BM rows that end at M instead: box_row, below); a ring of 4 (BM 256)
// or 6 (BM 128) stages with full / empty mbarriers. Two consumer warpgroups (setmaxnreg
// 232, producer 40) each own 64 n of the tile. Per 32-deep k step a warp builds its
// 16 x 32 slice of b^T in registers with one ldmatrix.x4.trans and four byte permutes
// (hopper.cuh: kn_fragment; the rows it hands ldmatrix put every matrix's 8 rows in 8
// swizzle phases, so the reads are free of bank conflicts) and issues wgmma
// m64nBMk32 s32.s8.s8 with A from those registers and B = a's box. Shared-memory traffic
// per stage at BM 256: 16 KB of b into registers and 2 x 32 KB of a read by the products,
// about 80 B a cycle against the stage's ~1000 cycles of products: K1's own figure.
// Registers that feed an in-flight wgmma must not be rewritten, and ptxas allots a thread
// of a 384-thread CTA 168 of them, 128 of which hold the accumulator. So a warpgroup
// builds one stage's 16 fragment registers, issues the stage's four products, waits for
// them and hands the stage back; while it waits and builds the next, the other
// warpgroup's products keep the tensor cores busy. Double-buffering the fragments across
// stages measured no faster at the 256-m tile (ptxas kept the second set in local
// memory), and a wait after every k step made ptxas serialize the products (C7513).
// Fragment row 16w + g is column 2g of the warp's 16, row 16w + g + 8 column 2g + 1, so
// each thread's accumulator holds, per 8 m, a 2 x 2 block (m, m + 1) x (n, n + 1): the
// epilogue stores n pairs (4 bytes bf16, 8 bytes f32), eight lanes filling one 32-byte
// sector of a row of out. The row and column scales are loaded before the stores
// (a load after a store to out would wait for it).
// Split-K: every split writes its exact int32 partial to a scratch [splits, M, N]; the
// last split of a tile to arrive (an int32 counter per tile, reset by that split) adds the
// others' partials and runs the epilogue. int32 sums are exact, so the result is bit for
// bit the plain version's in any order, in one launch. The counters start at zero (the
// wrapper's cached tensor) and are left at zero.
//
// Sums are exact int32: 127^2 * K must stay below 2^31, i.e. K <= 133144; the
// vocabulary contraction of the Llama-3 head (K = 128256: 2,068,641,024) fits with 4%
// to spare and the wrapper raises beyond. K and N must be multiples of 16.
//
// The design before this one (one CTA of 8 warps per 128 x 128 tile, a two-stage
// cp.async ring, mma.sync m16n8k32 with each B fragment transposed from four 32-bit shared
// loads by eight byte permutes) took, in chip_smoke.py on NVIDIA H100 80GB HBM3, 700.00 W:
// 1.1577 ms at M 4096, N 4096, K 14336; 1.3233 ms at M 4096, N 14336, K 4096; 0.3407 ms
// at M 4096, N 4096, K 4096; 0.1084 ms at M 4096, N 4096, K 1024; 1.2553 ms for the CE
// dH (M 512, N 4096, K 128256, f32 out).

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BN = 128, BK = 128, THREADS = 384, GROUP_M = 8;

struct Args {
  const float* rs;
  const float* cs;
  void* out;
  int* part;      // [splits, M, N] int32 partials (splits > 1)
  int* counters;  // one per output tile, zero between launches
  int M, N, K, out_f32, splits;
};

template <int BM>
struct Smem {  // every box 1024-aligned (the 128-byte swizzle's period)
  static constexpr int STAGES = BM == 256 ? 4 : 6;
  int8_t a[STAGES][BM * BK];  // [m][k]: wgmma's B operand, K-major
  int8_t b[STAGES][BK * BN];  // [k][n] as it lies: the source of the register A operand
  uint64_t full[STAGES], empty[STAGES];
  int flag;
};

// unit u of the persistent walk -> (m tile, n tile, split): splits of one tile are
// neighbours; m tiles go in groups of GROUP_M, each group sweeping the n tiles
// (ops/int8_mm.py:tile_order mirrors this)
__device__ __forceinline__ void unit_coords(int u, int splits, int mtn, int ntn, int& mt, int& nt, int& s) {
  s = u % splits;
  const int tile = u / splits, width = GROUP_M * ntn, first = (tile / width) * GROUP_M;
  const int gsize = min(mtn - first, GROUP_M), r = tile % width;
  mt = first + r % gsize;
  nt = r / gsize;
}

// The first row of m tile mt's a box: the tile's own, except that a last tile reaching past
// M reads the BM rows that end at M (when M >= BM), so that no box lies mostly past the
// tensor's edge; its rows below mt * BM belong to the tile before and are not stored.
template <int BM>
__device__ __forceinline__ int box_row(int mt, int M) {
  const int m0 = mt * BM;
  return m0 + BM > M && M >= BM ? M - BM : m0;
}

// Split-K arrival (as in K1): after this thread's partials are written, the 256 consumer
// threads sync; one counts the arrival and the return value says whether this split came
// last (it then resets the counter).
__device__ __forceinline__ bool arrive_last(int* counter, int splits, int* flag, bool leader) {
  __threadfence();
  lxt::named_sync(1, 256);
  if (leader) {
    const int old = atomicAdd(counter, 1);
    const int last = old == splits - 1;
    if (last) *counter = 0;
    *flag = last;
  }
  lxt::named_sync(1, 256);
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

__device__ __forceinline__ void store_pair(const Args& p, int m, int n, float v0, float v1) {
  const size_t off = (size_t)m * p.N + n;
  if (p.out_f32)
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) = make_float2(v0, v1);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + off) = __floats2bfloat162_rn(v0, v1);
}

template <int BM>
__global__ void __launch_bounds__(THREADS, 1)
    int8_mm_kn_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, const Args p,
                      int kb_per_split) {
  using Sm = Smem<BM>;
  constexpr int STAGES = Sm::STAGES;
  extern __shared__ unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int mtn = (p.M + BM - 1) / BM, ntn = (p.N + BN - 1) / BN, kbs = (p.K + BK - 1) / BK;
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
        lxt::mbar_arrive_expect_tx(&sm.full[stage], (BM + BN) * BK);
        lxt::tma_load_2d(sm.a[stage], &ta, &sm.full[stage], kb * BK, box_row<BM>(mt, p.M));
        lxt::tma_load_2d(sm.b[stage], &tb, &sm.full[stage], nt * BN, kb * BK);
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // ---------------- consumers: warpgroup wg owns n [64 wg, 64 wg + 64) of each tile ----------------
  lxt::setmaxnreg_inc<232>();
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int row_off = lxt::kn_row_offset(lane, 4 * wg + warp);  // this lane's ldmatrix row in a b box
  uint32_t sel0, sel1;
  lxt::kn_selectors(lane, sel0, sel1);
  int stage = 0;
  uint32_t phase = 0;
  int acc[BM / 2];
  uint32_t frag[BK / 32][4];  // one stage's b^T fragments
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int mt, nt, s;
    unit_coords(u, p.splits, mtn, ntn, mt, nt, s);
    const int kb0 = s * kb_per_split, nkb = min(kb0 + kb_per_split, kbs) - kb0;
    for (int i = 0; i < nkb; ++i) {
      lxt::mbar_wait(&sm.full[stage], phase);
      const int8_t* brow = sm.b[stage] + row_off;
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) lxt::kn_fragment(frag[kk], brow, kk, sel0, sel1);
      lxt::fence_regs(frag);
      lxt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        lxt::wgmma_rs_s8<BM>(acc, frag[kk], lxt::desc_sw128(sm.a[stage] + 32 * kk, 16, 1024), i > 0 || kk > 0);
      lxt::wgmma_commit();
      lxt::wgmma_wait<0>();  // the other warpgroup's products keep the tensor cores busy meanwhile
      lxt::fence_regs(frag);
      __syncwarp();
      if (lane == 0) lxt::mbar_arrive(&sm.empty[stage]);
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }
    lxt::fence_regs(acc);

    // acc[4i + e]: n = n_t + (e >> 1), m = m_t + 8i + (e & 1)
    const int n_t = nt * BN + 64 * wg + 16 * warp + 2 * g, m_t = box_row<BM>(mt, p.M) + 2 * c, m_lo = mt * BM;
    const bool n_in = n_t < p.N;  // N % 16 == 0: n_t + 1 is inside too
    if (p.splits > 1) {
      int* part = p.part + (size_t)s * p.M * p.N;
#pragma unroll
      for (int i = 0; i < BM / 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = m_t + 8 * i + j;
          if (n_in && m >= m_lo && m < p.M)
            *reinterpret_cast<int2*>(part + (size_t)m * p.N + n_t) = make_int2(acc[4 * i + j], acc[4 * i + 2 + j]);
        }
      if (!arrive_last(p.counters + u / p.splits, p.splits, &sm.flag, threadIdx.x == 0)) continue;
      for (int o = 0; o < p.splits; ++o) {  // a split at a time, its BM / 4 loads all in flight
        if (o == s) continue;
        const int* src = p.part + (size_t)o * p.M * p.N;
#pragma unroll
        for (int i = 0; i < BM / 8; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int m = m_t + 8 * i + j;
            if (n_in && m >= m_lo && m < p.M) {
              const int2 v = __ldcg(reinterpret_cast<const int2*>(src + (size_t)m * p.N + n_t));
              acc[4 * i + j] += v.x;
              acc[4 * i + 2 + j] += v.y;
            }
          }
      }
    }
    if (!n_in) continue;
    const float2 cs = make_float2(__ldg(p.cs + n_t), __ldg(p.cs + n_t + 1));
#pragma unroll
    for (int i0 = 0; i0 < BM / 8; i0 += 8) {  // sixteen rows' scales in registers, then their stores
      float r[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = m_t + 8 * (i0 + i) + j;
          r[i][j] = m >= m_lo && m < p.M ? __ldg(p.rs + m) : 0.f;
        }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = m_t + 8 * (i0 + i) + j;
          if (m >= m_lo && m < p.M)  // float(acc) * row scale * column scale, in that order (the plain version's)
            store_pair(p, m, n_t, static_cast<float>(acc[4 * (i0 + i) + j]) * r[i][j] * cs.x,
                       static_cast<float>(acc[4 * (i0 + i) + 2 + j]) * r[i][j] * cs.y);
        }
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

template <int BM>
int launch(const int8_t* a, const int8_t* b, const Args& p, int kb_per_split, cudaStream_t st) {
  CUtensorMap ta, tb;
  if (!lxt::make_u8_2d_map(&ta, a, p.M, p.K, BM) || !lxt::make_u8_2d_map(&tb, b, p.K, p.N, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = sizeof(Smem<BM>) + 1024;
  static const cudaError_t attr =  // once per instantiation and process (one card a process)
      cudaFuncSetAttribute(int8_mm_kn_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int units = ((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN) * p.splits;
  int8_mm_kn_kernel<BM><<<min(units, sm_count()), THREADS, bytes, st>>>(ta, tb, p, kb_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bm and splits: ops/int8_mm.py:int8_mm_kn_plan. part: int32 [splits, M, N] when
// splits > 1; counters: int32 zeros, one per output tile.
extern "C" int lxt_int8_mm_dequant_kn(const void* a, const void* b, const void* row_scale, const void* col_scale,
                                      void* out, int M, int N, int K, int out_f32, int bm, int splits, void* part,
                                      void* counters, void* stream) {
  Args p{static_cast<const float*>(row_scale), static_cast<const float*>(col_scale), out, static_cast<int*>(part),
         static_cast<int*>(counters), M, N, K, out_f32, splits};
  auto st = static_cast<cudaStream_t>(stream);
  if (N % 16 || K % 16 || splits < 1 || (splits > 1 && (!part || !counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kbs = (K + BK - 1) / BK, per = (kbs + splits - 1) / splits;
  if ((kbs + per - 1) / per != splits) return static_cast<int>(cudaErrorInvalidValue);  // an empty split
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* b8 = static_cast<const int8_t*>(b);
  if (bm == 256) return launch<256>(a8, b8, p, per, st);
  if (bm == 128) return launch<128>(a8, b8, p, per, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
