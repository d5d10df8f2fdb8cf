// K6: the flash probe, a matmul-only attention: out = sum over the needed (i, j) blocks
// of bf16(Q_i K_j^T) V_j with an f32 accumulator. No softmax, no scale on q, no mask
// inside a block: only the whole-block skip of the causal / prefix-LM plan (bq, bk),
//   need(i, j) = (i*bq + bq - 1 >= j*bk) | ((i*bq < prefix) & (j*bk < prefix)).
//
// Replaces the Pallas TPU kernel tools/probe_flash.py:probe_kernel (pallas_call at :125),
// which bounds what the two products of the flash forward cost without its softmax
// chain. It runs K2's main loop (csrc/flash_attention.cu) with the softmax taken out, so
// that the gap between K2 and this kernel is what K2's online softmax, masking and
// rescaling cost on this card (llama_x_tpu_torch/probe_flash.py: fwd - probe).
//
// What bounds it on an H100: the bf16 tensor-core rate, 4*B*Hq*D operations for every
// (q, kv) pair of a needed block at 989 TFLOP/s (0.1911 ms at B 1, S 4096, 32/8 heads,
// D 128, prefix 2000, bq 256, bk 1024: 0.6875 of the pairs), against q, k, v, out once
// (84 MB, 0.025 ms at 3.35 TB/s).
//
// Design (Hopper): K2's CTA without its softmax. One CTA of three warpgroups per (128
// query rows, q head, batch row), q tiles longest first; warpgroup 2 is the producer (one
// thread issues the TMA loads; setmaxnreg 24, consumers 240), warpgroups 0 and 1 each own
// 64 query rows. Q arrives once by TMA and is read by wgmma as it lies (the probe does not
// scale q, so there is no fold pass). K and V tiles of 128 positions stream through a
// two-stage ring (4-D tensor maps over [B, S, Hkv, D] as they lie, 128-byte swizzle;
// full / empty mbarriers). S = Q K^T is wgmma m64n128k16 with both operands K-major in
// shared memory; S leaves the accumulator rounded to bf16 as the register A operand of
// O += P V, with V the MN-major B operand read in place; no running max, rescale, l or
// lse. Tile classes come from the probe's plan, not from an attention mask
// (ops/flash_probe.py:probe_tile_class, mirrored by tile_class below): the producer never
// loads a tile of which no block is needed, and hands each loaded tile's class for each
// consumer warpgroup's 64 rows through the ring; a "full" tile runs with no mask code, a
// "partial" one (only where bq or bk is not a multiple of 128) zeroes S per element of
// the blocks that are not needed. One CTA per q head: the K/V tiles of a GQA group are
// read by its four CTAs and meet in L2.
//
// The design before this one (K2's earlier loop: one CTA of 4 warps per 64 query rows,
// mma.sync m16n8k16 from padded shared tiles, V fragments packed from 2-byte loads, no
// asynchronous copies) took, in chip_smoke.py on NVIDIA H100 80GB HBM3, 700.00 W, at
// B 1, S 4096, 32/8 heads, D 128, prefix 2000: 1.0063 and 1.0182 ms in two runs at
// bq 256 / bk 1024, 0.9651 and 0.9733 ms at bq 128 / bk 512, while K2 took 0.3910 ms there.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 128, BK = 128, STAGES = 2, THREADS = 384;
constexpr int TILE_SKIP = 0, TILE_PARTIAL = 1, TILE_FULL = 2;

struct Params {
  __nv_bfloat16* out;
  int B, S, Hq, Hkv, bq, bk, prefix;
};

__device__ __forceinline__ bool need(const Params& p, int i, int j) {
  return i * p.bq + p.bq - 1 >= j * p.bk || (i * p.bq < p.prefix && j * p.bk < p.prefix);
}

// the class of the tile [q0, q0 + nq) x [kv0, kv0 + nk) under the plan: skip when no block
// it touches below S is needed, full when all are (ops/flash_probe.py:probe_tile_class)
__device__ __forceinline__ int tile_class(const Params& p, int q0, int nq, int kv0, int nk) {
  if (q0 >= p.S || kv0 >= p.S) return TILE_SKIP;
  const int i1 = (min(q0 + nq, p.S) - 1) / p.bq, j1 = (min(kv0 + nk, p.S) - 1) / p.bk;
  bool any = false, all = true;
  for (int i = q0 / p.bq; i <= i1; ++i)
    for (int j = kv0 / p.bk; j <= j1; ++j) {
      const bool n = need(p, i, j);
      any |= n;
      all &= n;
    }
  return !any ? TILE_SKIP : all ? TILE_FULL : TILE_PARTIAL;
}

template <int D>
struct Smem {  // every tile 1024-aligned (the 128-byte swizzle's period)
  __nv_bfloat16 q[BQ * D];
  __nv_bfloat16 k[STAGES][BK * D];
  __nv_bfloat16 v[STAGES][BK * D];
  int info[STAGES][3];  // the tile's kv0 (-1: no more tiles) and its class for each consumer warpgroup
  uint64_t q_full, full[STAGES], empty[STAGES];
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_probe_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int S = p.S;
  const int n_q = (S + BQ - 1) / BQ, n_kv = (S + BK - 1) / BK;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (n_q - 1 - (int)blockIdx.z) * BQ;  // the q tiles that see the most kv tiles first
  const int hk = h / (p.Hq / p.Hkv);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    lxt::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      lxt::mbar_init(&sm.full[s], 1);
      lxt::mbar_init(&sm.empty[s], 8);  // one per consumer warp
    }
    lxt::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer: one thread sorts the tiles and issues every load ----------------
    lxt::setmaxnreg_dec<24>();
    if (tid != 0) return;
    lxt::tma_prefetch_map(&tk);
    lxt::tma_prefetch_map(&tv);
    lxt::mbar_arrive_expect_tx(&sm.q_full, BQ * D * 2);
    lxt::tma_load_tile<D, BQ>(sm.q, &tq, &sm.q_full, h, q0, b);
    int stage = 0;
    uint32_t phase = 0;
    for (int j = n_kv - 1; j >= -1; --j) {  // last to first; a kv0 of -1 ends the consumers' loop
      const int kv0 = j * BK;
      if (j >= 0 && tile_class(p, q0, BQ, kv0, BK) == TILE_SKIP) continue;
      lxt::mbar_wait(&sm.empty[stage], phase ^ 1);
      sm.info[stage][0] = j >= 0 ? kv0 : -1;
      if (j >= 0) {
        sm.info[stage][1] = tile_class(p, q0, 64, kv0, BK);
        sm.info[stage][2] = tile_class(p, q0 + 64, 64, kv0, BK);
        lxt::mbar_arrive_expect_tx(&sm.full[stage], 2 * BK * D * 2);  // releases the info written above
        lxt::tma_load_tile<D, BK>(sm.k[stage], &tk, &sm.full[stage], hk, kv0, b);
        lxt::tma_load_tile<D, BK>(sm.v[stage], &tv, &sm.full[stage], hk, kv0, b);
      } else {
        lxt::mbar_arrive(&sm.full[stage]);
      }
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }
    return;
  }

  // ---------------- consumers: warpgroup wg owns CTA rows [64 wg, 64 wg + 64) ----------------
  lxt::setmaxnreg_inc<240>();
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int wq0 = q0 + wg * 64;
  const int qblock = wq0 / p.bq;  // bq is a multiple of 64: the warpgroup's rows lie in one q block

  lxt::mbar_wait(&sm.q_full, 0);
  const __nv_bfloat16* qa = sm.q + wg * 64 * 64;  // this warpgroup's A rows

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    lxt::mbar_wait(&sm.full[stage], phase);
    const int kv0 = sm.info[stage][0];
    if (kv0 < 0) break;
    const int cls = sm.info[stage][1 + wg];  // the class of this warpgroup's 64 rows
    if (cls != TILE_SKIP) {
      // S = Q K^T: 64 rows x 128 kv positions
      float s[BK / 2];
      lxt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        lxt::wgmma_ss<BK>(s, lxt::desc_k_major<BQ>(qa, kk * 16), lxt::desc_k_major<BK>(sm.k[stage], kk * 16), kk > 0);
      lxt::wgmma_commit();
      lxt::wgmma_wait<0>();
      lxt::fence_regs(s);

      if (cls == TILE_PARTIAL) {  // column 8i + 2c + (e & 1) of the tile
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!need(p, qblock, (kv0 + i * 8 + c * 2 + (e & 1)) / p.bk)) s[4 * i + e] = 0.f;
      }

      // O += bf16(S) V: S rounded to bf16 as the register A operand, V MN-major from the ring
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) lxt::acc_to_a(pa[kk], s, kk);
      lxt::fence_regs(pa);
      lxt::fence_regs(o);
      lxt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) lxt::wgmma_rs<D>(o, pa[kk], lxt::desc_mn_major<BK>(sm.v[stage], kk * 16), 1);
      lxt::wgmma_commit();
      lxt::wgmma_wait<0>();
      lxt::fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) lxt::mbar_arrive(&sm.empty[stage]);
    if (++stage == STAGES) stage = 0, phase ^= 1;
  }

  // o[4n + 2r + 0..1]: row wq0 + 16 warp + g + 8r, columns 8n + 2c + 0..1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + warp * 16 + g + r * 8;
    if (row >= S) continue;
    __nv_bfloat16* dst = p.out + ((size_t)b * S + row) * ((size_t)p.Hq * D) + (size_t)h * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + c * 2) = __floats2bfloat162_rn(o[4 * n + 2 * r], o[4 * n + 2 * r + 1]);
  }
}

template <int D>
int launch(const Params& p, const void* q, const void* k, const void* v, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!lxt::make_bshd_map(&tq, q, p.B, p.S, p.Hq, D, BQ) || !lxt::make_bshd_map(&tk, k, p.B, p.S, p.Hkv, D, BK) ||
      !lxt::make_bshd_map(&tv, v, p.B, p.S, p.Hkv, D, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = sizeof(Smem<D>) + 1024;  // + the alignment of the dynamic base
  static const cudaError_t attr =  // once per instantiation and process (one card a process)
      cudaFuncSetAttribute(flash_probe_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(p.Hq, p.B, (p.S + BQ - 1) / BQ);
  flash_probe_kernel<D><<<grid, THREADS, bytes, st>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out [B, S, Hq, D]; k, v [B, S, Hkv, D], bf16; bq and bk multiples of 64 that divide S
// (checked by the wrapper too).
extern "C" int lxt_flash_probe(const void* q, const void* k, const void* v, void* out, int B, int S, int Hq, int Hkv,
                               int D, int bq, int bk, int prefix, void* stream) {
  if (bq <= 0 || bk <= 0 || bq % 64 || bk % 64 || S % bq || S % bk) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<__nv_bfloat16*>(out), B, S, Hq, Hkv, bq, bk, prefix};
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(p, q, k, v, st);
  if (D == 64) return launch<64>(p, q, k, v, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
