// K5: flash attention backward: dq, dk, dv from q, k, v, the forward's out and
// natural-log lse, and dO, bf16 in and out, f32 accumulation, with the
// MaskInfo mask rebuilt in the kernel exactly as K2 builds it:
// (causal & same segment) | in-prefix.
//
// Replaces the Pallas TPU kernel llama_x_tpu/ops/flash_attention.py:_bwd_dkv_kernel
// (pallas_call in _bwd, through the custom_vjp of flash_attention and
// flash_bwd_from_res). It computes what _bwd computes, with the same rounding points: q
// folded with scale*log2e by one f32 multiply and one rounding to bf16 (so the
// recomputed s meets the stored lse: p = exp2(s - lse*log2e)), masked logits -1e30, p
// rounded to bf16 before the dV product, ds = p * (dp - delta) * ln2 rounded to bf16
// before the dk and dq products, dk = ds^T (q*scale*log2e), dq = (ds k) * scale*log2e
// applied once at the end, dk and dv summed over the GQA group inside the kernel. With
// dropout the forward's keep mask is rebuilt from the same hash (common.cuh), keyed on
// the JAX plan's blocks (bq, bk) and indexed by (q position, kv position), never by a
// tile's own row and column: dV += bf16(p * keep)^T dO, dp = (dO V^T) * keep,
// ds = p (dp - delta) ln2 with the undropped p, delta unchanged. A kv tile (64 or 128
// positions) lies inside one kv block of the plan (bk is a multiple of 128, or spans the
// sequence); the q block may change inside a q tile (bq 32), so the dkv kernel keeps
// fmix32(key) and r * bk per q column in its ring.
//
// The offsets form (ACC; the TPU kernel's _bwd(offsets=, delta=, cast=False) as ring
// attention's backward calls it, llama_x_tpu/ops/ring_attention.py:_make_ring_flash):
// the local q shard at global positions q_offset + i, the rotated kv block at
// kv_offset + j, with K2's ring-form mask (common.cuh: Mask). out and lse are the ring's
// final merged ones, so p = exp2(s - lse*log2e) is this block's exact share of the
// softmax; delta = rowsum(dO * out) [B, Hq, S] f32 comes from the caller, computed once
// per ring backward, and the dq kernel reads it instead of summing its own. dq, dk and dv
// are f32 and ADDED into the caller's accumulators (each element has one writer, so the
// sum stays deterministic): dq sums over the ring's kv blocks at home, dk and dv travel
// the ring with their kv block. No dropout (ring attention refuses it).
//
// What bounds it on an H100: the bf16 tensor-core rate; the five products that the
// algorithm needs are 10*B*Hq*(visible pairs)*D operations, 0.348 ms at B 1, S 4096,
// 32/8 heads, D 128, causal at 989 TFLOP/s, against 134 MB of q, k, v, out, dO, dq, dk,
// dv (0.040 ms at 3.35 TB/s); with 8 packed documents the bytes bound (0.050 ms).
//
// Design (Hopper). Two kernels, both deterministic (no atomics: two runs give the same
// bits), each a CTA of three warpgroups: two consumer warpgroups of 64 rows each on
// wgmma (setmaxnreg 240) and a producer warpgroup (24 registers) of which one warp
// fills a three-stage ring with TMA (4-D tensor maps over the [B, S, H, D] tensors as they
// lie, 128-byte swizzle, rows past S zero-filled) and the per-row scalars with plain
// loads, behind full / empty mbarriers. They share K2's pieces: the tile classes of
// common.cuh, decided by the producer alone and handed to the consumers in the ring
// (all-masked tiles are never loaded or computed, all-visible ones run with no mask
// code, partial ones mask per element from shared-memory segment ids), the longest-first
// schedule, and the q fold.
//   dq:  runs first. One CTA per (128 q rows, q head, batch row): Q and dO arrive once,
//        delta = rowsum(dO * O) of its rows is summed in f32 from global memory (a quad
//        of lanes a row) and written for the dkv kernel;
//        each warpgroup folds its 64 rows of Q in shared memory (read, multiply by
//        scale*log2e, round to bf16, write, fence.proxy.async) and stores them back to a
//        scratch tensor by TMA, so the dkv kernel reads Qs and never folds again. K and
//        V tiles of 64 positions stream through the ring: S = Qs K^T and dP = dO V^T are
//        wgmma m64n64k16 with both operands K-major, dS leaves its accumulator rounded to
//        bf16 as the register A operand of dQ += dS K, K read MN-major in place; dq is
//        scaled once at the end. q tiles longest first (blockIdx.z reversed).
//   dkv: one CTA per (128 kv positions, kv head, batch row): K and V arrive once; for
//        every q head of the GQA group, Qs and dO tiles of 64 rows stream through the
//        ring with their lse*log2e, delta, segment ids and dropout keys per q column.
//        Each warpgroup works on the TRANSPOSED logits of its 64 kv rows:
//        S^T = K Qs^T and dP^T = V dO^T (both operands K-major), then P^T and dS^T leave
//        the accumulators as register A operands of dV += P^T dO and dK += dS^T Qs, dO
//        and Qs read MN-major. dk and dv stay in registers over the whole group (128
//        f32 a thread at D 128) and are written once. kv tiles in ascending order, so
//        the ones with the most q tiles (the first, under a causal mask) start first.
// The price of two kernels is that S, P and dP are computed twice: 7 products where 5
// are needed, for bit-reproducible gradients and no extra memory beyond the Qs scratch.
//
// The design before this one (mma.sync m16n8k16, the three products along the
// sequence axis fed from 2-byte shared loads, no asynchronous copies, masked segment
// tiles computed) took, in chip_smoke.py on NVIDIA H100 80GB HBM3, 700.00 W: 4.5321 ms at
// B 1, S 4096, 32/8 heads, D 128, causal; 4.5952 ms with 8 packed documents; 5.5423 ms
// at prefix-LM 2000 (6.5340 ms with dropout 0.1).

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int WG_ROWS = 64;      // rows of a consumer warpgroup
constexpr int CTA_ROWS = 128;    // q rows of a dq CTA, kv rows of a dkv CTA
constexpr int STREAM_ROWS = 64;  // rows of a streamed tile: kv in the dq kernel, q in the dkv kernel
constexpr int STAGES = 3, THREADS = 384;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const __nv_bfloat16 *o, *dout;    // the forward's out and its gradient, [B, S, Hq, D]
  const float* lse;                 // [B, Hq, S]
  float* delta;                     // [B, Hq, S]: written by the dq kernel and read by the dkv kernel (ACC: given)
  const int *qseg, *kseg, *prefix;  // null when absent
  const int *qrange, *krange;       // [B, ceil(S / SEG_CHUNK), 2] segment id ranges; null without segments
  void *dq, *dk, *dv;               // bf16, written; ACC: f32 accumulators, added into
  int B, S, Hq, Hkv, causal;
  int q_offset, kv_offset;          // ACC: the global starts of the q shard and the kv block
  float qscale;  // scale * log2(e)
  lxt::Dropout drop;
};

// ---------------------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------------------

template <int D>
struct DqSmem {
  __nv_bfloat16 q[CTA_ROWS * D];
  __nv_bfloat16 dout[CTA_ROWS * D];
  __nv_bfloat16 k[STAGES][STREAM_ROWS * D];
  __nv_bfloat16 v[STAGES][STREAM_ROWS * D];
  int kseg[STAGES][STREAM_ROWS];
  int info[STAGES][3];  // the tile's kv0 (-1: no more tiles) and its class for each consumer warpgroup
  uint64_t qd_full, full[STAGES], empty[STAGES];
};

template <int D, bool DROP, bool ACC>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tqs, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int S = p.S;
  const int n_q = (S + CTA_ROWS - 1) / CTA_ROWS, n_kv = (S + STREAM_ROWS - 1) / STREAM_ROWS;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (n_q - 1 - (int)blockIdx.z) * CTA_ROWS;
  const int hk = h / (p.Hq / p.Hkv);
  const lxt::Mask mask = lxt::batch_mask(S, p.causal, p.prefix, p.qrange, p.krange, b, p.q_offset, p.kv_offset);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    lxt::mbar_init(&sm.qd_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      lxt::mbar_init(&sm.full[s], 33);
      lxt::mbar_init(&sm.empty[s], 8);
    }
    lxt::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    lxt::setmaxnreg_dec<24>();
    if (tid >= 32) return;
    const int lane = tid;
    if (lane == 0) {
      lxt::tma_prefetch_map(&tk);
      lxt::tma_prefetch_map(&tv);
      lxt::mbar_arrive_expect_tx(&sm.qd_full, 2 * CTA_ROWS * D * 2);
      lxt::tma_load_tile<D, CTA_ROWS>(sm.q, &tq, &sm.qd_full, h, q0, b);
      lxt::tma_load_tile<D, CTA_ROWS>(sm.dout, &tdo, &sm.qd_full, h, q0, b);
    }
    // the producer alone sorts the tiles and hands each loaded tile's classes to the
    // consumers in the ring; a kv0 of -1 ends their loop
    const int2 qr = lxt::q_range(mask, q0, CTA_ROWS), qr0 = lxt::q_range(mask, q0, WG_ROWS),
               qr1 = lxt::q_range(mask, q0 + WG_ROWS, WG_ROWS);
    int stage = 0;
    uint32_t phase = 0;
    for (int j = n_kv - 1; j >= -1; --j) {
      const int kv0 = j * STREAM_ROWS;
      const int2 kr = lxt::kv_range(mask, kv0, STREAM_ROWS);
      if (j >= 0 && lxt::tile_class(mask, q0, CTA_ROWS, kv0, STREAM_ROWS, qr, kr) == lxt::TILE_SKIP) continue;
      lxt::mbar_wait(&sm.empty[stage], phase ^ 1);
      if (lane == 0) {
        if (j >= 0) {
          lxt::mbar_arrive_expect_tx(&sm.full[stage], 2 * STREAM_ROWS * D * 2);
          lxt::tma_load_tile<D, STREAM_ROWS>(sm.k[stage], &tk, &sm.full[stage], hk, kv0, b);
          lxt::tma_load_tile<D, STREAM_ROWS>(sm.v[stage], &tv, &sm.full[stage], hk, kv0, b);
          sm.info[stage][1] = lxt::tile_class(mask, q0, WG_ROWS, kv0, STREAM_ROWS, qr0, kr);
          sm.info[stage][2] = lxt::tile_class(mask, q0 + WG_ROWS, WG_ROWS, kv0, STREAM_ROWS, qr1, kr);
        } else {
          lxt::mbar_arrive(&sm.full[stage]);
        }
        sm.info[stage][0] = j >= 0 ? kv0 : -1;
      }
      if (p.kseg && j >= 0) {
#pragma unroll
        for (int i = lane; i < STREAM_ROWS; i += 32)
          sm.kseg[stage][i] = kv0 + i < S ? p.kseg[(size_t)b * S + kv0 + i] : 0;
      }
      lxt::mbar_arrive(&sm.full[stage]);
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }
    return;
  }

  lxt::setmaxnreg_inc<240>();
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int wq0 = q0 + wg * WG_ROWS;
  int qpos[2], qseg[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = wq0 + warp * 16 + g + r * 8;
    const bool in = qpos[r] < S;
    const size_t stat = ((size_t)b * p.Hq + h) * S + qpos[r];
    qseg[r] = (p.qseg && in) ? p.qseg[(size_t)b * S + qpos[r]] : 0;
    lse2[r] = in ? p.lse[stat] * LOG2E : 0.f;
    if (ACC) {  // the caller's delta, against the ring's final out
      dl[r] = in ? p.delta[stat] : 0.f;
      continue;
    }
    // delta = rowsum(dO * O) in f32: lane c of the row's quad takes columns 32k + 8c .. + 7
    float sum = 0.f;
    if (in) {
      const size_t row = ((size_t)b * S + qpos[r]) * ((size_t)p.Hq * D) + (size_t)h * D;
#pragma unroll
      for (int k = 0; k < D / 32; ++k) {
        const uint4 ox = *reinterpret_cast<const uint4*>(p.o + row + k * 32 + c * 8);
        const uint4 dx = *reinterpret_cast<const uint4*>(p.dout + row + k * 32 + c * 8);
        const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&ox);
        const __nv_bfloat162* dh = reinterpret_cast<const __nv_bfloat162*>(&dx);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(oh[e]), df = __bfloat1622float2(dh[e]);
          sum += df.x * of.x + df.y * of.y;
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dl[r] = sum;
    if (in && c == 0) p.delta[stat] = sum;
  }
  const int gidx = h % (p.Hq / p.Hkv);
  int drop_i[2] = {0, 0};
  uint32_t drop_row[2] = {0, 0};
  if (DROP) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      drop_i[r] = qpos[r] / p.drop.bq;
      drop_row[r] = (uint32_t)(gidx * p.drop.bq + qpos[r] % p.drop.bq) * (uint32_t)p.drop.bk;
    }
  }

  // fold this warpgroup's 64 rows of Q in place, then store them to the Qs scratch
  lxt::mbar_wait(&sm.qd_full, 0);
  lxt::fold_rows<D, CTA_ROWS>(sm.q, wg * WG_ROWS, p.qscale, tid);
  lxt::fence_proxy_async();
  lxt::named_sync(1 + wg, 128);
  if (tid == 0) {
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
      lxt::tma_store_4d(&tqs, sm.q + cb * CTA_ROWS * 64 + wg * WG_ROWS * 64, cb * 64, h, wq0, b);
    lxt::tma_store_commit();
  }
  const __nv_bfloat16* qa = sm.q + wg * WG_ROWS * 64;
  const __nv_bfloat16* da = sm.dout + wg * WG_ROWS * 64;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    lxt::mbar_wait(&sm.full[stage], phase);
    const int kv0 = sm.info[stage][0];
    if (kv0 < 0) break;
    const int cls = sm.info[stage][1 + wg];
    if (cls != lxt::TILE_SKIP) {
      float s[STREAM_ROWS / 2], dp[STREAM_ROWS / 2];  // 64 q rows x 64 kv columns each
      lxt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        lxt::wgmma_ss<STREAM_ROWS>(s, lxt::desc_k_major<CTA_ROWS>(qa, kk * 16),
                                   lxt::desc_k_major<STREAM_ROWS>(sm.k[stage], kk * 16), kk > 0);
      lxt::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        lxt::wgmma_ss<STREAM_ROWS>(dp, lxt::desc_k_major<CTA_ROWS>(da, kk * 16),
                                   lxt::desc_k_major<STREAM_ROWS>(sm.v[stage], kk * 16), kk > 0);
      lxt::wgmma_commit();
      lxt::wgmma_wait<1>();  // S is in; dP runs on while P is made
      lxt::fence_regs(s);

      uint32_t drop_key[2] = {0, 0}, drop_c0 = 0;
      if (DROP) {
        const int jb = kv0 / p.drop.bk;
        drop_c0 = (uint32_t)(kv0 - jb * p.drop.bk);
#pragma unroll
        for (int r = 0; r < 2; ++r) drop_key[r] = lxt::dropout_block_key(p.drop, b, hk, drop_i[r], jb);
      }
      const int* ks = sm.kseg[stage];
      float kf[STREAM_ROWS / 2];  // dropout: keep / (1 - rate) or 0
#pragma unroll
      for (int i = 0; i < STREAM_ROWS / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, col = i * 8 + c * 2 + (e & 1);
          float pv = exp2f(s[4 * i + e] - lse2[r]);
          if (cls == lxt::TILE_PARTIAL && !lxt::visible(mask, qpos[r], kv0 + col, qseg[r], p.kseg ? ks[col] : 0))
            pv = 0.f;
          s[4 * i + e] = pv;
          if (DROP) kf[4 * i + e] = lxt::dropout_keep(p.drop, drop_key[r], drop_row[r], drop_c0 + col);
        }
      }
      lxt::wgmma_wait<0>();
      lxt::fence_regs(dp);
#pragma unroll
      for (int i = 0; i < STREAM_ROWS / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dpe = DROP ? dp[4 * i + e] * kf[4 * i + e] : dp[4 * i + e];
          dp[4 * i + e] = s[4 * i + e] * (dpe - dl[e >> 1]) * LN2;
        }
      }
      // dQ += dS K: dS rounded to bf16 as the register A operand, K MN-major from the ring
      uint32_t dsa[STREAM_ROWS / 16][4];
#pragma unroll
      for (int kk = 0; kk < STREAM_ROWS / 16; ++kk) lxt::acc_to_a(dsa[kk], dp, kk);
      lxt::fence_regs(dsa);
      lxt::fence_regs(dq);
      lxt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < STREAM_ROWS / 16; ++kk)
        lxt::wgmma_rs<D>(dq, dsa[kk], lxt::desc_mn_major<STREAM_ROWS>(sm.k[stage], kk * 16), 1);
      lxt::wgmma_commit();
      lxt::wgmma_wait<0>();
      lxt::fence_regs(dq);
    }
    __syncwarp();
    if (lane == 0) lxt::mbar_arrive(&sm.empty[stage]);
    if (++stage == STAGES) stage = 0, phase ^= 1;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= S) continue;
    const size_t off = ((size_t)b * S + qpos[r]) * ((size_t)p.Hq * D) + (size_t)h * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x = dq[4 * n + 2 * r] * p.qscale, y = dq[4 * n + 2 * r + 1] * p.qscale;
      if (ACC) {
        float2* dst = reinterpret_cast<float2*>(static_cast<float*>(p.dq) + off + n * 8 + c * 2);
        const float2 was = *dst;
        *dst = make_float2(was.x + x, was.y + y);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.dq) + off + n * 8 + c * 2) =
            __floats2bfloat162_rn(x, y);
      }
    }
  }
  if (tid == 0) lxt::tma_store_wait_read();  // the Qs store has read its shared rows
}

// ---------------------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  __nv_bfloat16 k[CTA_ROWS * D];
  __nv_bfloat16 v[CTA_ROWS * D];
  __nv_bfloat16 q[STAGES][STREAM_ROWS * D];  // Qs, folded by the dq kernel
  __nv_bfloat16 dout[STAGES][STREAM_ROWS * D];
  float lse2[STAGES][STREAM_ROWS];  // lse * log2e
  float delta[STAGES][STREAM_ROWS];
  int qseg[STAGES][STREAM_ROWS];
  uint32_t dkey[STAGES][STREAM_ROWS];  // dropout: fmix32(block key) per q column
  uint32_t drow[STAGES][STREAM_ROWS];  // dropout: r * bk per q column
  int info[STAGES][3];                 // the tile's q0 (-1: no more tiles) and its class for each consumer warpgroup
  uint64_t kv_full, full[STAGES], empty[STAGES];
};

template <int D, bool DROP, bool ACC>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tqs, const __grid_constant__ CUtensorMap tdo,
                         const Params p) {
  extern __shared__ unsigned char smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int S = p.S;
  const int n_q = (S + STREAM_ROWS - 1) / STREAM_ROWS;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int kv0 = blockIdx.z * CTA_ROWS;  // the kv tiles that see the most q tiles (causal) first
  const int group = p.Hq / p.Hkv;
  const lxt::Mask mask = lxt::batch_mask(S, p.causal, p.prefix, p.qrange, p.krange, b, p.q_offset, p.kv_offset);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int drop_j = DROP ? kv0 / p.drop.bk : 0;  // one plan block holds the whole kv tile

  if (threadIdx.x == 0) {
    lxt::mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      lxt::mbar_init(&sm.full[s], 33);
      lxt::mbar_init(&sm.empty[s], 8);
    }
    lxt::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    lxt::setmaxnreg_dec<24>();
    if (tid >= 32) return;
    const int lane = tid;
    if (lane == 0) {
      lxt::tma_prefetch_map(&tqs);
      lxt::tma_prefetch_map(&tdo);
      lxt::mbar_arrive_expect_tx(&sm.kv_full, 2 * CTA_ROWS * D * 2);
      lxt::tma_load_tile<D, CTA_ROWS>(sm.k, &tk, &sm.kv_full, hk, kv0, b);
      lxt::tma_load_tile<D, CTA_ROWS>(sm.v, &tv, &sm.kv_full, hk, kv0, b);
    }
    // the producer alone sorts the tiles and hands each loaded tile's classes to the
    // consumers in the ring; a q0 of -1 ends their loop
    const int2 kr = lxt::kv_range(mask, kv0, CTA_ROWS), kr0 = lxt::kv_range(mask, kv0, WG_ROWS),
               kr1 = lxt::kv_range(mask, kv0 + WG_ROWS, WG_ROWS);
    int stage = 0;
    uint32_t phase = 0;
    for (int hq = 0; hq < group; ++hq) {
      const int h = hk * group + hq;
      const size_t stat = ((size_t)b * p.Hq + h) * S;
      for (int qt = 0; qt < n_q; ++qt) {
        const int q0 = qt * STREAM_ROWS;
        const int2 qr = lxt::q_range(mask, q0, STREAM_ROWS);
        if (lxt::tile_class(mask, q0, STREAM_ROWS, kv0, CTA_ROWS, qr, kr) == lxt::TILE_SKIP) continue;
        lxt::mbar_wait(&sm.empty[stage], phase ^ 1);
        if (lane == 0) {
          lxt::mbar_arrive_expect_tx(&sm.full[stage], 2 * STREAM_ROWS * D * 2);
          lxt::tma_load_tile<D, STREAM_ROWS>(sm.q[stage], &tqs, &sm.full[stage], h, q0, b);
          lxt::tma_load_tile<D, STREAM_ROWS>(sm.dout[stage], &tdo, &sm.full[stage], h, q0, b);
          sm.info[stage][0] = q0;
          sm.info[stage][1] = lxt::tile_class(mask, q0, STREAM_ROWS, kv0, WG_ROWS, qr, kr0);
          sm.info[stage][2] = lxt::tile_class(mask, q0, STREAM_ROWS, kv0 + WG_ROWS, WG_ROWS, qr, kr1);
        }
#pragma unroll
        for (int i = lane; i < STREAM_ROWS; i += 32) {
          const int qp = q0 + i;
          const bool in = qp < S;
          sm.lse2[stage][i] = in ? p.lse[stat + qp] * LOG2E : 0.f;
          sm.delta[stage][i] = in ? p.delta[stat + qp] : 0.f;
          sm.qseg[stage][i] = (p.qseg && in) ? p.qseg[(size_t)b * S + qp] : 0;
          if (DROP) {
            sm.dkey[stage][i] = lxt::dropout_block_key(p.drop, b, hk, qp / p.drop.bq, drop_j);
            sm.drow[stage][i] = (uint32_t)(hq * p.drop.bq + qp % p.drop.bq) * (uint32_t)p.drop.bk;
          }
        }
        lxt::mbar_arrive(&sm.full[stage]);
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
    lxt::mbar_wait(&sm.empty[stage], phase ^ 1);
    if (lane == 0) {
      lxt::mbar_arrive(&sm.full[stage]);
      sm.info[stage][0] = -1;
    }
    lxt::mbar_arrive(&sm.full[stage]);
    return;
  }

  lxt::setmaxnreg_inc<240>();
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int wk0 = kv0 + wg * WG_ROWS;
  int kpos[2], kseg[2];
  uint32_t drop_c[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kpos[r] = wk0 + warp * 16 + g + r * 8;
    kseg[r] = (p.kseg && kpos[r] < S) ? p.kseg[(size_t)b * S + kpos[r]] : 0;
    drop_c[r] = (uint32_t)(kpos[r] - drop_j * p.drop.bk);
  }
  const __nv_bfloat16* ka = sm.k + wg * WG_ROWS * 64;
  const __nv_bfloat16* va = sm.v + wg * WG_ROWS * 64;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  lxt::mbar_wait(&sm.kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    lxt::mbar_wait(&sm.full[stage], phase);
    const int q0 = sm.info[stage][0];
    if (q0 < 0) break;
    const int cls = sm.info[stage][1 + wg];
    if (cls != lxt::TILE_SKIP) {
      float st[STREAM_ROWS / 2], dpt[STREAM_ROWS / 2];  // S^T then P^T; dP^T then dS^T: 64 kv rows x 64 q columns
      lxt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        lxt::wgmma_ss<STREAM_ROWS>(st, lxt::desc_k_major<CTA_ROWS>(ka, kk * 16),
                                   lxt::desc_k_major<STREAM_ROWS>(sm.q[stage], kk * 16), kk > 0);
      lxt::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        lxt::wgmma_ss<STREAM_ROWS>(dpt, lxt::desc_k_major<CTA_ROWS>(va, kk * 16),
                                   lxt::desc_k_major<STREAM_ROWS>(sm.dout[stage], kk * 16), kk > 0);
      lxt::wgmma_commit();
      lxt::wgmma_wait<1>();  // S^T is in; dP^T runs on while P is made
      lxt::fence_regs(st);

      // P^T, undropped in st for dS; bf16(p * keep) as the A operand of dV += P^T dO
      const float* lse2 = sm.lse2[stage];
      float pd[STREAM_ROWS / 2];
      uint32_t kept = 0;  // dropout: bit 4i+e set where the element is kept
#pragma unroll
      for (int i = 0; i < STREAM_ROWS / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, qi = i * 8 + c * 2 + (e & 1);
          float pv = exp2f(st[4 * i + e] - lse2[qi]);
          if (cls == lxt::TILE_PARTIAL && !lxt::visible(mask, q0 + qi, kpos[r], sm.qseg[stage][qi], kseg[r])) pv = 0.f;
          st[4 * i + e] = pv;
          if (DROP) {
            const float kf = lxt::dropout_keep(p.drop, sm.dkey[stage][qi], sm.drow[stage][qi], drop_c[r]);
            kept |= (kf != 0.f ? 1u : 0u) << (4 * i + e);
            pd[4 * i + e] = pv * kf;
          } else {
            pd[4 * i + e] = pv;
          }
        }
      }
      uint32_t pa[STREAM_ROWS / 16][4], dsa[STREAM_ROWS / 16][4];
#pragma unroll
      for (int kk = 0; kk < STREAM_ROWS / 16; ++kk) lxt::acc_to_a(pa[kk], pd, kk);
      lxt::fence_regs(pa);
      lxt::fence_regs(dv);
      lxt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < STREAM_ROWS / 16; ++kk)
        lxt::wgmma_rs<D>(dv, pa[kk], lxt::desc_mn_major<STREAM_ROWS>(sm.dout[stage], kk * 16), 1);
      lxt::wgmma_commit();
      lxt::wgmma_wait<1>();  // dP^T is in; the dV product runs on while dS is made
      lxt::fence_regs(dpt);

      const float* delta = sm.delta[stage];
#pragma unroll
      for (int i = 0; i < STREAM_ROWS / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = i * 8 + c * 2 + (e & 1);
          float dpe = dpt[4 * i + e];
          if (DROP) dpe = (kept >> (4 * i + e)) & 1u ? dpe * p.drop.keep_scale : 0.f;
          dpt[4 * i + e] = st[4 * i + e] * (dpe - delta[qi]) * LN2;
        }
      }
      // dK += dS^T Qs: A from registers, Qs MN-major from the ring
#pragma unroll
      for (int kk = 0; kk < STREAM_ROWS / 16; ++kk) lxt::acc_to_a(dsa[kk], dpt, kk);
      lxt::fence_regs(dsa);
      lxt::fence_regs(dk);
      lxt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < STREAM_ROWS / 16; ++kk)
        lxt::wgmma_rs<D>(dk, dsa[kk], lxt::desc_mn_major<STREAM_ROWS>(sm.q[stage], kk * 16), 1);
      lxt::wgmma_commit();
      lxt::wgmma_wait<0>();
      lxt::fence_regs(dv);
      lxt::fence_regs(dk);
      lxt::fence_regs(pa);  // the register operands stay untouched until their products are done
      lxt::fence_regs(dsa);
    }
    __syncwarp();
    if (lane == 0) lxt::mbar_arrive(&sm.empty[stage]);
    if (++stage == STAGES) stage = 0, phase ^= 1;
  }

  const size_t kv_row = (size_t)p.Hkv * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= S) continue;
    const size_t off = ((size_t)b * S + kpos[r]) * kv_row + (size_t)hk * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + c * 2;
      if (ACC) {
        float2* dkp = reinterpret_cast<float2*>(static_cast<float*>(p.dk) + off + col);
        float2* dvp = reinterpret_cast<float2*>(static_cast<float*>(p.dv) + off + col);
        const float2 ok = *dkp, ov = *dvp;
        *dkp = make_float2(ok.x + dk[4 * n + 2 * r], ok.y + dk[4 * n + 2 * r + 1]);
        *dvp = make_float2(ov.x + dv[4 * n + 2 * r], ov.y + dv[4 * n + 2 * r + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.dk) + off + col) =
            __floats2bfloat162_rn(dk[4 * n + 2 * r], dk[4 * n + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.dv) + off + col) =
            __floats2bfloat162_rn(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
      }
    }
  }
}

template <int D, bool DROP, bool ACC>
int launch(const Params& p, const void* q, const void* k, const void* v, const void* dout, void* qs,
           cudaStream_t st) {
  // dq kernel: Q, dO by 128 rows, K, V by 64, the Qs store by 64; dkv kernel: K, V by
  // 128, Qs, dO by 64
  CUtensorMap q128, do128, k64, v64, qs64, k128, v128, do64;
  const bool ok = lxt::make_bshd_map(&q128, q, p.B, p.S, p.Hq, D, CTA_ROWS) &&
                  lxt::make_bshd_map(&do128, dout, p.B, p.S, p.Hq, D, CTA_ROWS) &&
                  lxt::make_bshd_map(&k64, k, p.B, p.S, p.Hkv, D, STREAM_ROWS) &&
                  lxt::make_bshd_map(&v64, v, p.B, p.S, p.Hkv, D, STREAM_ROWS) &&
                  lxt::make_bshd_map(&qs64, qs, p.B, p.S, p.Hq, D, STREAM_ROWS) &&
                  lxt::make_bshd_map(&k128, k, p.B, p.S, p.Hkv, D, CTA_ROWS) &&
                  lxt::make_bshd_map(&v128, v, p.B, p.S, p.Hkv, D, CTA_ROWS) &&
                  lxt::make_bshd_map(&do64, dout, p.B, p.S, p.Hq, D, STREAM_ROWS);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int dq_bytes = sizeof(DqSmem<D>) + 1024, dkv_bytes = sizeof(DkvSmem<D>) + 1024;
  static const cudaError_t attr_dq =  // once per instantiation and process (one card a process)
      cudaFuncSetAttribute(flash_bwd_dq_kernel<D, DROP, ACC>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  static const cudaError_t attr_dkv =
      cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, DROP, ACC>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);
  if (attr_dkv != cudaSuccess) return static_cast<int>(attr_dkv);
  cudaError_t err;
  flash_bwd_dq_kernel<D, DROP, ACC><<<dim3(p.Hq, p.B, (p.S + CTA_ROWS - 1) / CTA_ROWS), THREADS, dq_bytes, st>>>(
      q128, do128, k64, v64, qs64, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<D, DROP, ACC><<<dim3(p.Hkv, p.B, (p.S + CTA_ROWS - 1) / CTA_ROWS), THREADS, dkv_bytes, st>>>(
      k128, v128, qs64, do64, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qrange / krange: as for lxt_flash_attention_fwd. delta: f32 [B, Hq, S] scratch and qs:
// scratch of q's shape and type, written by the dq kernel (rowsum(dO * O) and the folded
// q) and read by the dkv kernel. dropout, threshold, keep_scale, seed, bq, bk: the
// forward's dropout (common.cuh), with the JAX plan's blocks that key the mask.
// accumulate = 1 is the offsets form: q_offset / kv_offset place the q shard and the kv
// block, delta is the caller's (read only), dq / dk / dv are f32 accumulators of q's / k's
// shape that the kernels add into; it takes no dropout.
extern "C" int lxt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
                                       const void* lse, void* delta, const void* qseg, const void* kseg, const void* qrange,
                                       const void* krange, const void* prefix, void* qs, void* dq, void* dk, void* dv,
                                       int B, int S, int Hq, int Hkv, int D, int causal, int q_offset, int kv_offset,
                                       int accumulate, float qscale, int dropout, unsigned int threshold,
                                       float keep_scale, unsigned int seed, int bq, int bk, void* stream) {
  Params p;
  p.o = static_cast<const __nv_bfloat16*>(out);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.prefix = static_cast<const int*>(prefix);
  p.qrange = static_cast<const int*>(qrange);
  p.krange = static_cast<const int*>(krange);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.causal = causal;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.qscale = qscale;
  p.drop = lxt::Dropout{dropout, threshold, keep_scale, seed, bq > 0 ? bq : 1, bk > 0 ? bk : 1};
  if ((qseg == nullptr) != (qrange == nullptr) || (kseg == nullptr) != (krange == nullptr) || (accumulate && dropout))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    if (accumulate) return launch<128, false, true>(p, q, k, v, dout, qs, st);
    return dropout ? launch<128, true, false>(p, q, k, v, dout, qs, st) : launch<128, false, false>(p, q, k, v, dout, qs, st);
  }
  if (D == 64) {
    if (accumulate) return launch<64, false, true>(p, q, k, v, dout, qs, st);
    return dropout ? launch<64, true, false>(p, q, k, v, dout, qs, st) : launch<64, false, false>(p, q, k, v, dout, qs, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
