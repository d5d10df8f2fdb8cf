// K5: flash attention backward: dq, dk, dv from q, k, v, dO, the forward's natural-log
// lse and delta = rowsum(dO * O), bf16 in and out, f32 accumulation, with the
// MaskInfo mask rebuilt in the kernel exactly as K2 builds it:
// (causal & same segment) | in-prefix.
//
// Replaces the Pallas TPU kernel llama_x_tpu/ops/flash_attention.py:_bwd_dkv_kernel
// (through _bwd, the custom_vjp of flash_attention and flash_bwd_from_res). It
// computes what _bwd computes, with the same rounding points: q folded with
// scale*log2e by one f32 multiply and one rounding to bf16 (so the recomputed s meets
// the stored lse: p = exp2(s - lse*log2e)), masked logits -1e30, p rounded to bf16
// before the dV product, ds = p * (dp - delta) * ln2 rounded to bf16 before the dk and
// dq products, dk = ds^T (q*scale*log2e), dq = (ds k) * scale*log2e applied once at the
// end, dk and dv summed over the GQA group inside the kernel. With dropout the forward's
// keep mask is rebuilt from the same hash (common.cuh), keyed on the JAX plan's blocks
// (bq, bk) and indexed by (q position, kv position), never by a tile's own row and
// column (the dkv kernel walks S^T): dV += bf16(p * keep)^T dO, dp = (dO V^T) * keep,
// ds = p (dp - delta) ln2 with the undropped p, delta unchanged. A 64-position kv tile
// lies inside one kv block of the plan (bk is a multiple of 64, or spans the sequence);
// the q block may change inside a q tile (bq 32), so the dkv kernel keeps fmix32(key)
// and r * bk per q column in shared memory. The ring position offsets are not ported yet.
//
// What bounds it on an H100: the bf16 tensor-core rate; the five products that the
// algorithm needs are 10*B*Hq*S*S*D operations (half of that under a causal mask) at
// 989 TFLOP/s, against a few tens of MB of q, k, v, dO, dq, dk, dv.
//
// Design. The TPU kernel writes per-kv-block dq partials that XLA then sums, because
// its grid runs kv blocks in parallel. Here the choice is between f32 atomicAdd into
// dq (order varies from run to run), partials plus a reduction (S/64 times the dq
// bytes), or two kernels. Two kernels, both deterministic:
//   dkv: one CTA of 4 warps per (64 kv positions, kv head, batch row). K and V tiles
//        stay in shared memory; the CTA walks the GQA group's query heads and every
//        64-row q tile that can see its kv tile, and each warp keeps the dk and dv
//        accumulators of its 16 kv rows in registers. It works on the TRANSPOSED
//        logits S^T = K Qs^T (16 kv rows x 64 q columns per warp), so that P^T and dS^T
//        leave the MMA in exactly the A-operand layout of the dV += P^T dO and
//        dK += dS^T Qs products (the m16n8 C fragment is the A fragment of the next
//        product, as in K2), and lse / delta are per-column values read from shared
//        memory.
//   dq:  one CTA per (64 q rows, q head, batch row), the forward's loop: Qs and dO
//        stay in shared memory, kv tiles stream through, dq accumulates in registers
//        and is scaled once at the end.
// The price is that S, P and dP are computed twice: 7 products where 5 are needed
// (+40% tensor-core work) for bit-reproducible gradients and no extra memory. Ragged
// S is masked in the kernel (zero-filled tiles, p = 0 outside, no store past S).
// Not yet done (later work): wgmma + TMA, ldmatrix.trans for the operands read along
// the sequence axis (2-byte shared loads today), per-tile skipping of fully masked
// segment tiles.

#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;         // [B, Hq, S]
  const int *qseg, *kseg, *prefix;  // null when absent
  __nv_bfloat16 *dq, *dk, *dv;
  int B, S, Hq, Hkv, causal;
  float qscale;  // scale * log2(e)
  lxt::Dropout drop;
};

template <int D>
constexpr int smem_bytes() {
  return 4 * 64 * (D + 8) * 2 + 5 * 64 * 4;
}

// 64 rows x D of one head from a [B, S, H, D] tensor into a padded shared tile,
// zero-filled past S; SCALE folds qscale into the values with one rounding to bf16.
template <int D, bool SCALE>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[D + 8], const __nv_bfloat16* src, size_t row_stride,
                                          int pos0, int S, float qscale, int tid) {
  constexpr int CHUNKS = 64 * D / 8;  // 16-byte chunks
#pragma unroll
  for (int i = 0; i < CHUNKS / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int row = c / (D / 8), col = (c % (D / 8)) * 8;
    const int pos = pos0 + row;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (pos < S) x = *reinterpret_cast<const uint4*>(src + (size_t)pos * row_stride + col);
    if (SCALE) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        h[j] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
      }
    }
    *reinterpret_cast<uint4*>(&dst[row][col]) = x;
  }
}

// acc[8][4] (16 rows x 64 columns) = A (this warp's 16 rows of a_tile) * B^T (64 rows of b_tile)
template <int D>
__device__ __forceinline__ void mma_rows_by_rows(float (&acc)[8][4], const __nv_bfloat16 (*a_tile)[D + 8], int a_row0,
                                                 const __nv_bfloat16 (*b_tile)[D + 8], int g, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(&a_tile[a_row0 + g][kk * 16 + t * 2]);
    a[1] = *reinterpret_cast<const uint32_t*>(&a_tile[a_row0 + g + 8][kk * 16 + t * 2]);
    a[2] = *reinterpret_cast<const uint32_t*>(&a_tile[a_row0 + g][kk * 16 + 8 + t * 2]);
    a[3] = *reinterpret_cast<const uint32_t*>(&a_tile[a_row0 + g + 8][kk * 16 + 8 + t * 2]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&b_tile[n * 8 + g][kk * 16 + t * 2]);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&b_tile[n * 8 + g][kk * 16 + 8 + t * 2]);
      lxt::mma_bf16_16816(acc[n], a, b0, b1);
    }
  }
}

// acc[D/8][4] (16 rows x D) += X (16 x 64, f32 in the C layout, rounded to bf16) * b_tile (64 x D)
template <int D>
__device__ __forceinline__ void mma_acc_by_tile(float (&acc)[D / 8][4], const float (&x)[8][4],
                                                const __nv_bfloat16 (*b_tile)[D + 8], int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = lxt::pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = lxt::pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = lxt::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = lxt::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const int k0 = kk * 16 + t * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + g;
      const uint32_t b0 = lxt::pack_bf16(b_tile[k0][col], b_tile[k0 + 1][col]);
      const uint32_t b1 = lxt::pack_bf16(b_tile[k0 + 8][col], b_tile[k0 + 9][col]);
      lxt::mma_bf16_16816(acc[n], a, b0, b1);
    }
  }
}

// DROP is a template argument so that the kernels without dropout stay as they were
template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(Params p) {
  constexpr int LD = D + 8;
  typedef __nv_bfloat16(*Tile)[LD];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile Ks = reinterpret_cast<Tile>(smem_raw);
  Tile Vs = Ks + 64, Qs = Vs + 64, dOs = Qs + 64;
  float* lse_s = reinterpret_cast<float*>(dOs + 64);  // lse * log2e of the q tile's rows
  float* delta_s = lse_s + 64;
  int* qseg_s = reinterpret_cast<int*>(delta_s + 64);
  uint32_t* dkey_s = reinterpret_cast<uint32_t*>(qseg_s + 64);  // dropout: fmix32(block key) per q column
  uint32_t* drow_s = dkey_s + 64;                               // dropout: r * bk per q column

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int S = p.S;
  const size_t q_row = (size_t)p.Hq * D, kv_row = (size_t)p.Hkv * D;
  const int prefix = p.prefix ? p.prefix[b] : 0;

  load_tile<D, false>(Ks, p.k + (size_t)b * S * kv_row + (size_t)hk * D, kv_row, kv0, S, 0.f, tid);
  load_tile<D, false>(Vs, p.v + (size_t)b * S * kv_row + (size_t)hk * D, kv_row, kv0, S, 0.f, tid);

  // this lane's two kv rows (g and g+8 of the warp's 16)
  int kpos[2], kseg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kpos[r] = kv0 + warp * 16 + g + r * 8;
    kseg[r] = (p.kseg && kpos[r] < S) ? p.kseg[(size_t)b * S + kpos[r]] : 0;
  }

  // dropout: this CTA's kv block of the plan and this lane's two columns in it
  const int drop_j = DROP ? kv0 / p.drop.bk : 0;
  uint32_t drop_c[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) drop_c[r] = (uint32_t)(kpos[r] - drop_j * p.drop.bk);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk_acc[n][r] = dv_acc[n][r] = 0.f;

  const int n_q_tiles = (S + BQ - 1) / BQ;
  for (int hq = 0; hq < group; ++hq) {
    const int h = hk * group + hq;
    const __nv_bfloat16* q_src = p.q + (size_t)b * S * q_row + (size_t)h * D;
    const __nv_bfloat16* do_src = p.dout + (size_t)b * S * q_row + (size_t)h * D;
    const size_t stat = ((size_t)b * p.Hq + h) * S;
    for (int qt = 0; qt < n_q_tiles; ++qt) {
      const int q0 = qt * BQ;
      // whole-tile skip: every element provably masked (the same for all threads)
      if (p.causal && q0 + BQ - 1 < kv0 && !(p.prefix && q0 < prefix && kv0 < prefix)) continue;
      __syncthreads();  // the previous tile's readers are done (and K, V are visible)
      load_tile<D, true>(Qs, q_src, q_row, q0, S, p.qscale, tid);
      load_tile<D, false>(dOs, do_src, q_row, q0, S, 0.f, tid);
      if (tid < BQ) {
        const int qp = q0 + tid;
        const bool in = qp < S;
        lse_s[tid] = in ? p.lse[stat + qp] * LOG2E : 0.f;
        delta_s[tid] = in ? p.delta[stat + qp] : 0.f;
        qseg_s[tid] = (p.qseg && in) ? p.qseg[(size_t)b * S + qp] : 0;
        if (DROP) {
          dkey_s[tid] = lxt::dropout_block_key(p.drop, b, hk, qp / p.drop.bq, drop_j);
          drow_s[tid] = (uint32_t)(hq * p.drop.bq + qp % p.drop.bq) * (uint32_t)p.drop.bk;
        }
      }
      __syncthreads();

      float st[8][4], dpt[8][4];  // S^T then P^T; dP^T then dS^T: 16 kv rows x 64 q columns
      mma_rows_by_rows<D>(st, Ks, warp * 16, Qs, g, t);
      mma_rows_by_rows<D>(dpt, Vs, warp * 16, dOs, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int qi = n * 8 + t * 2 + (e & 1);
          const int qp = q0 + qi;
          bool keep = true;
          if (p.causal) keep = qp >= kpos[r];
          if (p.qseg) keep = keep && qseg_s[qi] == kseg[r];
          if (p.prefix) keep = keep || (qp < prefix && kpos[r] < prefix);
          if (qp >= S || kpos[r] >= S) keep = false;
          const float pv = keep ? exp2f(st[n][e] - lse_s[qi]) : 0.f;
          const float kf = DROP ? lxt::dropout_keep(p.drop, dkey_s[qi], drow_s[qi], drop_c[r]) : 1.f;
          st[n][e] = DROP ? pv * kf : pv;
          const float dp = DROP ? dpt[n][e] * kf : dpt[n][e];
          dpt[n][e] = pv * (dp - delta_s[qi]) * LN2;
        }
      }
      mma_acc_by_tile<D>(dv_acc, st, dOs, g, t);  // dV += P^T dO
      mma_acc_by_tile<D>(dk_acc, dpt, Qs, g, t);  // dK += dS^T Qs
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= S) continue;
    const size_t off = ((size_t)b * S + kpos[r]) * kv_row + (size_t)hk * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + t * 2;
      *reinterpret_cast<__nv_bfloat162*>(p.dk + off + col) = __floats2bfloat162_rn(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + off + col) = __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Params p) {
  constexpr int LD = D + 8;
  typedef __nv_bfloat16(*Tile)[LD];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile Ks = reinterpret_cast<Tile>(smem_raw);
  Tile Vs = Ks + 64, Qs = Vs + 64, dOs = Qs + 64;
  int* kseg_s = reinterpret_cast<int*>(dOs + 64);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int S = p.S;
  const size_t q_row = (size_t)p.Hq * D, kv_row = (size_t)p.Hkv * D;
  const int prefix = p.prefix ? p.prefix[b] : 0;

  load_tile<D, true>(Qs, p.q + (size_t)b * S * q_row + (size_t)h * D, q_row, q0, S, p.qscale, tid);
  load_tile<D, false>(dOs, p.dout + (size_t)b * S * q_row + (size_t)h * D, q_row, q0, S, 0.f, tid);

  // this lane's two query rows (g and g+8 of the warp's 16)
  int qpos[2], qseg[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + warp * 16 + g + r * 8;
    const bool in = qpos[r] < S;
    const size_t stat = ((size_t)b * p.Hq + h) * S + qpos[r];
    qseg[r] = (p.qseg && in) ? p.qseg[(size_t)b * S + qpos[r]] : 0;
    lse2[r] = in ? p.lse[stat] * LOG2E : 0.f;
    dl[r] = in ? p.delta[stat] : 0.f;
  }

  // dropout: this lane's rows in the JAX plan (q block, stacked-group row offset r * bk)
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

  // last kv position any row of this CTA may see (the forward's bound)
  int kv_end = S;
  if (p.causal) {
    kv_end = min(S, q0 + BQ);
    if (p.prefix && q0 < prefix) kv_end = max(kv_end, min(S, prefix));
  }
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) dq_acc[n][r] = 0.f;

  const __nv_bfloat16* k_src = p.k + (size_t)b * S * kv_row + (size_t)hk * D;
  const __nv_bfloat16* v_src = p.v + (size_t)b * S * kv_row + (size_t)hk * D;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * BKV;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, false>(Ks, k_src, kv_row, kv0, S, 0.f, tid);
    load_tile<D, false>(Vs, v_src, kv_row, kv0, S, 0.f, tid);
    if (tid < BKV) kseg_s[tid] = (p.kseg && kv0 + tid < S) ? p.kseg[(size_t)b * S + kv0 + tid] : 0;
    __syncthreads();

    float sf[8][4], dpf[8][4];  // S then P; dP then dS: 16 q rows x 64 kv columns
    mma_rows_by_rows<D>(sf, Qs, warp * 16, Ks, g, t);
    mma_rows_by_rows<D>(dpf, dOs, warp * 16, Vs, g, t);
    uint32_t drop_key[2] = {0, 0}, drop_c0 = 0;
    if (DROP) {
      const int j = kv0 / p.drop.bk;
      drop_c0 = (uint32_t)(kv0 - j * p.drop.bk);
#pragma unroll
      for (int r = 0; r < 2; ++r) drop_key[r] = lxt::dropout_block_key(p.drop, b, hk, drop_i[r], j);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int ki = n * 8 + t * 2 + (e & 1);
        const int kp = kv0 + ki;
        bool keep = true;
        if (p.causal) keep = qpos[r] >= kp;
        if (p.qseg) keep = keep && qseg[r] == kseg_s[ki];
        if (p.prefix) keep = keep || (qpos[r] < prefix && kp < prefix);
        if (kp >= S || qpos[r] >= S) keep = false;
        const float pv = keep ? exp2f(sf[n][e] - lse2[r]) : 0.f;
        const float dp = DROP ? dpf[n][e] * lxt::dropout_keep(p.drop, drop_key[r], drop_row[r], drop_c0 + ki)
                                   : dpf[n][e];
        dpf[n][e] = pv * (dp - dl[r]) * LN2;
      }
    }
    mma_acc_by_tile<D>(dq_acc, dpf, Ks, g, t);  // dQ += dS K
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= S) continue;
    __nv_bfloat16* dst = p.dq + ((size_t)b * S + qpos[r]) * q_row + (size_t)h * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + t * 2;
      *reinterpret_cast<__nv_bfloat162*>(dst + col) =
          __floats2bfloat162_rn(dq_acc[n][2 * r] * p.qscale, dq_acc[n][2 * r + 1] * p.qscale);
    }
  }
}

template <int D, bool DROP>
int launch(const Params& p, cudaStream_t st) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (p.S + 63) / 64;
  flash_bwd_dkv_kernel<D, DROP><<<dim3(tiles, p.Hkv, p.B), THREADS, bytes, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D, DROP><<<dim3(tiles, p.Hq, p.B), THREADS, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dropout, threshold, keep_scale, seed, bq, bk: the forward's dropout (common.cuh), with
// the JAX plan's blocks that key the mask.
extern "C" int lxt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                       const void* delta, const void* qseg, const void* kseg, const void* prefix,
                                       void* dq, void* dk, void* dv, int B, int S, int Hq, int Hkv, int D, int causal,
                                       float qscale, int dropout, unsigned int threshold, float keep_scale,
                                       unsigned int seed, int bq, int bk, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.prefix = static_cast<const int*>(prefix);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.B = B;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.causal = causal;
  p.qscale = qscale;
  p.drop = lxt::Dropout{dropout, threshold, keep_scale, seed, bq > 0 ? bq : 1, bk > 0 ? bk : 1};
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 128) return dropout ? launch<128, true>(p, st) : launch<128, false>(p, st);
  if (D == 64) return dropout ? launch<64, true>(p, st) : launch<64, false>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
