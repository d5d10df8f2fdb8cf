// K2: flash attention forward (prefill / training-shape attention), bf16 in and out,
// with the MaskInfo mask built in the kernel: (causal & same segment) | in-prefix.
//
// Replaces the Pallas TPU kernel llama_x_tpu/ops/flash_attention.py:_fwd_kernel
// (through _fwd, flash_fwd_with_lse and flash_attention), which the JAX model runs
// for the prefill and every training forward (llama_x_tpu/models/llama.py:302-309),
// dropout on the probabilities included: the keep mask is that kernel's hash, bit for
// bit (common.cuh), keyed on the JAX plan's blocks (bq, bk) and not on this kernel's
// tiles; f32 p is multiplied by keep / (1 - rate) and then rounded to bf16 for the PV
// product, and l sums the undropped p. A row's q block is fixed, and a 64-position kv
// tile lies inside one kv block (bk is a multiple of 64, or spans the sequence), so the
// inner fmix32 of the block key is hoisted to once per row and tile. The ring position
// offsets of that kernel are not ported yet.
//
// What bounds it on an H100: at the serving prefill (S = 512, head_dim 128) the
// bf16 tensor-core rate, 4*B*Hq*S*S*D/2 operations for the causal half at 989 TFLOP/s;
// the bytes (q, k, v, out once) are a few MB.
//
// Design: one CTA of 4 warps per (64 query rows, q head, batch row); each warp owns
// 16 query rows and keeps their q fragments in registers for the whole loop. The CTA
// walks 64-position kv tiles staged in shared memory (rows padded by 8 bf16 so the
// fragment reads are bank-conflict free), S = q k^T and O += P V run as mma.sync
// m16n8k16 bf16 products with fp32 accumulators, and the online softmax stays in
// fp32 registers in the base-2 domain: scale*log2e is folded into q (one f32 multiply,
// one rounding to bf16, as the JAX wrapper does) and exp2 is the hardware's ex2.
// The kv loop ends at the last tile any row of the CTA can see (causal diagonal,
// extended through the bidirectional prefix) in place of the TPU kernel's
// whole-block skip. Masked logits are -1e30, the epilogue guards l == 0, and the
// natural-log lse comes out beside the output. q/k/v/out are read and written in the
// model's [B, S, H, D] layout, so no transposes exist around the kernel. Ragged S is
// masked in the kernel (zero-filled tiles, -1e30 beyond S, no store past S).
// Not yet done (later work): wgmma + TMA, sharing one K/V tile read across the GQA
// group, and skipping the mask on tiles that are provably all visible.

#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const __nv_bfloat16 *q, *k, *v;
  const int *qseg, *kseg, *prefix;  // null when absent
  __nv_bfloat16* out;
  float* lse;
  int B, S, Hq, Hkv, causal;
  float qscale;  // scale * log2(e)
  lxt::Dropout drop;
};

// DROP is a template argument so that the kernel without dropout stays as it was
template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  constexpr int LD = D + 8;  // padded smem row, elements
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV][LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKV][LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int S = p.S;
  const size_t q_row = (size_t)p.Hq * D, kv_row = (size_t)p.Hkv * D;
  const int prefix = p.prefix ? p.prefix[b] : 0;

  // this lane's two query rows (g and g+8 of the warp's 16)
  int qpos[2], qseg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + warp * 16 + g + r * 8;
    qseg[r] = (p.qseg && qpos[r] < S) ? p.qseg[(size_t)b * S + qpos[r]] : 0;
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

  // q fragments, pre-scaled by scale*log2e and rounded to bf16 (the JAX fold)
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = qpos[r & 1];
      const int col = kk * 16 + t * 2 + (r >> 1) * 8;
      float x0 = 0.f, x1 = 0.f;
      if (row < S) {
        const __nv_bfloat16* src = p.q + ((size_t)b * S + row) * q_row + (size_t)h * D + col;
        x0 = __bfloat162float(src[0]) * p.qscale;
        x1 = __bfloat162float(src[1]) * p.qscale;
      }
      qf[kk][r] = lxt::pack_bf16(x0, x1);
    }
  }

  // last kv position any row of this CTA may see
  int kv_end = S;
  if (p.causal) {
    kv_end = min(S, q0 + BQ);
    if (p.prefix && q0 < prefix) kv_end = max(kv_end, min(S, prefix));
  }
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  float of[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) of[n][r] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * BKV;
    __syncthreads();  // previous tile's readers are done
    constexpr int CHUNKS = BKV * D / 8;  // 16-byte chunks per tile
#pragma unroll
    for (int i = 0; i < CHUNKS / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int row = c / (D / 8), col = (c % (D / 8)) * 8;
      const int pos = kv0 + row;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (pos < S) {
        const size_t off = ((size_t)b * S + pos) * kv_row + (size_t)hk * D + col;
        kx = *reinterpret_cast<const uint4*>(p.k + off);
        vx = *reinterpret_cast<const uint4*>(p.v + off);
      }
      *reinterpret_cast<uint4*>(&Ks[row][col]) = kx;
      *reinterpret_cast<uint4*>(&Vs[row][col]) = vx;
    }
    __syncthreads();

    // S = q k^T for this warp's 16 rows x 64 kv positions
    float sf[BKV / 8][4];
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) sf[n][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Ks[n * 8 + g][kk * 16 + t * 2]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Ks[n * 8 + g][kk * 16 + 8 + t * 2]);
        lxt::mma_bf16_16816(sf[n], qf[kk], b0, b1);
      }
    }

    // mask: (causal & same segment) | in-prefix, and nothing at or past S
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kp = kv0 + n * 8 + t * 2 + (e & 1);
        bool keep = true;
        if (p.causal) keep = qpos[r] >= kp;
        if (p.qseg) keep = keep && (kp < S) && qseg[r] == p.kseg[(size_t)b * S + kp];
        if (p.prefix) keep = keep || (qpos[r] < prefix && kp < prefix);
        if (kp >= S) keep = false;
        if (!keep) sf[n][e] = NEG_INF;
      }
    }

    // online softmax (base 2), rows g and g+8 of the warp; a row's 4 lanes share it
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n) mx = fmaxf(mx, fmaxf(sf[n][2 * r], sf[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[r], mx);
      const float alpha = exp2f(m_i[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n) {
        sf[n][2 * r] = exp2f(sf[n][2 * r] - m_new);
        sf[n][2 * r + 1] = exp2f(sf[n][2 * r + 1] - m_new);
        sum += sf[n][2 * r] + sf[n][2 * r + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_i[r] = l_i[r] * alpha + sum;
      m_i[r] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        of[n][2 * r] *= alpha;
        of[n][2 * r + 1] *= alpha;
      }
    }

    // dropout on f32 p, after l took the undropped sum
    if (DROP) {
      const int j = kv0 / p.drop.bk;
      const uint32_t c0 = (uint32_t)(kv0 - j * p.drop.bk);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t key = lxt::dropout_block_key(p.drop, b, hk, drop_i[r], j);
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n) {
          const uint32_t c = c0 + n * 8 + t * 2;
          sf[n][2 * r] *= lxt::dropout_keep(p.drop, key, drop_row[r], c);
          sf[n][2 * r + 1] *= lxt::dropout_keep(p.drop, key, drop_row[r], c + 1);
        }
      }
    }

    // O += P V: P (bf16) re-used from the S accumulators as the A operand
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = lxt::pack_bf16(sf[2 * kk][0], sf[2 * kk][1]);
      pa[1] = lxt::pack_bf16(sf[2 * kk][2], sf[2 * kk][3]);
      pa[2] = lxt::pack_bf16(sf[2 * kk + 1][0], sf[2 * kk + 1][1]);
      pa[3] = lxt::pack_bf16(sf[2 * kk + 1][2], sf[2 * kk + 1][3]);
      const int k0 = kk * 16 + t * 2;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + g;
        const uint32_t b0 = lxt::pack_bf16(Vs[k0][col], Vs[k0 + 1][col]);
        const uint32_t b1 = lxt::pack_bf16(Vs[k0 + 8][col], Vs[k0 + 9][col]);
        lxt::mma_bf16_16816(of[n], pa, b0, b1);
      }
    }
  }

  // epilogue: out = acc / l (l == 0 guarded), lse natural-log
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qpos[r];
    if (row >= S) continue;
    const float l = l_i[r];
    const float denom = l == 0.f ? 1.f : l;
    __nv_bfloat16* dst = p.out + ((size_t)b * S + row) * q_row + (size_t)h * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + t * 2;
      *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(of[n][2 * r] / denom, of[n][2 * r + 1] / denom);
    }
    if (t == 0) p.lse[((size_t)b * p.Hq + h) * S + row] = (m_i[r] + log2f(fmaxf(l, 1e-30f))) * LN2;
  }
}

}  // namespace

extern "C" int lxt_flash_attention_fwd(const void* q, const void* k, const void* v, const void* qseg,
                                       const void* kseg, const void* prefix, void* out, void* lse, int B, int S,
                                       int Hq, int Hkv, int D, int causal, float qscale, int dropout,
                                       unsigned int threshold, float keep_scale, unsigned int seed, int bq, int bk,
                                       void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.prefix = static_cast<const int*>(prefix);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.causal = causal;
  p.qscale = qscale;
  p.drop = lxt::Dropout{dropout, threshold, keep_scale, seed, bq > 0 ? bq : 1, bk > 0 ? bk : 1};
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 128 && dropout)
    flash_fwd_kernel<128, true><<<grid, THREADS, 0, st>>>(p);
  else if (D == 128)
    flash_fwd_kernel<128, false><<<grid, THREADS, 0, st>>>(p);
  else if (D == 64 && dropout)
    flash_fwd_kernel<64, true><<<grid, THREADS, 0, st>>>(p);
  else if (D == 64)
    flash_fwd_kernel<64, false><<<grid, THREADS, 0, st>>>(p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
