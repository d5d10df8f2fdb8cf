// K6: the flash probe, a matmul-only attention: out = sum over the needed (i, j) blocks
// of bf16(Q_i K_j^T) V_j with an f32 accumulator. No softmax, no scale on q, no mask
// inside a block: only the whole-block skip of the causal / prefix-LM plan (bq, bk),
//   need(i, j) = (i*bq + bq - 1 >= j*bk) | ((i*bq < prefix) & (j*bk < prefix)).
//
// Replaces the Pallas TPU kernel tools/probe_flash.py:probe_kernel (pallas_call at :125),
// which bounds what the two products of the flash forward cost without its softmax
// chain. Built on the mma.sync loop that K2 had until K2 moved to wgmma, a TMA ring and
// tile classes: the gap between this kernel and K2 now compares two designs and no
// longer isolates what K2's online softmax, masking and rescaling cost.
//
// What bounds it on an H100: the bf16 tensor-core rate, 4*B*Hq*D operations for every
// (q, kv) pair of a needed block at 989 TFLOP/s, against q, k, v, out once (a few tens
// of MB at S 4096).
//
// Design: the earlier K2 loop without the softmax:
// one CTA of 4 warps per (64 query rows, q head, batch row), q fragments in registers
// (raw bf16, not scaled), 64-position kv tiles staged in padded shared memory, S = q k^T
// and O += bf16(S) V as mma.sync m16n8k16 products with f32 accumulators, the S
// accumulators re-used as the A operand of the second product. bq and bk are multiples
// of the 64-row tile and divide S (the wrapper checks), so a tile never straddles a
// block of the plan and the skip is one test per CTA and kv tile.

#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 128;

struct Params {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* out;
  int B, S, Hq, Hkv, bq, bk, prefix;
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_probe_kernel(Params p) {
  constexpr int LD = D + 8;  // padded smem row, elements
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV][LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKV][LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int S = p.S;
  const size_t q_row = (size_t)p.Hq * D, kv_row = (size_t)p.Hkv * D;
  const int q_start = (q0 / p.bq) * p.bq;  // first row of this CTA's q block of the plan

  // this lane's two query rows (g and g+8 of the warp's 16), q fragments as stored
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) qpos[r] = q0 + warp * 16 + g + r * 8;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int col = kk * 16 + t * 2 + (r >> 1) * 8;
      qf[kk][r] = *reinterpret_cast<const uint32_t*>(p.q + ((size_t)b * S + qpos[r & 1]) * q_row + (size_t)h * D + col);
    }
  }

  float of[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) of[n][r] = 0.f;

  for (int kv0 = 0; kv0 < S; kv0 += BKV) {
    const int kv_start = (kv0 / p.bk) * p.bk;
    // whole-block skip, the same for every thread of the CTA
    if (!(q_start + p.bq - 1 >= kv_start || (q_start < p.prefix && kv_start < p.prefix))) continue;
    __syncthreads();  // previous tile's readers are done
    constexpr int CHUNKS = BKV * D / 8;  // 16-byte chunks per tile
#pragma unroll
    for (int i = 0; i < CHUNKS / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int row = c / (D / 8), col = (c % (D / 8)) * 8;
      const size_t off = ((size_t)b * S + kv0 + row) * kv_row + (size_t)hk * D + col;
      *reinterpret_cast<uint4*>(&Ks[row][col]) = *reinterpret_cast<const uint4*>(p.k + off);
      *reinterpret_cast<uint4*>(&Vs[row][col]) = *reinterpret_cast<const uint4*>(p.v + off);
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

    // O += bf16(S) V
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

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* dst = p.out + ((size_t)b * S + qpos[r]) * q_row + (size_t)h * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + t * 2;
      *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(of[n][2 * r], of[n][2 * r + 1]);
    }
  }
}

}  // namespace

// q, out [B, S, Hq, D]; k, v [B, S, Hkv, D], bf16; S a multiple of bq and bk, both
// multiples of 64 (checked by the wrapper).
extern "C" int lxt_flash_probe(const void* q, const void* k, const void* v, void* out, int B, int S, int Hq, int Hkv,
                               int D, int bq, int bk, int prefix, void* stream) {
  if (bq <= 0 || bk <= 0 || bq % BQ || bk % BKV || S % bq || S % bk) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.bq = bq;
  p.bk = bk;
  p.prefix = prefix;
  const dim3 grid(S / BQ, Hq, B);
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    flash_probe_kernel<128><<<grid, THREADS, 0, st>>>(p);
  else if (D == 64)
    flash_probe_kernel<64><<<grid, THREADS, 0, st>>>(p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
