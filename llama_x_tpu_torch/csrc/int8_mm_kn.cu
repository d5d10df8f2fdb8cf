// K4: int8 x int8 GEMM with the right operand in [K, N] layout and a fused
// row-scale x col-scale dequant epilogue:
//   C[m, n] = float(sum_k a[m, k] * b[k, n]) * row_scale[m] * col_scale[n]   (bf16 or f32 out)
//
// Replaces the Pallas TPU kernel llama_x_tpu/ops/int8_mm.py:_kernel as reached
// through int8_mm_dequant_pallas (b in KN layout): the input gradient through every
// frozen int8 projection when LlamaConfig.dynamic_int8_bwd is set
// (llama_x_tpu/ops/int8.py:171-185: a = q(g * w_scale) [tokens, out], b = the stored
// int_data [out, in], col_scale = ones), and one of the fused cross-entropy head's
// GEMMs (llama_x_tpu/ops/cross_entropy.py:81-94, f32 out). The frozen base keeps ONE
// layout for the forward (K1 reads it as [N, K]) and the backward (this kernel reads
// the same bytes as [K, N]); no transposed copy of the 7 GB base exists.
//
// What bounds it on an H100: at the training shapes (M = 4096 tokens) the int8
// tensor-core rate, 2*M*N*K operations at 1979 TOP/s; the bytes (a, b once, C once)
// are a few tens of MB.
//
// Design: K1's tiling (one CTA of 8 warps per 128x128 output tile, K walked in
// 64-row steps through a two-stage cp.async ring, mma.sync m16n8k32 s8 into exact
// int32 accumulators). The trouble is the B fragment: the MMA wants four consecutive
// k of ONE column n in a 32-bit register, and in KN layout those bytes are N apart
// (ldmatrix.trans only transposes 16-bit elements). The [BK][BN] tile is staged as
// it lies in memory; each thread then reads four 32-bit words (rows k..k+3, four
// adjacent columns) and transposes the 4x4 byte block in registers with eight
// byte-permutes (prmt), which yields the fragment words of four columns at once.
// Which column feeds which column slot of an MMA tile is free as long as the
// epilogue agrees: slot g of tile j is column 4g + j of the warp's 32, so a thread
// ends up owning 8 CONSECUTIVE output columns and stores them as one or two 16-byte
// vectors. Bank conflicts: a B tile row is 128 bytes = all 32 banks, so the four
// row groups (t) of a warp would collide four ways; the 16-byte chunks of a row are
// XOR-swizzled with ((row >> 2) & 3) << 1, which puts the eight (column half, t)
// combinations of a warp's read on eight different chunks: conflict-free without
// padding. Cost per 32-deep k step and thread: 8 shared loads + 16 prmt for B
// beside 16 shared loads for A and 16 MMAs.
//
// Sums are exact int32: 127^2 * K must stay below 2^31, i.e. K <= 133144; the
// vocabulary contraction of the Llama-3 head (K = 128256: 2,068,641,024) fits with 4%
// to spare and the wrapper raises beyond. Ragged M and tile-ragged N and K are masked
// by zero-filling cp.async; K and N must be multiples of 16 (16-byte row loads).
// Not yet done (later work): wgmma + TMA, a deeper pipeline.

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDA = BK + 16;  // padded A row, bytes (as K1)
constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;
constexpr int MT = WM / 16, NT = WN / 8;
static_assert(NT == 4, "the 4x4 byte transpose yields the fragments of four 8-column tiles");

template <bool OUT_F32>
__global__ void __launch_bounds__(THREADS) int8_mm_kn_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                                                           const float* __restrict__ rs,
                                                           const float* __restrict__ cs, void* __restrict__ out,
                                                           int M, int N, int K) {
  __shared__ __align__(16) int8_t As[2][BM][LDA];
  __shared__ __align__(16) int8_t Bs[2][BK][BN];  // 16-byte chunks swizzled per row

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < (BM * BK / 16) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int row = c / (BK / 16), col = (c % (BK / 16)) * 16;
      const int gm = m0 + row, gk = k0 + col;
      const bool ok = gm < M && gk < K;
      lxt::cp_async_16(&As[stage][row][col], ok ? a + (size_t)gm * K + gk : a, ok);
    }
#pragma unroll
    for (int i = 0; i < (BK * BN / 16) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int row = c / (BN / 16), chunk = c % (BN / 16);
      const int gk = k0 + row, gn = n0 + chunk * 16;
      const bool ok = gk < K && gn < N;  // N % 16 == 0: a chunk is whole or absent
      const int phys = chunk ^ (((row >> 2) & 3) << 1);
      lxt::cp_async_16(&Bs[stage][row][phys * 16], ok ? b + (size_t)gk * N + gn : b, ok);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // this thread's four adjacent B columns: bytes wn*32 + g*4 .. +3 of a tile row
  const int b_chunk = wn * 2 + (g >> 2), b_word = (g & 3) * 4;

  load_tile(0, 0);
  lxt::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) {
      load_tile(kt + 1, s ^ 1);
      lxt::cp_async_commit();
      lxt::cp_async_wait<1>();
    } else {
      lxt::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * WM + i * 16 + g;
        const int k = ks * 32 + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(&As[s][r][k]);
        af[i][1] = *reinterpret_cast<const uint32_t*>(&As[s][r + 8][k]);
        af[i][2] = *reinterpret_cast<const uint32_t*>(&As[s][r][k + 16]);
        af[i][3] = *reinterpret_cast<const uint32_t*>(&As[s][r + 8][k + 16]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // rows k..k+3 with (row >> 2) & 3 == t, so the swizzle term is t << 1
        const int k = ks * 32 + half * 16 + t * 4;
        const int col = ((b_chunk ^ (t << 1)) << 4) + b_word;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(&Bs[s][k][col]);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(&Bs[s][k + 1][col]);
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(&Bs[s][k + 2][col]);
        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(&Bs[s][k + 3][col]);
        // 4x4 byte transpose: word j = column j's four consecutive k, lowest k in the low byte
        const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
        const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
        bf[0][half] = __byte_perm(t0, t2, 0x5410);
        bf[1][half] = __byte_perm(t0, t2, 0x7632);
        bf[2][half] = __byte_perm(t1, t3, 0x5410);
        bf[3][half] = __byte_perm(t1, t3, 0x7632);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) lxt::mma_s8_16832(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    __syncthreads();
  }

  // epilogue: float(acc) * row_scale * col_scale, in that order (the plain version's).
  // Column slot c of tile j is column 4c + j, so accumulator (j, 2t + e) is column
  // 8t + 4e + j: this thread's 8 consecutive columns.
  const int nb = n0 + wn * WN + t * 8;
  if (nb >= N) return;  // N % 16 == 0: the 8 columns are all inside or all outside
  float csv[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) csv[c] = cs[nb + c];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * WM + i * 16 + g + half * 8;
      if (m >= M) continue;
      const float r = rs[m];
      float v[8];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < NT; ++j) v[4 * e + j] = static_cast<float>(acc[i][j][half * 2 + e]) * r * csv[4 * e + j];
      if (OUT_F32) {
        float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + (size_t)m * N + nb);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        uint4 pk;
        pk.x = lxt::pack_bf16(v[0], v[1]);
        pk.y = lxt::pack_bf16(v[2], v[3]);
        pk.z = lxt::pack_bf16(v[4], v[5]);
        pk.w = lxt::pack_bf16(v[6], v[7]);
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + (size_t)m * N + nb) = pk;
      }
    }
  }
}

}  // namespace

extern "C" int lxt_int8_mm_dequant_kn(const void* a, const void* b, const void* row_scale, const void* col_scale,
                                      void* out, int M, int N, int K, int out_f32, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* b8 = static_cast<const int8_t*>(b);
  const auto* rs = static_cast<const float*>(row_scale);
  const auto* cs = static_cast<const float*>(col_scale);
  if (out_f32)
    int8_mm_kn_kernel<true><<<grid, THREADS, 0, st>>>(a8, b8, rs, cs, out, M, N, K);
  else
    int8_mm_kn_kernel<false><<<grid, THREADS, 0, st>>>(a8, b8, rs, cs, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
