// One bare wgmma product through the building blocks of hopper.cuh, so that a card test
// can hold the tensor maps, the 128-byte swizzle, both descriptor forms and the register
// layouts against torch.matmul before they meet in the flash kernels (K2, K5) and K1:
//   K-major:  C[64, N] = A[64, 64] B[N, 64]^T, A and B from shared memory (wgmma_ss);
//   MN-major: C[64, N] = A[64, 64] B[64, N], A from registers in the layout that an
//             accumulator repacks into, B read MN-major from shared memory (wgmma_rs);
//   int8:     C[64, N] = A[64, 128] B[N, 128]^T in s32, both K-major from shared memory
//             through 2-D tensor maps (wgmma_ss_s8, K1's product), N 128 or 256;
//   int8, A from registers: C[64 n, N m] = sum_k b[k, n] a[m, k] for b int8 [128 k, 128 n]
//             and a int8 [N, 128] (wgmma_rs_s8, K4's product, n 0..63), with b^T in
//             registers either in the documented m16n8k32 A layout, gathered from global
//             memory byte by byte (the bare instruction), or built by K4's kn_fragment
//             from b's TMA box (K4's transpose and its row map), N 128 or 256.
// One CTA of one warpgroup; A and B arrive by TMA; N is 64 or 128 for bf16.

#include "hopper.cuh"

namespace {

template <int N>
__global__ void __launch_bounds__(128)
    wgmma_check_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                       const __nv_bfloat16* a, float* c, int b_mn_major) {
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* bs = as + 64 * 64;
  uint64_t* bar = reinterpret_cast<uint64_t*>(bs + 64 * N);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;

  if (tid == 0) {
    lxt::mbar_init(bar, 1);
    lxt::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    lxt::mbar_arrive_expect_tx(bar, (64 * 64 + N * 64) * 2);
    lxt::tma_load_tile<64, 64>(as, &ta, bar, 0, 0, 0);
    if (b_mn_major)
      lxt::tma_load_tile<N, 64>(bs, &tb, bar, 0, 0, 0);
    else
      lxt::tma_load_tile<64, N>(bs, &tb, bar, 0, 0, 0);
  }
  lxt::mbar_wait(bar, 0);

  // A in registers (rows 16 warp + g and + 8), for the MN-major form
  uint32_t af[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const __nv_bfloat16* src = a + (warp * 16 + g + (r & 1) * 8) * 64 + kk * 16 + (r >> 1) * 8 + q * 2;
      af[kk][r] = lxt::pack_bf16(src[0], src[1]);
    }
  }
  float d[N / 2];
  lxt::fence_regs(af);
  lxt::wgmma_fence();
  if (b_mn_major) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) lxt::wgmma_rs<N>(d, af[kk], lxt::desc_mn_major<64>(bs, kk * 16), kk > 0);
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      lxt::wgmma_ss<N>(d, lxt::desc_k_major<64>(as, kk * 16), lxt::desc_k_major<N>(bs, kk * 16), kk > 0);
  }
  lxt::wgmma_commit();
  lxt::wgmma_wait<0>();
  lxt::fence_regs(d);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[(warp * 16 + g + (e >> 1) * 8) * N + i * 8 + q * 2 + (e & 1)] = d[4 * i + e];
  }
}

template <int N>
int launch(const void* a, const void* b, void* c, int b_mn_major, cudaStream_t st) {
  CUtensorMap ta, tb;
  const bool ok = lxt::make_bshd_map(&ta, a, 1, 64, 1, 64, 64) &&
                  (b_mn_major ? lxt::make_bshd_map(&tb, b, 1, 64, 1, N, 64) : lxt::make_bshd_map(&tb, b, 1, N, 1, 64, N));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = (64 * 64 + 64 * N) * 2 + 8 + 1024;
  cudaError_t err = cudaFuncSetAttribute(wgmma_check_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_check_kernel<N><<<1, 128, bytes, st>>>(ta, tb, static_cast<const __nv_bfloat16*>(a), static_cast<float*>(c),
                                               b_mn_major);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
__global__ void __launch_bounds__(128)
    wgmma_check_s8_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, int* c) {
  extern __shared__ unsigned char smem_raw[];
  int8_t* as = reinterpret_cast<int8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int8_t* bs = as + 64 * 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(bs + N * 128);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  if (tid == 0) {
    lxt::mbar_init(bar, 1);
    lxt::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    lxt::mbar_arrive_expect_tx(bar, (64 + N) * 128);
    lxt::tma_load_2d(as, &ta, bar, 0, 0);
    lxt::tma_load_2d(bs, &tb, bar, 0, 0);
  }
  lxt::mbar_wait(bar, 0);
  int d[N / 2];
  lxt::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    lxt::wgmma_ss_s8<N>(d, lxt::desc_sw128(as + 32 * kk, 16, 1024), lxt::desc_sw128(bs + 32 * kk, 16, 1024), kk > 0);
  lxt::wgmma_commit();
  lxt::wgmma_wait<0>();
  lxt::fence_regs(d);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[(warp * 16 + g + (e >> 1) * 8) * N + i * 8 + q * 2 + (e & 1)] = d[4 * i + e];
  }
}

template <int N>
int launch_s8(const void* a, const void* b, void* c, cudaStream_t st) {
  CUtensorMap ta, tb;
  if (!lxt::make_u8_2d_map(&ta, a, 64, 128, 64) || !lxt::make_u8_2d_map(&tb, b, N, 128, N))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = (64 + N) * 128 + 8 + 1024;
  cudaError_t err = cudaFuncSetAttribute(wgmma_check_s8_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_check_s8_kernel<N><<<1, 128, bytes, st>>>(ta, tb, static_cast<int*>(c));
  return static_cast<int>(cudaGetLastError());
}

template <int N>
__global__ void __launch_bounds__(128)
    wgmma_check_s8_rs_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                             const int8_t* b, int* c, int canonical) {
  extern __shared__ unsigned char smem_raw[];
  int8_t* as = reinterpret_cast<int8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int8_t* bs = as + N * 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(bs + 128 * 128);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  if (tid == 0) {
    lxt::mbar_init(bar, 1);
    lxt::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    lxt::mbar_arrive_expect_tx(bar, (N + 128) * 128);
    lxt::tma_load_2d(as, &ta, bar, 0, 0);
    lxt::tma_load_2d(bs, &tb, bar, 0, 0);
  }
  lxt::mbar_wait(bar, 0);
  uint32_t af[4][4];
  if (canonical) {  // register r: row 16 warp + g + 8 (r & 1), k 4q + 16 (r >> 1) + byte
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = warp * 16 + g + 8 * (r & 1), k = kk * 32 + 4 * q + 16 * (r >> 1);
        uint32_t w = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) w |= (uint32_t)(uint8_t)b[(k + j) * 128 + row] << (8 * j);
        af[kk][r] = w;
      }
  } else {
    uint32_t sel0, sel1;
    lxt::kn_selectors(lane, sel0, sel1);
    const int8_t* row = bs + lxt::kn_row_offset(lane, warp);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) lxt::kn_fragment(af[kk], row, kk, sel0, sel1);
  }
  int d[N / 2];
  lxt::fence_regs(af);
  lxt::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) lxt::wgmma_rs_s8<N>(d, af[kk], lxt::desc_sw128(as + 32 * kk, 16, 1024), kk > 0);
  lxt::wgmma_commit();
  lxt::wgmma_wait<0>();
  lxt::fence_regs(d);
  lxt::fence_regs(af);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // fragment row 16 warp + g (+ 8) is n 16 warp + g (+ 8) as gathered, n 16 warp + 2g (+ 1) as K4 builds it
      const int n = canonical ? warp * 16 + g + 8 * (e >> 1) : warp * 16 + 2 * g + (e >> 1);
      c[n * N + i * 8 + q * 2 + (e & 1)] = d[4 * i + e];
    }
  }
}

template <int N>
int launch_s8_rs(const void* a, const void* b, void* c, int canonical, cudaStream_t st) {
  CUtensorMap ta, tb;
  if (!lxt::make_u8_2d_map(&ta, a, N, 128, N) || !lxt::make_u8_2d_map(&tb, b, 128, 128, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = (N + 128) * 128 + 8 + 1024;
  cudaError_t err =
      cudaFuncSetAttribute(wgmma_check_s8_rs_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_check_s8_rs_kernel<N><<<1, 128, bytes, st>>>(ta, tb, static_cast<const int8_t*>(b), static_cast<int*>(c),
                                                     canonical);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: bf16 [64, 64]; b: bf16 [n, 64] (K-major) or [64, n] (MN-major); c: f32 [64, n]; n 64 or 128
extern "C" int lxt_wgmma_check(const void* a, const void* b, void* c, int n, int b_mn_major, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (n == 64) return launch<64>(a, b, c, b_mn_major, st);
  if (n == 128) return launch<128>(a, b, c, b_mn_major, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// a: int8 [64, 128]; b: int8 [n, 128]; c: int32 [64, n] = a b^T; n 128 or 256
extern "C" int lxt_wgmma_check_s8(const void* a, const void* b, void* c, int n, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (n == 128) return launch_s8<128>(a, b, c, st);
  if (n == 256) return launch_s8<256>(a, b, c, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// a: int8 [n, 128] ([m, k]); b: int8 [128, 128] ([k, n as stored]); c: int32 [64, n] =
// b[:, :64]^T a^T; n 128 or 256; canonical: 1 gathers the register operand in the
// documented layout, 0 builds it as K4 does
extern "C" int lxt_wgmma_check_s8_rs(const void* a, const void* b, void* c, int n, int canonical, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (n == 128) return launch_s8_rs<128>(a, b, c, canonical, st);
  if (n == 256) return launch_s8_rs<256>(a, b, c, canonical, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
