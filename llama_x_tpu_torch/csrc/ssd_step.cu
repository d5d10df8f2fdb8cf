// K9: one decode token of a Mamba-2 layer for every slot: the conv step and the SSD update.
//
// No TPU kernel corresponds: the JAX package has no state-space layer. It serves the Mamba-2
// blocks of the hybrid decoder (models/nemotron_h.py) in every decode step of
// serve/continuous.py; ops/ssd.py:ssd_step_plain is its arithmetic in PyTorch.
//
// For slot b (skipped where done[b]: its lanes stay as they are and y reads 0) and head h, its
// group g = h / (H / G):
//   a    = SiLU(conv_b + sum_k conv_w[:, k] win[k]), win = the lane's last K - 1 inputs and the
//          new one (f32 products and sums in tap order), rounded to bf16: x (the head's P
//          channels), B and C (the group's N each)
//   dt   = softplus(dt_raw + dt_bias); S <- exp(dt A) S + dt x B^T; y = S C + D x
//   the conv lane shifts by one input.
// The conv lane's x channels belong to one head and are written by its CTA; B and C belong to
// the group's H / G heads, each CTA of which reads them: the group's last CTA to arrive (an
// atomic counter a (slot, group), reset by that CTA) writes them.
//
// ``stepped`` (where given) counts the lanes stepped, one a live slot a launch: the bytes that
// a launch moved, for its roofline.
//
// Design: one CTA a (head, slot), 256 threads; a warp holds 8 of the head's 64 state rows, a
// lane 4 or 8 columns of each (16-byte loads, all issued before the first use); the row's
// y is a warp reduction. What bounds it on an H100: bytes, the f32 state read and written once
// (P N 8 bytes a head and slot).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 64;
constexpr int K = 4;
constexpr int THREADS = 256;

__device__ __forceinline__ float softplus_f(float v) { return v > 20.f ? v : log1pf(expf(v)); }

template <int N>
__global__ void __launch_bounds__(THREADS)
    ssd_step_kernel(const __nv_bfloat16* __restrict__ xbc, const __nv_bfloat16* __restrict__ dt,
                    const __nv_bfloat16* __restrict__ conv_w, const __nv_bfloat16* __restrict__ conv_b,
                    const float* __restrict__ A, const float* __restrict__ D, const float* __restrict__ dt_bias,
                    __nv_bfloat16* __restrict__ conv_state, float* __restrict__ state, const bool* __restrict__ done,
                    int* __restrict__ counters, unsigned long long* __restrict__ stepped, float* __restrict__ y,
                    int H, int G, int xbc_stride, int dt_stride) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int rep = H / G, g = h / rep;
  const int C = H * P + 2 * G * N;
  float* yb = y + (static_cast<size_t>(b) * H + h) * P;
  if (done != nullptr && done[b]) {
    if (tid < P) yb[tid] = 0.f;
    return;
  }
  __shared__ __align__(16) float xs[P];
  __shared__ __align__(16) float bs[N];
  __shared__ __align__(16) float cs[N];
  __shared__ __nv_bfloat16 shifted[2 * N][K - 1];  // the group's B and C lanes, shifted by one input
  __shared__ float dts;
  __shared__ int last;

  __nv_bfloat16* lane = conv_state + static_cast<size_t>(b) * (K - 1) * C;
  const __nv_bfloat16* in = xbc + static_cast<size_t>(b) * xbc_stride;
  for (int k = tid; k < P + 2 * N; k += THREADS) {
    const int ch = k < P ? h * P + k : (k < P + N ? H * P + g * N + (k - P) : H * P + G * N + g * N + (k - P - N));
    __nv_bfloat16 win[K];
#pragma unroll
    for (int j = 0; j < K - 1; ++j) win[j] = lane[static_cast<size_t>(j) * C + ch];
    win[K - 1] = in[ch];
    float acc = __bfloat162float(conv_b[ch]);
#pragma unroll
    for (int j = 0; j < K; ++j)
      acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(conv_w[ch * K + j]), __bfloat162float(win[j])));
    const float a = __bfloat162float(__float2bfloat16_rn(acc / (1.f + expf(-acc))));
    if (k < P) {
      xs[k] = a;
#pragma unroll
      for (int j = 0; j < K - 1; ++j) lane[static_cast<size_t>(j) * C + ch] = win[j + 1];
    } else {
      (k < P + N ? bs[k - P] : cs[k - P - N]) = a;
#pragma unroll
      for (int j = 0; j < K - 1; ++j) shifted[k - P][j] = win[j + 1];
    }
  }
  if (tid == 0 && h == 0 && stepped != nullptr) atomicAdd(stepped, 1ull);
  if (tid == 0) dts = softplus_f(__bfloat162float(dt[static_cast<size_t>(b) * dt_stride + h]) + dt_bias[h]);
  __syncthreads();
  if (tid == 0) {  // every CTA of the group has read its B and C lanes once the count reaches rep
    __threadfence();
    const int seen = atomicAdd(&counters[b * G + g], 1);
    last = seen == rep - 1;
    if (last) counters[b * G + g] = 0;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    for (int k = tid; k < 2 * N; k += THREADS) {
      const int ch = k < N ? H * P + g * N + k : H * P + G * N + g * N + (k - N);
#pragma unroll
      for (int j = 0; j < K - 1; ++j) lane[static_cast<size_t>(j) * C + ch] = shifted[k][j];
    }
  }

  const float d = dts, dA = expf(d * A[h]);
  float* Sg = state + (static_cast<size_t>(b) * H + h) * static_cast<size_t>(P) * N;
  const int warp = tid / 32, ln = tid % 32;
  constexpr int J = N / 128;
  float4 sv[8][J];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < J; ++j)
      sv[r][j] = *reinterpret_cast<const float4*>(Sg + static_cast<size_t>(warp * 8 + r) * N + 4 * ln + 128 * j);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int p = warp * 8 + r;
    const float xd = d * xs[p];
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int n = 4 * ln + 128 * j;
      const float4 bb = *reinterpret_cast<const float4*>(&bs[n]);
      const float4 cc = *reinterpret_cast<const float4*>(&cs[n]);
      float4 s = sv[r][j];
      s.x = fmaf(dA, s.x, xd * bb.x);
      s.y = fmaf(dA, s.y, xd * bb.y);
      s.z = fmaf(dA, s.z, xd * bb.z);
      s.w = fmaf(dA, s.w, xd * bb.w);
      *reinterpret_cast<float4*>(Sg + static_cast<size_t>(p) * N + n) = s;
      part = fmaf(s.x, cc.x, fmaf(s.y, cc.y, fmaf(s.z, cc.z, fmaf(s.w, cc.w, part))));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (ln == 0) yb[p] = part + D[h] * xs[p];
  }
}

template <int N>
int launch(const void* xbc, const void* dt, const void* conv_w, const void* conv_b, const float* A, const float* D,
           const float* dt_bias, void* conv_state, float* state, const bool* done, int* counters,
           unsigned long long* stepped, float* y, int B, int H, int G, int xbc_stride, int dt_stride, cudaStream_t st) {
  auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  ssd_step_kernel<N><<<dim3(H, B), THREADS, 0, st>>>(bf(xbc), bf(dt), bf(conv_w), bf(conv_b), A, D, dt_bias,
                                                     static_cast<__nv_bfloat16*>(conv_state), state, done, counters,
                                                     stepped, y, H, G, xbc_stride, dt_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lxt_ssd_step(const void* xbc, const void* dt, const void* conv_w, const void* conv_b, const void* A,
                            const void* D, const void* dt_bias, void* conv_state, void* state, const void* done,
                            void* counters, void* stepped, void* y, int B, int H, int G, int N, int xbc_stride,
                            int dt_stride, void* stream) {
  if (B < 1 || H < 1 || G < 1 || H % G || B > 65535 || reinterpret_cast<uintptr_t>(state) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto done_p = static_cast<const bool*>(done);
  if (N == 256)
    return launch<256>(xbc, dt, conv_w, conv_b, f(A), f(D), f(dt_bias), conv_state, static_cast<float*>(state), done_p,
                       static_cast<int*>(counters), static_cast<unsigned long long*>(stepped), static_cast<float*>(y), B,
                       H, G, xbc_stride, dt_stride, st);
  if (N == 128)
    return launch<128>(xbc, dt, conv_w, conv_b, f(A), f(D), f(dt_bias), conv_state, static_cast<float*>(state), done_p,
                       static_cast<int*>(counters), static_cast<unsigned long long*>(stepped), static_cast<float*>(y), B,
                       H, G, xbc_stride, dt_stride, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
