// K8: the chunked SSD scan of a Mamba-2 layer over a span of one row's positions.
//
// No TPU kernel corresponds: the JAX package has no state-space layer. It serves the Mamba-2
// blocks of the hybrid decoder (models/nemotron_h.py) in every prefill chunk and admission of
// serve/continuous.py; ops/ssd.py:ssd_scan_plain is its arithmetic in PyTorch.
//
// Per head h (P = 64 channels, a state of N), its group g = h / (H / G), over T positions:
//   dt_t = softplus(dt_raw_t + dt_bias) for t < length, 0 after (pads leave the state alone)
//   S_t  = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T          (S [P, N], f32)
//   y_t  = S_t C_t + D x_t
// in chunks of Q positions: with cum the chunk's inclusive cumulative sum of dt A,
//   y_t  = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s      (intra: the dual form)
//        + exp(cum_t) S_prev C_t + D x_t                              (inter)
//   S    = exp(cum_last) S_prev + sum_s exp(cum_last - cum_s) dt_s x_s B_s^T
// The state after snap_at positions (1 <= snap_at <= T), where asked, is written to snap_out
// from the chunk that holds that position, in the same pass (the prefix cache's snapshot).
//
// Design: one CTA a head (256 threads), the head's state in registers for the whole span (its
// lane read once, or zeros for a fresh span, and written once at the end): a warp holds 8 of
// its P rows, a lane 4 (N 128) or 8 (N 256) of each row's columns. Each chunk's B, C (the
// group's) and x rows are staged in shared memory as f32 (rows padded by 4 floats, so that a
// quarter-warp's 16-byte reads fall in distinct banks), and three phases run on the CUDA cores:
// the Q x Q decay-weighted C.B products (a thread one); y, whose inter-chunk part each lane
// sums over its own columns and a warp's reduce-scatter over its lanes completes (8 positions
// x 8 rows at a time, 62 shuffles a lane), the intra-chunk part and D x added by the lane that
// ends with the sum; and the state update in registers, each B row read once by a warp (the
// first design kept the state in shared memory and ran at 0.17 of the bound, bound by its
// shared-memory reads; PERF.md).
//
// What bounds it on an H100: the f32 operations, about 2 P N + Q (N + P) multiply-adds a
// position and head (the chunks cut the serial dependence, not the work); its bytes are the
// x, B, C, dt rows read once, y written once and the state read and written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 64;
constexpr int Q = 16;
constexpr int THREADS = 256;  // = Q * Q: one C.B product a thread; 8 warps of 8 state rows

template <int N>
struct Smem {
  float Bs[Q][N + 4];
  float Cs[Q][N + 4];
  float Xs[Q][P + 4];
  float M[Q][Q + 1];
  float dt[Q], cum[Q], w[Q], ws[Q];
};

__device__ __forceinline__ float softplus_f(float v) { return v > 20.f ? v : log1pf(expf(v)); }

__device__ __forceinline__ void unpack8(uint4 r, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

// One halving step of a warp's reduce-scatter: 2 * H values a lane -> H, each the sum over the
// lane and its partner (lane ^ MASK) of the half this lane keeps (the upper one where lane & MASK).
template <int H, int MASK>
__device__ __forceinline__ void halve(float* v, int lane) {
  const bool upper = lane & MASK;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_scan_kernel(const __nv_bfloat16* __restrict__ xbc, const __nv_bfloat16* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ D, const float* __restrict__ dt_bias,
                    float* __restrict__ state, const int64_t* __restrict__ slot, const int64_t* __restrict__ length,
                    const int64_t* __restrict__ snap_at, float* __restrict__ snap_out, float* __restrict__ y, int T,
                    int H, int G, int dt_stride, int fresh) {
  constexpr int J = N / 128;  // a lane's float4 columns of each state row
  extern __shared__ __align__(16) unsigned char raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(raw);
  const int h = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = h / (H / G);
  const int width = H * P + 2 * G * N;
  const long long len_ll = *length;
  const int len = len_ll < T ? static_cast<int>(len_ll) : T;
  const int snap = snap_at != nullptr ? static_cast<int>(*snap_at) : -1;
  float* Sg = state + (static_cast<size_t>(*slot) * H + h) * static_cast<size_t>(P) * N;
  const float Ah = A[h], Dh = D[h], bias = dt_bias[h];
  const int p0 = 8 * warp;  // this warp's 8 state rows; this lane's columns 4 lane + 128 j + (0..3)

  float4 S[8][J];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < J; ++j)
      S[r][j] = fresh ? make_float4(0.f, 0.f, 0.f, 0.f)
                      : *reinterpret_cast<const float4*>(Sg + static_cast<size_t>(p0 + r) * N + 4 * lane + 128 * j);

  for (int c0 = 0; c0 < T; c0 += Q) {
    const int q = min(Q, T - c0);
    __syncthreads();  // the last chunk's readers are done with the staged rows
    for (int i = tid; i < Q * N / 8; i += THREADS) {
      const int t = i / (N / 8), n = (i % (N / 8)) * 8;
      float vb[8], vc[8];
      if (t < q) {
        const __nv_bfloat16* row = xbc + static_cast<size_t>(c0 + t) * width + H * P;
        unpack8(*reinterpret_cast<const uint4*>(row + g * N + n), vb);
        unpack8(*reinterpret_cast<const uint4*>(row + G * N + g * N + n), vc);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) vb[k] = vc[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; k += 4) {
        *reinterpret_cast<float4*>(&sm.Bs[t][n + k]) = make_float4(vb[k], vb[k + 1], vb[k + 2], vb[k + 3]);
        *reinterpret_cast<float4*>(&sm.Cs[t][n + k]) = make_float4(vc[k], vc[k + 1], vc[k + 2], vc[k + 3]);
      }
    }
    for (int i = tid; i < Q * P / 8; i += THREADS) {
      const int t = i / (P / 8), p = (i % (P / 8)) * 8;
      float vx[8];
      if (t < q) {
        unpack8(*reinterpret_cast<const uint4*>(xbc + static_cast<size_t>(c0 + t) * width + h * P + p), vx);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) vx[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) sm.Xs[t][p + k] = vx[k];
    }
    if (tid < 32) {  // dt, and its cumulative sum times A over the chunk (one warp's scan)
      const int t = c0 + tid;
      float d = 0.f;
      if (tid < q && t < len) d = softplus_f(__bfloat162float(dt[static_cast<size_t>(t) * dt_stride + h]) + bias);
      float a = tid < Q ? d * Ah : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, a, o);
        if (tid >= o) a += v;
      }
      const float last = __shfl_sync(0xffffffffu, a, Q - 1);
      const int r = snap - c0;  // the snapshot's position count inside this chunk
      const float at_r = __shfl_sync(0xffffffffu, a, max(0, min(Q, r) - 1));
      if (tid < Q) {
        sm.dt[tid] = d;
        sm.cum[tid] = a;
        sm.w[tid] = expf(last - a) * d;
        sm.ws[tid] = tid < r ? expf(at_r - a) * d : 0.f;
      }
    }
    __syncthreads();
    {  // M[t][s] = (C_t . B_s) exp(cum_t - cum_s) dt_s, s <= t
      const int t = tid / Q, s = tid % Q;
      float acc = 0.f;
      if (s <= t) {
        const float4* cr = reinterpret_cast<const float4*>(&sm.Cs[t][0]);
        const float4* br = reinterpret_cast<const float4*>(&sm.Bs[s][0]);
#pragma unroll 8
        for (int n = 0; n < N / 4; ++n) acc = dot4(cr[n], br[n], acc);
        acc *= expf(sm.cum[t] - sm.cum[s]) * sm.dt[s];
      }
      sm.M[t][s] = acc;
    }
    __syncthreads();
    // y: the inter-chunk part C_t S^T from the state in registers, reduced over the warp's lanes
    // (a reduce-scatter leaves lane L the rows p0 + 2 (L & 3) + {0, 1} of position (L >> 2)
    // of each half of the chunk), then the intra-chunk part and D x
#pragma unroll 1
    for (int tb = 0; tb < Q; tb += 8) {
      float v[64];
#pragma unroll
      for (int tt = 0; tt < 8; ++tt) {
        float4 c[J];
#pragma unroll
        for (int j = 0; j < J; ++j) c[j] = *reinterpret_cast<const float4*>(&sm.Cs[tb + tt][4 * lane + 128 * j]);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < J; ++j) acc = dot4(c[j], S[r][j], acc);
          v[tt * 8 + r] = acc;
        }
      }
      halve<32, 16>(v, lane);
      halve<16, 8>(v, lane);
      halve<8, 4>(v, lane);
      halve<4, 2>(v, lane);
      halve<2, 1>(v, lane);
      const int t = tb + (lane >> 2), p = p0 + 2 * (lane & 3);
      if (t < q) {
        float i0 = 0.f, i1 = 0.f;
        for (int s = 0; s <= t; ++s) {
          const float m = sm.M[t][s];
          i0 = fmaf(m, sm.Xs[s][p], i0);
          i1 = fmaf(m, sm.Xs[s][p + 1], i1);
        }
        const float e = expf(sm.cum[t]);
        *reinterpret_cast<float2*>(y + (static_cast<size_t>(c0 + t) * H + h) * P + p) =
            make_float2(i0 + e * v[0] + Dh * sm.Xs[t][p], i1 + e * v[1] + Dh * sm.Xs[t][p + 1]);
      }
    }
    // the snapshot (the state after snap positions, from this chunk's start state), then the update
    if (snap > c0 && snap <= c0 + q) {
      const float sd = expf(sm.cum[snap - c0 - 1]);
      float* out = snap_out + (static_cast<size_t>(h) * P + p0) * N;
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          float4 sn = make_float4(sd * S[r][j].x, sd * S[r][j].y, sd * S[r][j].z, sd * S[r][j].w);
          for (int s = 0; s < Q; ++s) {
            const float xw = sm.Xs[s][p0 + r] * sm.ws[s];
            const float4 b = *reinterpret_cast<const float4*>(&sm.Bs[s][4 * lane + 128 * j]);
            sn.x = fmaf(xw, b.x, sn.x);
            sn.y = fmaf(xw, b.y, sn.y);
            sn.z = fmaf(xw, b.z, sn.z);
            sn.w = fmaf(xw, b.w, sn.w);
          }
          *reinterpret_cast<float4*>(out + static_cast<size_t>(r) * N + 4 * lane + 128 * j) = sn;
        }
    }
    const float decay = expf(sm.cum[Q - 1]);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < J; ++j)
        S[r][j] = make_float4(decay * S[r][j].x, decay * S[r][j].y, decay * S[r][j].z, decay * S[r][j].w);
#pragma unroll 2
    for (int s = 0; s < Q; ++s) {
      const float ws = sm.w[s];
      const float4 x0 = *reinterpret_cast<const float4*>(&sm.Xs[s][p0]);
      const float4 x1 = *reinterpret_cast<const float4*>(&sm.Xs[s][p0 + 4]);
      const float xw[8] = {x0.x * ws, x0.y * ws, x0.z * ws, x0.w * ws, x1.x * ws, x1.y * ws, x1.z * ws, x1.w * ws};
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(&sm.Bs[s][4 * lane + 128 * j]);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          S[r][j].x = fmaf(xw[r], b.x, S[r][j].x);
          S[r][j].y = fmaf(xw[r], b.y, S[r][j].y);
          S[r][j].z = fmaf(xw[r], b.z, S[r][j].z);
          S[r][j].w = fmaf(xw[r], b.w, S[r][j].w);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < J; ++j)
      *reinterpret_cast<float4*>(Sg + static_cast<size_t>(p0 + r) * N + 4 * lane + 128 * j) = S[r][j];
}

template <int N>
int launch(const void* xbc, const void* dt, const float* A, const float* D, const float* dt_bias, float* state,
           const int64_t* slot, const int64_t* length, const int64_t* snap_at, float* snap_out, float* y, int T,
           int H, int G, int dt_stride, int fresh, cudaStream_t st) {
  const size_t smem = sizeof(Smem<N>);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<N><<<H, THREADS, smem, st>>>(static_cast<const __nv_bfloat16*>(xbc),
                                               static_cast<const __nv_bfloat16*>(dt), A, D, dt_bias, state, slot,
                                               length, snap_at, snap_out, y, T, H, G, dt_stride, fresh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lxt_ssd_scan(const void* xbc, const void* dt, const void* A, const void* D, const void* dt_bias,
                            void* state, const void* slot, const void* length, const void* snap_at, void* snap_out,
                            void* y, int T, int H, int G, int N, int dt_stride, int lanes, int fresh, void* stream) {
  if (T < 1 || H < 1 || G < 1 || H % G || lanes < 1 || (snap_at == nullptr) != (snap_out == nullptr) ||
      reinterpret_cast<uintptr_t>(xbc) % 16 || reinterpret_cast<uintptr_t>(state) % 16 ||
      reinterpret_cast<uintptr_t>(snap_out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto i = [](const void* p) { return static_cast<const int64_t*>(p); };
  if (N == 256)
    return launch<256>(xbc, dt, f(A), f(D), f(dt_bias), static_cast<float*>(state), i(slot), i(length), i(snap_at),
                       static_cast<float*>(snap_out), static_cast<float*>(y), T, H, G, dt_stride, fresh, st);
  if (N == 128)
    return launch<128>(xbc, dt, f(A), f(D), f(dt_bias), static_cast<float*>(state), i(slot), i(length), i(snap_at),
                       static_cast<float*>(snap_out), static_cast<float*>(y), T, H, G, dt_stride, fresh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
