// K7: rowwise symmetric int8 quantization, one pass over each row.
//
// Replaces the plain PyTorch chain of ops/int8.py:quantize_rows_plain (a cast to f32, abs,
// amax, the scale, the clamp, the divide, round and the cast to int8: eight kernels, most
// of them through an f32 copy of the rows) that runs before every K1 and K4 launch of the
// int8 paths (each projection's input, each input gradient, the int8 head and its dlogits)
// and on the int8 KV cache's new rows (models/llama.py:quantize_kv_rows). No TPU kernel
// corresponds: the JAX package leaves the same arithmetic to XLA
// (llama_x_tpu/ops/int8.py:quantize_int8_rowwise).
//
// What it computes, bit for bit with that chain on the card:
//   y     = x, or x * s[col] rounded to x's dtype (the backward's weight scale and the CE
//           head's vocabulary scale, folded in before the rounding of g as before);
//   amax  = max |y| over the row (NaN-propagating, as torch.amax);
//   scale = amax * RN(1 / 127): PyTorch divides a CUDA tensor by a Python scalar as a
//           multiply by the scalar's f32 reciprocal (div_true_kernel_cuda);
//   q     = rint(y / max(scale, 1e-12)), the quotient IEEE-rounded as the chain's
//           tensor-by-tensor divide, the rounding half to even (torch.round);
//   the scale stored in x's dtype (round to nearest even) or in f32 (the KV cache's).
// The quotient is the correctly rounded one without a divide instruction: with r = RN(1/d)
// (__frcp_rn, once a row), q0 = RN(y r), e = y - q0 d (exact in one fma) and q = RN(q0 + e r)
// is RN(y / d) whenever y / d neither overflows nor underflows (Markstein's theorem; a
// quotient that underflows gives the code 0 either way). rint(q) is the low byte of
// q + 1.5 * 2^23, rounded to nearest even by the add, for |q| <= 2^22. A row holding an
// inf or a NaN gets the chain's inf or NaN scale; its codes are not held to the chain's.
//
// What bounds it on an H100: bytes. Each row is read once and its codes and scale written
// once: 3 bytes an element for bf16 rows (the chain moves about 39), 5 for f32 rows. With
// __fdiv_rn and __float2int_rn (a divide routine and a quarter-rate conversion an element)
// the instructions bound it instead, at 0.24-0.40 of the bytes' bound on the training
// shapes (PERF.md).
//
// Design: one algorithm whose group of threads a row adapts to the shape: 32, 64, 128 or 256
// threads, 256 / group rows to a CTA of 256, the fewest that take a row's loads in the spans
// the caller asks for (ops/int8.py:quantize_rows_plan). A thread keeps HOLD = 2 loads of 16
// bytes (or single elements where the row is not 16-byte aligned) in registers: few registers
// keep enough CTAs on an SM to have the bytes in flight. A row of at most HOLD x group loads
// is read once; a wider one streams the rest of its loads through the reduction and reads
// them again for the codes (from L2: a row is 2-28 KB at the training widths). The group's
// absmax is reduced by warp shuffles and through shared memory across the group's warps.
//
// Rows split over ranks (tensor parallelism: each rank holds a slice of every row) take two
// launches, with the max all-reduce of the absmax between them: the absmax pass (ABSMAX)
// writes each row slice's absmax in f32, and the codes pass (CODES) takes the row's whole
// absmax from there in place of its own reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int HOLD = 2;  // loads a thread keeps in registers

// what a launch does: the whole quantization, the absmax pass alone, or the codes pass alone
enum Pass { WHOLE = 0, ABSMAX = 1, CODES = 2 };

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// x * s rounded to x's dtype, as PyTorch's elementwise multiply rounds it (f32 opmath)
__device__ __forceinline__ float scaled(float x, float s) { return __fmul_rn(x, s); }
__device__ __forceinline__ __nv_bfloat16 scaled(__nv_bfloat16 x, __nv_bfloat16 s) {
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(x), __bfloat162float(s)));
}

__device__ __forceinline__ void store_scale(float* p, float s) { *p = s; }
__device__ __forceinline__ void store_scale(__nv_bfloat16* p, float s) { *p = __float2bfloat16_rn(s); }

// max that returns NaN where either side is NaN (torch.amax propagates it; fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load(const T* __restrict__ row, const T* __restrict__ col_scale, int v) {
  Vec<T, VEC> a = *reinterpret_cast<const Vec<T, VEC>*>(row + (size_t)v * VEC);
  if (col_scale != nullptr) {
    const Vec<T, VEC> s = *reinterpret_cast<const Vec<T, VEC>*>(col_scale + (size_t)v * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) a.v[e] = scaled(a.v[e], s.v[e]);
  }
  return a;
}

template <typename T, int VEC>
__device__ __forceinline__ float absmax(float m, const Vec<T, VEC>& a) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) m = max_nan(m, fabsf(to_f32(a.v[e])));
  return m;
}

// the code of y / d as the low byte of a word (r = RN(1 / d))
__device__ __forceinline__ uint32_t code_byte(float y, float d, float r) {
  const float q0 = __fmul_rn(y, r);
  const float q = __fmaf_rn(__fmaf_rn(-q0, d, y), r, q0);
  return __float_as_uint(__fadd_rn(q, 12582912.0f));
}

template <typename T, int VEC>
__device__ __forceinline__ void put_codes(int8_t* __restrict__ qrow, int v, const Vec<T, VEC>& a, float d, float r) {
  if constexpr (VEC == 1) {
    qrow[v] = static_cast<int8_t>(code_byte(to_f32(a.v[0]), d, r) & 0xFFu);
  } else {
    uint32_t w[VEC / 4];
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) {
      const uint32_t b0 = code_byte(to_f32(a.v[4 * j]), d, r), b1 = code_byte(to_f32(a.v[4 * j + 1]), d, r);
      const uint32_t b2 = code_byte(to_f32(a.v[4 * j + 2]), d, r), b3 = code_byte(to_f32(a.v[4 * j + 3]), d, r);
      w[j] = __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
    }
    if constexpr (VEC == 8) *reinterpret_cast<uint2*>(qrow + (size_t)v * 8) = make_uint2(w[0], w[1]);
    else *reinterpret_cast<uint32_t*>(qrow + (size_t)v * 4) = w[0];
  }
}

// T: x's dtype; S: the scale's; VEC: elements a load; GROUP: threads a row (32 to THREADS)
template <typename T, typename S, int VEC, int GROUP>
__global__ void __launch_bounds__(THREADS)
    quantize_rows_kernel(const T* __restrict__ x, const T* __restrict__ col_scale, int8_t* __restrict__ q,
                         S* __restrict__ scale, float* __restrict__ amax, int R, int C, int pass) {
  constexpr int SPAN = HOLD * GROUP;
  const int lane = threadIdx.x % GROUP;
  const int row = blockIdx.x * (THREADS / GROUP) + threadIdx.x / GROUP;
  const bool live = row < R;  // a CTA's last rows may lie past R; they still meet its barrier
  const T* xr = x + (long long)(live ? row : 0) * C;
  int8_t* qr = q + (long long)row * C;
  const int nvec = live ? C / VEC : 0;

  Vec<T, VEC> held[HOLD];
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < HOLD; ++k) {
    const int v = lane + k * GROUP;
    if (v < nvec) held[k] = load<T, VEC>(xr, col_scale, v);
  }
  if (pass != CODES) {  // one value for the whole launch: every thread meets the barrier or none
#pragma unroll
    for (int k = 0; k < HOLD; ++k)
      if (lane + k * GROUP < nvec) m = absmax(m, held[k]);
    for (int base = SPAN; base < nvec; base += SPAN) {  // a row wider than the registers hold
      Vec<T, VEC> t[HOLD];
#pragma unroll
      for (int k = 0; k < HOLD; ++k) {
        const int v = base + lane + k * GROUP;
        if (v < nvec) t[k] = load<T, VEC>(xr, col_scale, v);
      }
#pragma unroll
      for (int k = 0; k < HOLD; ++k)
        if (base + lane + k * GROUP < nvec) m = absmax(m, t[k]);
    }

#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
    if constexpr (GROUP > 32) {
      __shared__ float warp_max[THREADS / 32];
      if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
      __syncthreads();
      const int first = threadIdx.x / GROUP * (GROUP / 32);
      m = warp_max[first];
#pragma unroll
      for (int w = 1; w < GROUP / 32; ++w) m = max_nan(m, warp_max[first + w]);
    }
  }
  if (!live) return;
  if (pass == ABSMAX) {
    if (lane == 0) amax[row] = m;
    return;
  }
  if (pass == CODES) m = amax[row];

  const float sc = __fmul_rn(m, 1.0f / 127.0f);
  if (lane == 0) store_scale(scale + row, sc);
  const float d = sc < 1e-12f ? 1e-12f : sc;  // a NaN scale stays NaN, as torch.clamp leaves it
  const float r = __frcp_rn(d);
#pragma unroll
  for (int k = 0; k < HOLD; ++k) {
    const int v = lane + k * GROUP;
    if (v < nvec) put_codes(qr, v, held[k], d, r);
  }
  for (int base = SPAN; base < nvec; base += SPAN) {
    Vec<T, VEC> t[HOLD];
#pragma unroll
    for (int k = 0; k < HOLD; ++k) {
      const int v = base + lane + k * GROUP;
      if (v < nvec) t[k] = load<T, VEC>(xr, col_scale, v);
    }
#pragma unroll
    for (int k = 0; k < HOLD; ++k) {
      const int v = base + lane + k * GROUP;
      if (v < nvec) put_codes(qr, v, t[k], d, r);
    }
  }
}

template <typename T, typename S, int VEC, int GROUP>
int launch(const void* x, const void* col_scale, void* q, void* scale, float* amax, int R, int C, int pass,
           cudaStream_t st) {
  const int rows_per_cta = THREADS / GROUP;
  quantize_rows_kernel<T, S, VEC, GROUP><<<(R + rows_per_cta - 1) / rows_per_cta, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(col_scale), static_cast<int8_t*>(q), static_cast<S*>(scale),
      amax, R, C, pass);
  return static_cast<int>(cudaGetLastError());
}

// the fewest threads a row, a power of two from 32 to THREADS, that take its C / VEC loads in
// `spans` spans of HOLD loads a thread
template <typename T, typename S, int VEC>
int launch_group(const void* x, const void* col_scale, void* q, void* scale, float* amax, int R, int C, int spans,
                 int pass, cudaStream_t st) {
  int group = 32;
  while (group < THREADS && (long long)group * HOLD * spans < C / VEC) group *= 2;
  if (group == 32) return launch<T, S, VEC, 32>(x, col_scale, q, scale, amax, R, C, pass, st);
  if (group == 64) return launch<T, S, VEC, 64>(x, col_scale, q, scale, amax, R, C, pass, st);
  if (group == 128) return launch<T, S, VEC, 128>(x, col_scale, q, scale, amax, R, C, pass, st);
  return launch<T, S, VEC, THREADS>(x, col_scale, q, scale, amax, R, C, pass, st);
}

template <typename T, typename S>
int launch_plan(const void* x, const void* col_scale, void* q, void* scale, float* amax, int R, int C, int vec,
                int spans, int pass, cudaStream_t st) {
  constexpr int WIDE = 16 / sizeof(T);
  if (vec == WIDE) return launch_group<T, S, WIDE>(x, col_scale, q, scale, amax, R, C, spans, pass, st);
  if (vec == 1) return launch_group<T, S, 1>(x, col_scale, q, scale, amax, R, C, spans, pass, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x [R, C] contiguous, bf16 (x_f32 0) or f32; col_scale [C] in x's dtype or null; q int8
// [R, C] contiguous; scale [R] in x's dtype, or f32 (scale_f32 1; an f32 x has an f32 scale);
// amax [R] f32: written by the absmax pass, read by the codes pass, null for the whole one
// (pass: 0 whole, 1 absmax, 2 codes; the absmax pass writes neither q nor scale).
// vec and spans: ops/int8.py:quantize_rows_plan (16-byte loads need x and col_scale 16-byte
// aligned and C a multiple of vec).
extern "C" int lxt_quantize_rows(const void* x, const void* col_scale, void* q, void* scale, float* amax, int R, int C,
                                 int x_f32, int scale_f32, int vec, int spans, int pass, void* stream) {
  if (R < 0 || C < 1 || spans < 1 || (x_f32 && !scale_f32) || pass < WHOLE || pass > CODES ||
      (pass != WHOLE && amax == nullptr) || (pass != ABSMAX && (q == nullptr || scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  if (vec != 1 && (C % vec || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(col_scale) % 16 ||
                   reinterpret_cast<uintptr_t>(q) % vec))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (x_f32) return launch_plan<float, float>(x, col_scale, q, scale, amax, R, C, vec, spans, pass, st);
  if (scale_f32) return launch_plan<__nv_bfloat16, float>(x, col_scale, q, scale, amax, R, C, vec, spans, pass, st);
  return launch_plan<__nv_bfloat16, __nv_bfloat16>(x, col_scale, q, scale, amax, R, C, vec, spans, pass, st);
}
