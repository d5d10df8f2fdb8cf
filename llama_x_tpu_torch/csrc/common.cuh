// Helpers shared by the port's hand-written Hopper kernels (sm_90a).
//
// Warp-level tensor-core products through `mma.sync` (the Ampere-style synchronous
// MMA, which Hopper still runs at a fraction of the `wgmma` rate) for K1's decode path
// and K3; the flash kernels K2, K5 and K6, K1's large-M path and K4 run on `wgmma` and
// TMA (hopper.cuh). The flash kernels share the dropout hash and the mask's tile classes
// below. Fragment layouts follow the PTX ISA
// ("Matrix fragments for mma.m16n8k16 / mma.m16n8k32"): lane = 4 * groupID + tid,
//   A (row-major 16 x K):  reg0 row g, reg1 row g+8, reg2 row g (upper K half), reg3 row g+8 (upper half)
//   B (K x 8, "col"):      reg0 lower K half of column g, reg1 upper half
//   C (16 x 8):            c0,c1 row g cols 2t,2t+1;  c2,c3 row g+8 cols 2t,2t+1
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lxt {

// D = A(16x16 bf16) * B(16x8 bf16) + D, fp32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D = A(16x32 s8) * B(32x8 s8) + D, exact int32 accumulate.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte global -> shared copy that bypasses registers; src_bytes == 0 zero-fills
// the destination (the ragged edge of a tile) without touching global memory.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// 4-byte copy (one f32 scale); src_bytes == 0 zero-fills
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 matrices of 16-bit elements (or 8 x 16 bytes) from shared memory: lanes
// 8i..8i+7 give the row addresses of matrix i, and r[i] is that matrix's fragment (lane
// l holds row l / 4, elements 2 (l % 4) and 2 (l % 4) + 1: the mma.m16n8k16 A / B layout,
// or bytes 4 (l % 4)..+3 of a row: the m16n8k32 s8 layout). The .trans form hands lane l
// column l / 4, rows 2 (l % 4) and 2 (l % 4) + 1: a B operand stored k-major.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Byte offset of 16-byte chunk c of row r in a tile whose rows are `row_bytes` long,
// XOR-swizzled so that the same chunk of 8 consecutive rows lies in 8 different bank
// groups (ldmatrix and row-wise cp.async both conflict-free); row_bytes >= 128.
__device__ __forceinline__ int swz(int r, int c, int row_bytes) { return r * row_bytes + ((c ^ (r & 7)) << 4); }

// Attention dropout: the counter-based keep mask of the JAX flash kernels
// (llama_x_tpu/ops/flash_attention.py:_fmix32 / _keep_for), bit for bit. All uint32
// with wrap. For element (b, kv head h, q block i, kv block j, row r, column c) of the
// JAX plan's stacked-group block [group * bq, bk]:
//   key  = seed + b*0x9E3779B9 + h*0x85EBCA6B + i*0xC2B2AE35 + j*0x27D4EB2F
//   bits = fmix32(fmix32(key) + r*bk + c),  r = g*bq + qpos % bq,  c = kpos % bk
//   keep iff bits >= threshold; kept probabilities are multiplied by keep_scale.
// threshold = min(int(rate * 2^32), 2^32 - 1) and keep_scale = f32(1 / (1 - rate)) come
// from the host, computed in double as the JAX package computes them.
struct Dropout {
  int on;
  uint32_t threshold;
  float keep_scale;
  uint32_t seed;
  int bq, bk;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// fmix32 of the block key: hoisted out of the per-element hash wherever (i, j) is fixed
__device__ __forceinline__ uint32_t dropout_block_key(const Dropout& d, int b, int h, int i, int j) {
  return fmix32(d.seed + (uint32_t)b * 0x9E3779B9u + (uint32_t)h * 0x85EBCA6Bu + (uint32_t)i * 0xC2B2AE35u +
                (uint32_t)j * 0x27D4EB2Fu);
}

// keep / (1 - rate) or 0 for the element at stacked row offset row_bk = r * bk and column c
__device__ __forceinline__ float dropout_keep(const Dropout& d, uint32_t block_key, uint32_t row_bk, uint32_t c) {
  return fmix32(block_key + row_bk + c) >= d.threshold ? d.keep_scale : 0.f;
}

// The flash kernels' mask (ops/attention.py:make_attention_mask): visible = base |
// in_prefix, base = (q + q_off >= k + kv_off if causal) & (qseg == kseg if segments) (with
// neither, base is all True without a prefix and all False with one), in_prefix =
// q + q_off < prefix & k + kv_off < prefix; no query at or past S and no key at or past
// kv_end is visible. q and k are local rows; q_off and kv_off place them at global
// positions. Self-attention (batch_mask): kv_end = S and both offsets 0. The ring form
// (batch_mask with offsets; ring attention's _fwd(offsets=) / _bwd(offsets=)): the local
// q shard starts at q_off and the rotated kv block at kv_off, one pair for the whole call,
// with every mask: the causal diagonal shifts by q_off - kv_off and the prefix is tested
// at global positions. The offsets form over a KV cache (offsets_mask, K2 only): q row i
// sits at q_offset[b] + i, cache entry j at kv_offset[b] + j, kv_end is the row's kv_len;
// it has no prefix and no segments. `prefix` is the batch row's length or -1; qrange /
// krange hold the batch row's min and max segment id of every SEG_CHUNK positions
// ([ceil(S / SEG_CHUNK)][2], from the wrapper) and are null without segments.
constexpr int SEG_CHUNK = 64;
enum TileClass { TILE_SKIP = 0, TILE_PARTIAL = 1, TILE_FULL = 2 };

struct Mask {
  int S, causal, prefix;
  const int *qrange, *krange;
  int kv_end, q_off, kv_off;
};

// the Mask of batch row b from the kernels' arguments (prefix [B] and the [B, chunks, 2]
// ranges, each null when absent; q_off / kv_off: the ring form's global starts, else 0)
__device__ __forceinline__ Mask batch_mask(int S, int causal, const int* prefix, const int* qrange, const int* krange,
                                           int b, int q_off, int kv_off) {
  const size_t row = (size_t)b * ((S + SEG_CHUNK - 1) / SEG_CHUNK) * 2;
  return Mask{S, causal, prefix ? prefix[b] : -1, qrange ? qrange + row : nullptr, krange ? krange + row : nullptr,
              S, q_off, kv_off};
}

// the causal Mask of batch row b of Sq queries over a cache of Skv entries, from the
// per-row q_offset, kv_offset and kv_len [B] (kv_len clamped to the cache)
__device__ __forceinline__ Mask offsets_mask(int Sq, int Skv, const int* q_offset, const int* kv_offset,
                                             const int* kv_len, int b) {
  return Mask{Sq, 1, -1, nullptr, nullptr, max(0, min(kv_len[b], Skv)), q_offset[b], kv_offset[b]};
}

__device__ __forceinline__ int2 seg_range(const int* r, int x0, int n, int S) {
  const int lo = x0 / SEG_CHUNK, hi = (min(x0 + n, S) - 1) / SEG_CHUNK;
  int2 out = make_int2(r[2 * lo], r[2 * lo + 1]);
  for (int c = lo + 1; c <= hi; ++c) {
    out.x = min(out.x, r[2 * c]);
    out.y = max(out.y, r[2 * c + 1]);
  }
  return out;
}

// The class of the tile [q0, q0 + bq) x [kv0, kv0 + bk) of local rows: TILE_SKIP when no
// element is visible (the kernels never load it), TILE_FULL when every element is (the
// tile then runs with no mask code), TILE_PARTIAL otherwise. qr / kr: the tile's segment
// id ranges (seg_range; unread without segments). A tile reaching past kv_end is never
// full, a tile starting at or past it is skipped. The causal and prefix tests take the
// tile's global starts q0 + q_off and kv0 + kv_off. Mirrors ops/flash_attention.py:
// tile_class (and the JAX kernels' _needed and _all_true, with the segment test widened
// to id ranges).
__device__ __forceinline__ int tile_class(const Mask& m, int q0, int bq, int kv0, int bk, int2 qr, int2 kr) {
  if (q0 >= m.S || kv0 >= m.kv_end) return TILE_SKIP;
  const int qa = q0 + m.q_off, ka = kv0 + m.kv_off;
  const bool has_base = m.causal || m.qrange, has_prefix = m.prefix >= 0;
  bool base_skip = (m.causal && qa + bq - 1 < ka) || (!has_base && has_prefix);
  bool base_full = (!m.causal || qa >= ka + bk - 1) && (has_base || !has_prefix);
  if (m.qrange && !base_skip) {
    base_skip = qr.y < kr.x || kr.y < qr.x;
    base_full = base_full && qr.x == qr.y && kr.x == kr.y && qr.x == kr.x;
  }
  const bool pre_any = has_prefix && qa < m.prefix && ka < m.prefix;
  const bool pre_full = has_prefix && qa + bq <= m.prefix && ka + bk <= m.prefix;
  if (base_skip && !pre_any) return TILE_SKIP;
  if ((base_full || pre_full) && q0 + bq <= m.S && kv0 + bk <= m.kv_end) return TILE_FULL;
  return TILE_PARTIAL;
}

// a tile's segment id range, or (0, 0) without segments
__device__ __forceinline__ int2 q_range(const Mask& m, int q0, int bq) {
  return m.qrange && q0 < m.S ? seg_range(m.qrange, q0, bq, m.S) : make_int2(0, 0);
}
__device__ __forceinline__ int2 kv_range(const Mask& m, int kv0, int bk) {
  return m.krange && kv0 >= 0 && kv0 < m.kv_end ? seg_range(m.krange, kv0, bk, m.kv_end) : make_int2(0, 0);
}

// one element of a TILE_PARTIAL tile (local rows q, k); qs / ks are the two positions'
// segment ids
__device__ __forceinline__ bool visible(const Mask& m, int q, int k, int qs, int ks) {
  const int qg = q + m.q_off, kg = k + m.kv_off;
  const bool base = (!m.causal || qg >= kg) && (!m.qrange || qs == ks) && (m.causal || m.qrange || m.prefix < 0);
  return (base || (qg < m.prefix && kg < m.prefix)) && q < m.S && k < m.kv_end;
}

}  // namespace lxt
