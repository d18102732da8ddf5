// Tensor-core building blocks of the port's bf16 kernels: the PTX
// helpers (`cp.async`, `ldmatrix`, `mma.sync.m16n8k16`), the warp-level
// steps of the attention kernels, and the attention tile loop that the
// flash forward (flash_attention.cu) and the paged prefill read
// (paged_prefill.cu) share.
//
// Warp-level steps, which the flash backward's dq and dk/dv kernels
// (flash_attention.cu) call:
//   mma_scores      s[16 x 8 NT] += A (16 x D) * tile^T, the tile's rows
//                   read by non-transposed ldmatrix as the `.col`
//                   operand; A from registers or by ldmatrix per k16 step;
//   c_to_a          f32 C accumulators -> bf16 A fragments in registers;
//   mma_accumulate  acc[16 x D] += A (16 x 16 KS) * tile, the tile read
//                   by ldmatrix.trans;
//   store_rows      acc times per-row factors, as bf16, out through the
//                   warp's shared rows in 16-byte stores.
// c_to_a_f16 and mma_accumulate_f16 are the same two steps in f16, for
// the int8-pool prefill read's P' times its integer payload tile.
//
// The tile loop below computes the same steps inline: built from these
// helpers, ptxas scheduled the forward's loop differently (same registers
// and instructions) and the flash forward took 1.5-1.8% longer on an H100
// (scripts/torch_kernel_rows.py, parent and change in turns).
//
// Attention tile loop.  A block of 4 warps owns 64 query rows; each warp
// owns 16 of them and keeps, in registers, its Q tile as `ldmatrix` A
// fragments (loaded once), a running max m and partial row sum l for its
// two fragment rows (lane / 4 and lane / 4 + 8), and the f32 O
// accumulator [16, D].  For every 64-key tile that the caller has staged
// in shared memory (K and V rows [64][D + 8] bf16, padded by 8 so that
// `ldmatrix` reads eight 16-byte rows from eight bank groups):
//   S = Q K^T      mma.sync, K read by non-transposed ldmatrix as the
//                  `.col` operand: 8 n8 fragments of f32 sums;
//   mask           keys at or past the row's limit to NEG_INF (the caller
//                  gives each row a key limit relative to the tile);
//   m, alpha       row max over the quad's 4 lanes (__shfl_xor 1, 2);
//                  scores live in log2 units (scale * log2 e), so every
//                  exponential is one exp2f;
//   O *= alpha, l = l * alpha + sum(p), p = exp2(s - m) in f32;
//   O += P V       P converted from the S accumulators straight into bf16
//                  A fragments (the m16n8 C layout of n8 tiles 2i and
//                  2i + 1 is the m16n8k16 A layout), so P never touches
//                  shared memory; V read by ldmatrix.trans from its
//                  row-major [64][D] tile.
// `run` walks a block's key tiles through two shared-memory stages that
// the kernel fills (`stage`: 16-byte `cp.async` copies, tile t + 1 in
// flight while tile t is multiplied) with the kernel's key limits, and
// `store` writes O / l with 16-byte stores staged through the warp's Q
// rows; the kernels differ only in how they stage and mask a tile.
// Rounding: P is rounded to bf16 before P V (as the JAX package's
// `attention_reference` casts p to q's dtype before the value product);
// l sums the f32 p, as FlashAttention-2 does, so the normaliser does not
// carry the rounding of P.  q and k are bf16, so S = Q K^T with f32 sums
// is exact up to the order of the sums.  A row whose keys are all masked
// so far sees p = exp2(NEG_INF - NEG_INF) = 1 for them, as the CUDA-core
// kernels do; the first visible key's alpha = 0 wipes that out.
#pragma once

#include <cuda_fp16.h>

#include "common.cuh"

namespace tos {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared (a shared address); `pred` false writes 16
// zero bytes
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; `pred` false writes 4 zero bytes
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as one bf16x2 register, `lo` in the low half (the lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// d += a (16 x 16, row) * b (16 x 8, col), f16 in, f32 sums
__device__ __forceinline__ void mma_f16(float (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as one f16x2 register, `lo` in the low half (the lower column)
__device__ __forceinline__ unsigned pack_f16(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

constexpr int kAttnRows = 64;      // query rows per block
constexpr int kAttnKeys = 64;      // keys per shared-memory tile
constexpr int kAttnThreads = 128;  // 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of one attention block: Q, then K and V in two stages
// each, every tile [64][D + 8] bf16.  D 128: 85 KB, two blocks an SM.
template <int D>
struct AttnSmem {
  static constexpr int LD = D + 8;                       // bf16 per row
  static constexpr int TILE_BYTES = kAttnRows * LD * 2;
  static constexpr int BYTES = 5 * TILE_BYTES;
  static constexpr int CHUNKS = D / 8;                   // 16 B per row
  // byte offsets from the start of dynamic shared memory
  static constexpr unsigned Q = 0;
  static __host__ __device__ constexpr unsigned K(int stage) {
    return (1 + stage) * TILE_BYTES;
  }
  static __host__ __device__ constexpr unsigned V(int stage) {
    return (3 + stage) * TILE_BYTES;
  }
};

// Warp-level pieces of the attention kernels (rows of every tile are
// [n][D + 8] bf16, row pitch LD; `tile` is the shared address of its
// row 0).  The flash backward (flash_attention.cu) is built from these.

// A fragments of the 16 rows at `rows`, one per k16 step over D:
// ldmatrix x4 matrices (rows 0-7, d 0-7), (8-15, 0-7), (0-7, 8-15),
// (8-15, 8-15) = a0..a3
template <int D>
__device__ __forceinline__ unsigned a_rows(unsigned rows, int lane) {
  return rows + ((lane & 15) * (D + 8) + (lane >> 4) * 8) * 2;
}

template <int D>
__device__ __forceinline__ void load_a(unsigned (&f)[D / 16][4],
                                       unsigned rows, int lane) {
  const unsigned a = a_rows<D>(rows, lane);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(f[kk], a + kk * 32);
}

// The scores step: s[NT][4] += A (16 x D) * tile^T over the tile's 8 NT
// rows, each tile row one column of s.  `a(kk, f)` sets f to the A
// fragment of k16 step kk (from registers, or by ldmatrix).  ldmatrix
// x4 over tile rows 16 np.. and d 16 kk..: matrices (rows 0-7, d 0-7),
// (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) = b0, b1 of n8 tile 2 np, then
// b0, b1 of tile 2 np + 1 (the `.col` operand, read non-transposed).
template <int D, int NT, typename AFrag>
__device__ __forceinline__ void mma_scores(float (&s)[NT][4], AFrag&& a,
                                           unsigned tile, int lane) {
  constexpr int LD = D + 8;
  const unsigned ta =
      tile + (((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8)
                 * 2;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned af[4];
    a(kk, af);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned b[4];
      ldmatrix_x4(b, ta + (np * 16 * LD + kk * 16) * 2);
      mma_bf16(s[2 * np], af, b[0], b[1]);
      mma_bf16(s[2 * np + 1], af, b[2], b[3]);
    }
  }
}

// f32 C accumulators of n8 tiles 2 j and 2 j + 1 as the bf16 A fragment
// of k16 step j: the m16n8 C layout of two n8 tiles is the m16n8k16 A
// layout, so a product's result feeds the next product in registers.
__device__ __forceinline__ void c_to_a(unsigned (&f)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  f[0] = pack_bf16(c0[0], c0[1]);
  f[1] = pack_bf16(c0[2], c0[3]);
  f[2] = pack_bf16(c1[0], c1[1]);
  f[3] = pack_bf16(c1[2], c1[3]);
}

// The accumulate step: acc[D / 8][4] += P (16 x 16 KS, bf16 A fragments)
// * tile (16 KS rows x D), the tile read by ldmatrix.trans x4 over rows
// 16 kk.. and d 16 dp..: matrices (rows 0-7, d 0-7), (8-15, 0-7), (0-7,
// 8-15), (8-15, 8-15) = b0, b1 of n8 tile 2 dp, then of tile 2 dp + 1.
template <int D, int KS>
__device__ __forceinline__ void mma_accumulate(float (&acc)[D / 8][4],
                                               const unsigned (&pf)[KS][4],
                                               unsigned tile, int lane) {
  constexpr int LD = D + 8;
  const unsigned ta = a_rows<D>(tile, lane);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      unsigned b[4];
      ldmatrix_x4_trans(b, ta + (kk * 16 * LD + dp * 16) * 2);
      mma_bf16(acc[2 * dp], pf[kk], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], pf[kk], b[2], b[3]);
    }
}

// c_to_a and mma_accumulate in f16 (10 mantissa bits to bf16's 7): the
// int8-pool prefill read multiplies its P' (p times a v scale) by an
// integer payload tile, exact in f16.
__device__ __forceinline__ void c_to_a_f16(unsigned (&f)[4],
                                           const float (&c0)[4],
                                           const float (&c1)[4]) {
  f[0] = pack_f16(c0[0], c0[1]);
  f[1] = pack_f16(c0[2], c0[3]);
  f[2] = pack_f16(c1[0], c1[1]);
  f[3] = pack_f16(c1[2], c1[3]);
}

template <int D, int KS>
__device__ __forceinline__ void mma_accumulate_f16(float (&acc)[D / 8][4],
                                                   const unsigned (&pf)[KS][4],
                                                   unsigned tile, int lane) {
  constexpr int LD = D + 8;
  const unsigned ta = a_rows<D>(tile, lane);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      unsigned b[4];
      ldmatrix_x4_trans(b, ta + (kk * 16 * LD + dp * 16) * 2);
      mma_f16(acc[2 * dp], pf[kk], b[0], b[1]);
      mma_f16(acc[2 * dp + 1], pf[kk], b[2], b[3]);
    }
}

// The warp's f32 accumulator [16 x D] times f0 (row lane / 4) and f1
// (row lane / 4 + 8) as bf16 into the 16 shared rows at `rows`, then
// each row r to `dst(r)` (D bf16, 16-byte aligned; null for a row past
// the end) in 16-byte stores.  `rows` must be the warp's own.
template <int D, typename Dst>
__device__ __forceinline__ void store_rows(__nv_bfloat16* rows,
                                           const float (&acc)[D / 8][4],
                                           float f0, float f1, int lane,
                                           Dst&& dst) {
  constexpr int LD = D + 8, CH = D / 8;
  const int r = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    *reinterpret_cast<unsigned*>(rows + r * LD + t * 8 + c) =
        pack_bf16(acc[t][0] * f0, acc[t][1] * f0);
    *reinterpret_cast<unsigned*>(rows + (r + 8) * LD + t * 8 + c) =
        pack_bf16(acc[t][2] * f1, acc[t][3] * f1);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int rr = i / CH, cc = i % CH;
    __nv_bfloat16* p = dst(rr);
    if (p != nullptr)
      *reinterpret_cast<uint4*>(p + cc * 8) =
          *reinterpret_cast<const uint4*>(rows + rr * LD + cc * 8);
  }
}

// One warp's state of the tile loop (see the header comment).
template <int D>
struct AttnWarp {
  static constexpr int LD = AttnSmem<D>::LD;
  unsigned qf[D / 16][4];   // Q as A fragments, one per k16 step
  float o[D / 8][4];        // O: n8 tiles of the m16n8 C layout
  float m[2], l[2];         // rows lane / 4 and lane / 4 + 8

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  }

  // the warp's 16 Q rows from the shared tile at `qs` (its row 0)
  __device__ __forceinline__ void load_q(unsigned qs, int lane) {
    const unsigned a = qs + ((lane & 15) * LD + (lane >> 4) * 8) * 2;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], a + kk * 32);
  }

  // one 64-key tile: K at `ks`, V at `vs` (shared addresses of row 0);
  // key j of the tile is visible to fragment row half h (0: lane / 4,
  // 1: lane / 4 + 8) iff j < lim[h]; `scale2` = sm_scale * log2 e
  __device__ __forceinline__ void tile(unsigned ks, unsigned vs, int lane,
                                       float scale2, int lim0, int lim1) {
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
    // ldmatrix x4 over keys 16 np.. and d 16 kk..: matrices (keys 0-7,
    // d 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) = b0, b1 of n8 tile
    // 2 np, then b0, b1 of tile 2 np + 1
    const unsigned ka =
        ks + (((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8)
                 * 2;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned b[4];
        ldmatrix_x4(b, ka + (np * 16 * LD + kk * 16) * 2);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }

    // scale, mask, running max over the quad that shares a row
    const int c = (lane & 3) * 2;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = s[t][e] * scale2;
        if (t * 8 + c + (e & 1) >= (h ? lim1 : lim0)) x = NEG_INF;
        s[t][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[0];
      o[t][2] *= alpha[1];
      o[t][3] *= alpha[1];
    }

    // P in f32 (for l), then as bf16 A fragments: k16 step kk takes n8
    // tiles 2 kk (registers 0, 1) and 2 kk + 1 (registers 2, 3)
    unsigned pf[4][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float p0 = exp2f(s[t][0] - mx[0]);
      const float p1 = exp2f(s[t][1] - mx[0]);
      const float p2 = exp2f(s[t][2] - mx[1]);
      const float p3 = exp2f(s[t][3] - mx[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[t >> 1][(t & 1) * 2] = pack_bf16(p0, p1);
      pf[t >> 1][(t & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: ldmatrix.trans x4 over keys 16 kk.. and d 16 dp..:
    // matrices (keys 0-7, d 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
    // = b0, b1 of n8 tile 2 dp, then of tile 2 dp + 1
    const unsigned va = vs + ((lane & 15) * LD + (lane >> 4) * 8) * 2;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned b[4];
        ldmatrix_x4_trans(b, va + (kk * 16 * LD + dp * 16) * 2);
        mma_bf16(o[2 * dp], pf[kk], b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pf[kk], b[2], b[3]);
      }
  }

  // Ends the loop: l summed over the quad and clamped at 1e-30, O / l
  // written as bf16 rows into the warp's 16 rows at `dst` (shared, row
  // pitch LD; the warp's Q rows, free once `load_q` has run), and each
  // row's lse (natural log; 0 for a row that saw no key) into lse[h].
  __device__ __forceinline__ void finish(__nv_bfloat16* dst, int lane,
                                         float (&lse)[2]) {
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lv = l[h];
      lv += __shfl_xor_sync(0xffffffffu, lv, 1);
      lv += __shfl_xor_sync(0xffffffffu, lv, 2);
      lv = fmaxf(lv, 1e-30f);
      inv[h] = 1.f / lv;
      lse[h] = m[h] <= NEG_INF / 2 ? 0.f : m[h] * kLn2 + logf(lv);
    }
    const int r = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      *reinterpret_cast<unsigned*>(dst + r * LD + t * 8 + c) =
          pack_bf16(o[t][0] * inv[0], o[t][1] * inv[0]);
      *reinterpret_cast<unsigned*>(dst + (r + 8) * LD + t * 8 + c) =
          pack_bf16(o[t][2] * inv[1], o[t][3] * inv[1]);
    }
    __syncwarp();
  }

  // The block's walk over its n_t key tiles, the same for both kernels:
  // `stage(t, s)` issues the 16-byte copies of key tile t into K(s) /
  // V(s); `limits(t, lim)` sets the lane's two key limits within tile t
  // (see `tile`).  The caller has issued and committed the copies of
  // its Q tile; tile t + 1 lands while tile t is multiplied.
  template <typename Stage, typename Limits>
  __device__ __forceinline__ void run(unsigned smem, int n_t, float scale2,
                                      Stage&& stage, Limits&& limits) {
    using Sm = AttnSmem<D>;
    const int lane = threadIdx.x & 31;
    stage(0, 0);
    cp_async_commit();
    cp_async_wait<1>();     // the Q tile landed
    __syncthreads();
    init();
    load_q(smem + Sm::Q + (threadIdx.x >> 5) * 16 * LD * 2, lane);
    for (int t = 0; t < n_t; ++t) {
      if (t + 1 < n_t) stage(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();   // tile t landed
      __syncthreads();
      int lim[2];
      limits(t, lim);
      tile(smem + Sm::K(t & 1), smem + Sm::V(t & 1), lane, scale2, lim[0],
           lim[1]);
      __syncthreads();      // tile t read before its stage is refilled
    }
  }

  // Writes the warp's 16 rows of O / l: row r (0..15) to `dst(r)` (D bf16,
  // 16-byte aligned; null for a row past the end), in 16-byte stores
  // staged through the warp's Q rows of `smem`; the lane's two rows'
  // lse into lse.
  template <typename Dst>
  __device__ __forceinline__ void store(unsigned char* smem, float (&lse)[2],
                                        Dst&& dst) {
    constexpr int CH = AttnSmem<D>::CHUNKS;
    __nv_bfloat16* rows = reinterpret_cast<__nv_bfloat16*>(
                              smem + AttnSmem<D>::Q) +
                          (threadIdx.x >> 5) * 16 * LD;
    const int lane = threadIdx.x & 31;
    finish(rows, lane, lse);
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = i % CH;
      __nv_bfloat16* p = dst(r);
      if (p != nullptr)
        *reinterpret_cast<uint4*>(p + c * 8) =
            *reinterpret_cast<const uint4*>(rows + r * LD + c * 8);
    }
  }
};

}  // namespace tos
