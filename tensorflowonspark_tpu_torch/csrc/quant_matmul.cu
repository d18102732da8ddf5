// Fused-dequant weight matmuls: y = x @ dequant(w), W8A16 and W4A16.
//
// Replaces the TPU kernels `_int8_kernel` (kernel 9) and `_int4_kernel`
// (kernel 10) of tensorflowonspark_tpu/ops/quant_matmul.py, reached
// through `_int8_call` / `_int4_call` from `quant_matmul`.
//
// Per element, as the TPU kernels compute it:
//   int8: w[k, n] = T(f32(q[k, n]) * scale[0, n])
//   int4: byte b = packed[k / 2, n]; v = k even ? (int)(b << 28) >> 28
//                                               : (int)(b << 24) >> 28
//         w[k, n] = T(f32(v) * scale[k / G, n])
//   y[m, n] = T(sum_k f32(x[m, k]) * f32(w[k, n]))   (f32 accumulation)
// where T is x's dtype: the dequantised weight is rounded to T and back,
// so the products are the ones the TPU kernel feeds the MXU.
//
// Bound, on an NVIDIA H100 SXM at its 700 W limit (3.35 TB/s, 989
// TFLOP/s bf16).  At decode (M <= 16 rows) the call is a GEMV: bytes, the
// weight read once (K*N int8, or K*N/2 packed bytes plus the group
// scales): 5.1 us (int8) and 2.8 us (int4) at the flagship `wi` shape (K
// 2048 -> N 8192), and the same at `wo` (K 8192 -> N 2048).  At prefill
// (M 1024) it is a GEMM: operations, 2*M*K*N = 34.4 GFLOP at either
// shape, 0.035 ms on the bf16 tensor cores.  The f32 FMAs of the CUDA
// cores cap a GEMM at 67 TFLOP/s, 0.51 ms.
//
// bf16 activations (the serving path) take `quant_matmul_tc_kernel`, on
// the tensor cores.  A block of 256 threads (8 warps) owns a [BM, 128]
// output tile and walks a range of K in 32-row steps, through a ring of
// four shared-memory stages filled by 16-byte `cp.async` copies: the
// bf16 activation tile [BM, 32] and the raw weight bytes, int8 [32, 128]
// or packed int4 [16, 128] with the step's row of group scales.  The
// producer (the only part that differs between kernels 9 and 10) turns
// the raw bytes of step t + 1 into a bf16 [32, 128] tile, rounded
// exactly as above (the integer reaches f32 through the mantissa of
// 1.5 * 2^23, off the conversion unit), while the warps multiply step t
// from the other of two such tiles: one barrier a step.  Each warp runs
// `mma.sync.m16n8k16` (bf16 in, f32 sums) on fragments read by
// `ldmatrix` (`.trans` for the [K, N] weight), rows padded by 8 bf16
// against bank conflicts.  BM 16 (decode): each warp owns 16 x 16, two
// n8 tiles; BM 64 (prefill): warps in 2 x 4, each 32 x 32, 8 mma per
// k16; 32 f32 sums and 32 chunk totals a thread, two blocks an SM (BM
// 16: four, so the 512 blocks of a decode GEMV run in one wave).
// Ragged M, K and N and unaligned rows (K % 8, N % 16) take predicated
// loads in the same kernel; rows past M or K read as 0.
//
// Left to a later design: `wgmma` from shared memory (mma.sync reaches
// at most about two thirds of the tensor cores' rate), TMA loads with
// `mbarrier`s and a warp-specialised producer, so the dequant overlaps
// the products instead of alternating with them; larger output tiles
// (the 64 x 128 tile reads x 64 times and the weight 16 times from L2);
// and one pass at decode, where the split-K partials take a second
// launch.
//
// f32 activations take `quant_matmul_f32_kernel` on the CUDA cores (the
// tensor cores have no exact f32 product): the dequantised weight is
// staged as f32 in shared memory, each thread accumulates a TM x 4
// micro-tile with FMAs.
//
// K is summed in fixed chunks of `tiles_per_chunk` steps, a function of
// K and N only: each chunk sums its k16 (or k) steps in order from 0, and
// the chunk sums add in order from 0.  Every M runs the same mma shape
// and a row sits at the same place (m % 16) in it, so a row's result
// does not depend on how many rows share the call (a request decodes the
// same tokens alone or in a batch).  When the output tiles alone cannot
// fill the card (the decode GEMV has 64 tiles at N 8192), each chunk runs
// in its own block and writes f32 partials, and a second pass adds them
// in chunk order and writes x's dtype once; otherwise one block walks
// every chunk.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace tos {

constexpr int QMM_THREADS = 256;
constexpr int QMM_BN = 128;
constexpr int QMM_BK = 32;

// ---------------------------------------------------------------------
// bf16: tensor cores (smem_u32, cp_async16, ldmatrix_x4 and mma_bf16 are
// shared with the attention kernels in mma.cuh)

__device__ __forceinline__ void st_shared16(unsigned dst, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// the first `n` of 16 bytes at p as a uint4, the rest 0 (the ragged
// edge of a row, or a row that is not 16-byte aligned)
__device__ __forceinline__ uint4 load16_head(const void* p, int n) {
  const unsigned char* b = static_cast<const unsigned char*>(p);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < n) w[i >> 2] |= static_cast<unsigned>(b[i]) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// f32(v) exactly for the signed byte j (0..3) of w, or the signed
// nibble i (0..7), without the conversion unit: the biased value is
// placed in the mantissa of 1.5 * 2^23 and the bias subtracted
__device__ __forceinline__ float byte_f32(unsigned w, int j) {
  return __fsub_rn(
      __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B400000u, 0x7650 | j)),
      12583040.f);                                 // 1.5 * 2^23 + 128
}
__device__ __forceinline__ float nibble_f32(unsigned w, int i) {
  return __fsub_rn(
      __uint_as_float((((w ^ 0x88888888u) >> (4 * i)) & 0xFu) | 0x4B400000u),
      12582920.f);                                 // 1.5 * 2^23 + 8
}

// shared memory of one block (dynamic: int8 at BM 64 takes 55 KB): a
// ring of STAGES copy stages and two bf16 weight tiles (the producer
// fills one while the warps read the other)
template <bool INT4, int BM>
struct QmmTile {
  static constexpr int STAGES = 4;
  static constexpr int XLD = QMM_BK + 8;           // x row, padded
  static constexpr int WLD = QMM_BN + 8;           // bf16 weight row, padded
  static constexpr int RAW_ROWS = INT4 ? QMM_BK / 2 : QMM_BK;
  // warp tile: BM 16 -> 16 x 16 (8 warps along N); BM 64 -> 32 x 32
  static constexpr int WM = BM == 16 ? 16 : 32;
  static constexpr int WN = BM == 16 ? 16 : 32;
  static constexpr int WARPS_N = QMM_BN / WN;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static_assert((BM / WM) * WARPS_N == QMM_THREADS / 32, "8 warps");
  static_assert(BM * QMM_BK / 8 <= QMM_THREADS, "one x copy a thread");

  uint16_t xs[STAGES][BM][XLD];                  // bf16 bits
  int8_t raw[STAGES][RAW_ROWS][QMM_BN];
  float sc[STAGES][QMM_BN];                      // int4: the step's scales
  uint16_t ws[2][QMM_BK][WLD];                   // bf16 bits
};

template <bool INT4, int BM>
__global__ void __launch_bounds__(QMM_THREADS, BM == 16 ? 4 : 2)
quant_matmul_tc_kernel(const __nv_bfloat16* __restrict__ x,
                       const int8_t* __restrict__ q,
                       const float* __restrict__ scale,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ partial, int M, int K, int N,
                       int q_rows, int group, int tiles_per_chunk,
                       int chunks_per_block, int vec) {
  using Tile = QmmTile<INT4, BM>;
  constexpr int STAGES = Tile::STAGES;
  constexpr int MT = Tile::MT, NT = Tile::NT;
  extern __shared__ __align__(16) unsigned char qmm_smem[];
  Tile& sm = *reinterpret_cast<Tile*>(qmm_smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * QMM_BN;
  const int k_tiles = (K + QMM_BK - 1) / QMM_BK;
  const int t_begin = blockIdx.z * chunks_per_block * tiles_per_chunk;
  const int t_end = min(t_begin + chunks_per_block * tiles_per_chunk,
                        k_tiles);
  // 16-byte copies: weight rows need N % 16, scale rows N % 4, x rows K % 8
  // (and 16-byte aligned bases: `vec` bit 0 for q / scale, bit 1 for x)
  const bool w16 = (vec & 1) && (N & 15) == 0;
  const bool s16 = (vec & 1) != 0;
  const bool x16 = (vec & 2) != 0;
  // int4: a group that is a multiple of 32 rows gives every step one
  // scale row, staged with the step; other groups read each row's scales
  // from global memory
  const bool one_srow = group % QMM_BK == 0;

  // the producer's share of a step: a pair of weight rows (2p, 2p + 1;
  // one packed int4 row) at 8 columns
  const int pp = tid >> 4;
  const int pc = (tid & 15) * 8;
  float s8[8];
  if constexpr (!INT4) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      s8[j] = n0 + pc + j < N ? scale[n0 + pc + j] : 0.f;
  }

  // each thread's copies, fixed for the whole walk: 8 bf16 of one x row,
  // 16 weight bytes of one raw row, 4 scales (int4); step t moves them
  // 32 columns of x, 32 (int8) or 16 (int4) rows of q down
  const int xr = tid >> 2, xc = (tid & 3) * 8;
  const bool x_on = tid < BM * QMM_BK / 8;
  const bool x_row = m0 + xr < M;
  const __nv_bfloat16* xg =
      x + static_cast<long long>(x_row ? m0 + xr : 0) * K + xc;
  const int wr = tid >> 3, wc = (tid & 7) * 16;
  const bool w_on = tid < Tile::RAW_ROWS * QMM_BN / 16;
  const bool w_col = n0 + wc < N;
  const int8_t* wg =
      q + static_cast<long long>(wr) * N + (w_col ? n0 + wc : 0);
  const int sc4 = tid * 4;
  const bool s_on = INT4 && one_srow && tid < QMM_BN / 4;
  const bool s_col = n0 + sc4 < N;
  const float* sg = scale + (s_col ? n0 + sc4 : 0);
  // stage offsets in shared memory (bytes)
  constexpr unsigned XS_STAGE = sizeof(Tile::xs) / STAGES,
                     RAW_STAGE = sizeof(Tile::raw) / STAGES,
                     SC_STAGE = sizeof(Tile::sc) / STAGES,
                     WS_TILE = sizeof(Tile::ws) / 2;
  const unsigned x_dst = smem_u32(&sm.xs[0][xr][xc]);
  const unsigned w_dst = smem_u32(&sm.raw[0][wr][wc]);
  const unsigned s_dst = smem_u32(&sm.sc[0][sc4]);

  // one step's copies into stage `st`
  auto load = [&](int t, int st) {
    const int k0 = t * QMM_BK;
    // activation tile [BM, 32]: rows past M and columns past K read 0
    if (x_on) {
      const bool ok = x_row && k0 + xc < K;
      const unsigned dst = x_dst + st * XS_STAGE;
      if (x16 || !ok)
        cp_async16(dst, ok ? xg + k0 : x, ok);
      else
        st_shared16(dst, load16_head(xg + k0, 2 * (K - k0 - xc)));
    }
    // raw weight rows; rows past K (int4: past the packed rows) read 0
    if (w_on) {
      const int row0 = INT4 ? k0 / 2 : k0;
      const bool ok = w_col && (INT4 ? row0 + wr < q_rows && k0 + 2 * wr < K
                                     : row0 + wr < K);
      const int8_t* src = wg + static_cast<long long>(row0) * N;
      const unsigned dst = w_dst + st * RAW_STAGE;
      if (w16 || !ok)
        cp_async16(dst, ok ? src : q, ok);
      else
        st_shared16(dst, load16_head(src, N - n0 - wc));
    }
    // int4: the step's scale row, k0 / G
    if (s_on) {
      const float* src = sg + static_cast<long long>(k0 / group) * N;
      const unsigned dst = s_dst + st * SC_STAGE;
      if (s16 || !s_col)
        cp_async16(dst, s_col ? src : scale, s_col);
      else
        st_shared16(dst, load16_head(src, 4 * (N - n0 - sc4)));
    }
  };

  // the producer: stage `st`'s raw bytes -> the bf16 tile ws[b] [32, 128],
  // each value bf16(f32(v) * s) rounded to nearest even
  auto dequant = [&](int t, int st, int b) {
    // bf16 pairs of rows 2p (r0) and 2p + 1 (r1)
    unsigned r0[4], r1[4];
    if constexpr (!INT4) {
      const uint2 a = *reinterpret_cast<const uint2*>(&sm.raw[st][2 * pp][pc]);
      const uint2 c =
          *reinterpret_cast<const uint2*>(&sm.raw[st][2 * pp + 1][pc]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned wa = j < 2 ? a.x : a.y, wb = j < 2 ? c.x : c.y;
        const int bj = (j & 1) * 2;
        const __nv_bfloat162 h0 = __floats2bfloat162_rn(
            __fmul_rn(byte_f32(wa, bj), s8[2 * j]),
            __fmul_rn(byte_f32(wa, bj + 1), s8[2 * j + 1]));
        const __nv_bfloat162 h1 = __floats2bfloat162_rn(
            __fmul_rn(byte_f32(wb, bj), s8[2 * j]),
            __fmul_rn(byte_f32(wb, bj + 1), s8[2 * j + 1]));
        r0[j] = *reinterpret_cast<const unsigned*>(&h0);
        r1[j] = *reinterpret_cast<const unsigned*>(&h1);
      }
    } else {
      // rows 2p and 2p + 1 share a group (G is even); a row past K reads
      // zero bytes and takes a zero scale
      float s[8];
      if (one_srow) {
        const float4 f0 = *reinterpret_cast<const float4*>(&sm.sc[st][pc]);
        const float4 f1 =
            *reinterpret_cast<const float4*>(&sm.sc[st][pc + 4]);
        s[0] = f0.x; s[1] = f0.y; s[2] = f0.z; s[3] = f0.w;
        s[4] = f1.x; s[5] = f1.y; s[6] = f1.z; s[7] = f1.w;
      } else {
        const int k = t * QMM_BK + 2 * pp;
        const float* srow = scale + static_cast<long long>(k / group) * N;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[j] = k < K && n0 + pc + j < N ? srow[n0 + pc + j] : 0.f;
      }
      const uint2 a = *reinterpret_cast<const uint2*>(&sm.raw[st][pp][pc]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned w = j < 2 ? a.x : a.y;
        const int bj = (j & 1) * 2;
        // nibble 2b is row 2p of byte b, nibble 2b + 1 row 2p + 1; the
        // high nibble's row may lie past K (odd K): x reads 0 there, and
        // the packed padding holds 0
        const __nv_bfloat162 h0 = __floats2bfloat162_rn(
            __fmul_rn(nibble_f32(w, 2 * bj), s[2 * j]),
            __fmul_rn(nibble_f32(w, 2 * bj + 2), s[2 * j + 1]));
        const __nv_bfloat162 h1 = __floats2bfloat162_rn(
            __fmul_rn(nibble_f32(w, 2 * bj + 1), s[2 * j]),
            __fmul_rn(nibble_f32(w, 2 * bj + 3), s[2 * j + 1]));
        r0[j] = *reinterpret_cast<const unsigned*>(&h0);
        r1[j] = *reinterpret_cast<const unsigned*>(&h1);
      }
    }
    *reinterpret_cast<uint4*>(&sm.ws[b][2 * pp][pc]) =
        make_uint4(r0[0], r0[1], r0[2], r0[3]);
    *reinterpret_cast<uint4*>(&sm.ws[b][2 * pp + 1][pc]) =
        make_uint4(r1[0], r1[1], r1[2], r1[3]);
  };

  // the warps' fragment addresses in stage 0 / tile 0, at k16 step 0
  const int wm = (warp / Tile::WARPS_N) * Tile::WM;
  const int wn = (warp % Tile::WARPS_N) * Tile::WN;
  const unsigned a_src = smem_u32(&sm.xs[0][wm + (lane & 15)][(lane >> 4) * 8]);
  const unsigned b_src = smem_u32(&sm.ws[0][lane & 15][wn + (lane >> 4) * 8]);
  constexpr unsigned A_M16 = 16 * Tile::XLD * 2, A_K16 = 16 * 2;
  constexpr unsigned B_K16 = 16 * Tile::WLD * 2, B_N16 = 16 * 2;
  float acc[MT][NT][4], total[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = total[i][j][e] = 0.f;

  // copy group i holds step t_begin + i; the first step is dequantised
  // before the loop, and step t's loop turn dequantises step t + 1 while
  // the warps multiply step t
  static_assert((STAGES & (STAGES - 1)) == 0, "a power of two");
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (t_begin + i < t_end) load(t_begin + i, i);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  if (t_begin < t_end) dequant(t_begin, 0, 0);
  int chunk_left = tiles_per_chunk;    // t_begin starts a chunk
  for (unsigned i = 0; t_begin + static_cast<int>(i) < t_end; ++i) {
    const int t = t_begin + static_cast<int>(i);
    cp_async_wait<STAGES - 3>();   // step t + 1's copies landed
    __syncthreads();               // ws[i % 2] written; step t - 1 done
    if (t + STAGES - 1 < t_end) load(t + STAGES - 1, (i - 1) & (STAGES - 1));
    cp_async_commit();
    if (t + 1 < t_end) dequant(t + 1, (i + 1) & (STAGES - 1), (i + 1) & 1);
    const unsigned a_st = a_src + (i & (STAGES - 1)) * XS_STAGE;
    const unsigned b_st = b_src + (i & 1) * WS_TILE;
#pragma unroll
    for (int kk = 0; kk < QMM_BK / 16; ++kk) {
      unsigned a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldmatrix_x4(a[mi], a_st + mi * A_M16 + kk * A_K16);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned bf[4];
        ldmatrix_x4_trans(bf, b_st + kk * B_K16 + (j / 2) * B_N16);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma_bf16(acc[mi][j], a[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][j + 1], a[mi], bf[2], bf[3]);
        }
      }
    }
    // a chunk ends: its sum joins the total in chunk order
    if (--chunk_left == 0 || t + 1 == t_end) {
      chunk_left = tiles_per_chunk;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            total[mi][j][e] += acc[mi][j][e];
            acc[mi][j][e] = 0.f;
          }
    }
  }
  cp_async_wait<0>();

  // c fragment: (row g, cols 2q, 2q + 1) and (row g + 8, the same cols)
  const int g = lane >> 2, cq = (lane & 3) * 2;
  const bool pairs = (N & 1) == 0;
  float* part = partial ? partial + static_cast<long long>(blockIdx.z) * M * N
                        : nullptr;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + g + 8 * h;
        const int n = n0 + wn + 8 * j + cq;
        if (m >= M || n >= N) continue;
        const float v0 = total[i][j][2 * h], v1 = total[i][j][2 * h + 1];
        const long long o = static_cast<long long>(m) * N + n;
        if (pairs) {
          if (part)
            *reinterpret_cast<float2*>(part + o) = make_float2(v0, v1);
          else
            *reinterpret_cast<__nv_bfloat162*>(out + o) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          if (part) {
            part[o] = v0;
            if (n + 1 < N) part[o + 1] = v1;
          } else {
            out[o] = __float2bfloat16(v0);
            if (n + 1 < N) out[o + 1] = __float2bfloat16(v1);
          }
        }
      }
}

// ---------------------------------------------------------------------
// f32: CUDA cores

// The raw global words of one 32-row step for one thread: the activation
// values it stages and the weight words (and int4 scales) of its 4
// columns.  Loading them is separate from storing them, so the next
// step's loads are in flight while the current step computes.
template <bool INT4, int TM>
struct QmmRaw {
  static constexpr int BM = 8 * TM;
  static constexpr int XPT = BM * QMM_BK / QMM_THREADS;   // 2 or 8
  static constexpr int PASSES = INT4 ? QMM_BK / 16 : QMM_BK / 8;
  float xv[XPT];
  unsigned w[PASSES];
  float4 s4[INT4 ? PASSES : 1];
};

// TM output rows per thread; 8 thread rows x 32 thread columns of 4.
template <bool INT4, int TM>
__global__ void __launch_bounds__(QMM_THREADS, 2)
quant_matmul_f32_kernel(const float* __restrict__ x,
                        const int8_t* __restrict__ q,
                        const float* __restrict__ scale,
                        float* __restrict__ out, float* __restrict__ partial,
                        int M, int K, int N, int q_rows, int group,
                        int tiles_per_chunk, int chunks_per_block, int vec) {
  using Raw = QmmRaw<INT4, TM>;
  constexpr int BM = Raw::BM;
  __shared__ float xs[BM][QMM_BK];
  __shared__ __align__(16) float ws[QMM_BK][QMM_BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;            // 0..7
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * QMM_BN;
  const int k_tiles = (K + QMM_BK - 1) / QMM_BK;
  const int t_begin = blockIdx.z * chunks_per_block * tiles_per_chunk;
  const int t_end = min(t_begin + chunks_per_block * tiles_per_chunk,
                        k_tiles);

  // the 4 weight columns this thread loads: fixed for the whole walk
  const int nc = n0 + 4 * lane;
  const bool full4 = (vec & 1) && nc + 3 < N;
  float s8[4] = {0.f, 0.f, 0.f, 0.f};
  if (!INT4) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (nc + j < N) s8[j] = scale[nc + j];
  }

  // the 4 bytes of row `row` at columns nc..nc+3 as one word (0 past N)
  auto load_word = [&](long long row) -> unsigned {
    const int8_t* p = q + row * N + nc;
    if (full4) return *reinterpret_cast<const unsigned*>(p);
    unsigned word = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (nc + j < N)
        word |= (static_cast<unsigned>(p[j]) & 0xFFu) << (8 * j);
    return word;
  };

  auto load = [&](int t, Raw& r) {
    const int k0 = t * QMM_BK;
    // activation tile, coalesced along K; rows past M and K read as 0
#pragma unroll
    for (int e = 0; e < Raw::XPT; ++e) {
      const int i = tid + e * QMM_THREADS;
      const int m = m0 + i / QMM_BK, k = k0 + i % QMM_BK;
      r.xv[e] = (m < M && k < K) ? x[static_cast<long long>(m) * K + k]
                                 : 0.f;
    }
#pragma unroll
    for (int p = 0; p < Raw::PASSES; ++p) {
      r.w[p] = 0u;
      if (!INT4) {
        const int k = k0 + p * 8 + warp;          // one row per warp
        if (k < K) r.w[p] = load_word(k);
      } else {
        const int pr = p * 8 + warp;               // one packed row per warp
        const int prow = k0 / 2 + pr;
        const int k = k0 + 2 * pr;                 // the low nibble's row
        float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (prow < q_rows && k < K) {
          r.w[p] = load_word(prow);
          const float* srow = scale + static_cast<long long>(k / group) * N;
          if (full4) {
            sv = *reinterpret_cast<const float4*>(srow + nc);
          } else {
            if (nc < N) sv.x = srow[nc];
            if (nc + 1 < N) sv.y = srow[nc + 1];
            if (nc + 2 < N) sv.z = srow[nc + 2];
            if (nc + 3 < N) sv.w = srow[nc + 3];
          }
        }
        r.s4[INT4 ? p : 0] = sv;
      }
    }
  };

  auto store = [&](const Raw& r) {
#pragma unroll
    for (int e = 0; e < Raw::XPT; ++e) {
      const int i = tid + e * QMM_THREADS;
      xs[i / QMM_BK][i % QMM_BK] = r.xv[e];
    }
#pragma unroll
    for (int p = 0; p < Raw::PASSES; ++p) {
      const unsigned word = r.w[p];
      if (!INT4) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = __fmul_rn(
              static_cast<float>(static_cast<int>(word << (24 - 8 * j)) >> 24),
              s8[j]);
        *reinterpret_cast<float4*>(&ws[p * 8 + warp][4 * lane]) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
        const int pr = p * 8 + warp;
        const float4 sv = r.s4[INT4 ? p : 0];
        const float s[4] = {sv.x, sv.y, sv.z, sv.w};
        float lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned b = (word >> (8 * j)) & 0xFFu;
          lo[j] = __fmul_rn(static_cast<float>(static_cast<int>(b << 28) >> 28),
                            s[j]);
          // the high nibble's row k + 1 may lie past K (odd K): x reads
          // 0 there, and the packed padding holds 0
          hi[j] = __fmul_rn(static_cast<float>(static_cast<int>(b << 24) >> 28),
                            s[j]);
        }
        *reinterpret_cast<float4*>(&ws[2 * pr][4 * lane]) =
            make_float4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<float4*>(&ws[2 * pr + 1][4 * lane]) =
            make_float4(hi[0], hi[1], hi[2], hi[3]);
      }
    }
  };

  float acc[TM][4], total[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = total[i][j] = 0.f;

  Raw raw;
  if (t_begin < t_end) load(t_begin, raw);
  for (int t = t_begin; t < t_end; ++t) {
    store(raw);
    __syncthreads();
    if (t + 1 < t_end) load(t + 1, raw);      // in flight during compute
#pragma unroll 8
    for (int kk = 0; kk < QMM_BK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][4 * lane]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a = xs[warp * TM + i][kk];   // one address per warp
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    // a chunk ends: its sum joins the total in chunk order
    if ((t + 1) % tiles_per_chunk == 0 || t + 1 == t_end) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          total[i][j] += acc[i][j];
          acc[i][j] = 0.f;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + warp * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nc + j;
      if (n >= N) continue;
      const long long o = static_cast<long long>(m) * N + n;
      if (partial)
        partial[static_cast<long long>(blockIdx.z) * M * N + o] =
            total[i][j];
      else
        out[o] = total[i][j];
    }
  }
}

// out = T(sum over splits of partial[s]), in split order
template <typename T>
__global__ void __launch_bounds__(256)
split_sum_kernel(const float* __restrict__ partial, T* __restrict__ out,
                 long long mn, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < mn; i += stride) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[z * mn + i];
    out[i] = from_f32<T>(s);
  }
}

// the f32 or the bf16 kernel at one block shape
template <typename T, bool INT4, int BM>
static cudaError_t launch_block(dim3 grid, cudaStream_t st, const void* x,
                                const void* q, const float* scale, void* out,
                                float* partial, int M, int K, int N,
                                int q_rows, int group, int tiles_per_chunk,
                                int chunks_per_block, int vec) {
  if constexpr (std::is_same<T, float>::value) {
    quant_matmul_f32_kernel<INT4, BM / 8><<<grid, QMM_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q), scale,
        static_cast<float*>(out), partial, M, K, N, q_rows, group,
        tiles_per_chunk, chunks_per_block, vec);
  } else {
    // more than 48 KB of shared memory (int8, BM 64) must be asked for,
    // at each launch: the attribute belongs to the current device
    constexpr int bytes = sizeof(QmmTile<INT4, BM>);
    if constexpr (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          quant_matmul_tc_kernel<INT4, BM>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
    }
    quant_matmul_tc_kernel<INT4, BM><<<grid, QMM_THREADS, bytes, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
        scale, static_cast<__nv_bfloat16*>(out), partial, M, K, N, q_rows,
        group, tiles_per_chunk, chunks_per_block, vec);
  }
  return cudaGetLastError();
}

template <typename T, bool INT4, int BM>
static int launch_qmm(const void* x, const void* q, const float* scale,
                      void* out, float* partial, int M, int K, int N,
                      int q_rows, int group, int tiles_per_chunk, int splits,
                      int vec, cudaStream_t st) {
  const int k_tiles = (K + QMM_BK - 1) / QMM_BK;
  const int chunks = (k_tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  // `splits` is 1 (one block walks every chunk) or the chunk count (one
  // block per chunk)
  if (splits != 1 && splits != chunks) return cudaErrorInvalidValue;
  dim3 grid((N + QMM_BN - 1) / QMM_BN, (M + BM - 1) / BM, splits);
  const cudaError_t err = launch_block<T, INT4, BM>(
      grid, st, x, q, scale, out, splits > 1 ? partial : nullptr, M, K, N,
      q_rows, group, tiles_per_chunk, splits > 1 ? 1 : chunks, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const long long mn = static_cast<long long>(M) * N;
    const long long blocks = (mn + 255) / 256;
    split_sum_kernel<T><<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                          256, 0, st>>>(partial, static_cast<T*>(out), mn,
                                        splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool INT4>
static int dispatch_rows(const void* x, const void* q, const float* scale,
                         void* out, float* partial, int M, int K, int N,
                         int q_rows, int group, int block_m,
                         int tiles_per_chunk, int splits, int vec,
                         cudaStream_t st) {
  if (block_m == 16)
    return launch_qmm<T, INT4, 16>(x, q, scale, out, partial, M, K, N,
                                   q_rows, group, tiles_per_chunk, splits,
                                   vec, st);
  if (block_m == 64)
    return launch_qmm<T, INT4, 64>(x, q, scale, out, partial, M, K, N,
                                   q_rows, group, tiles_per_chunk, splits,
                                   vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tos

// x [M, K] (dtype), q [q_rows, N] int8 (int8: q_rows == K; int4: packed,
// q_rows == ceil(K / group) * group / 2), scale [1, N] or
// [ceil(K / group), N] f32, out [M, N] (dtype).  K sums in chunks of
// `tiles_per_chunk` 32-row steps; `splits` is 1 or the chunk count, and
// `partial` holds splits * M * N f32 when splits > 1.  `vec` bit 0: N is
// a multiple of 4 and q / scale are 16-byte aligned; bit 1: x's rows are
// 16-byte aligned (K % 8 == 0 and x aligned, bf16).  bf16 runs on the
// tensor cores, f32 on the CUDA cores.
extern "C" int tos_quant_matmul(const void* x, const void* q,
                                const float* scale, void* out, float* partial,
                                int M, int K, int N, int q_rows, int group,
                                int int4, int block_m, int tiles_per_chunk,
                                int splits, int vec, int dtype,
                                void* stream) {
  using namespace tos;
  if (M <= 0 || N <= 0) return 0;
  if (splits < 1 || tiles_per_chunk < 1 ||
      (int4 && (group < 2 || group % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return int4 ? dispatch_rows<float, true>(x, q, scale, out, partial, M, K,
                                             N, q_rows, group, block_m,
                                             tiles_per_chunk, splits, vec, st)
                : dispatch_rows<float, false>(x, q, scale, out, partial, M,
                                              K, N, q_rows, group, block_m,
                                              tiles_per_chunk, splits, vec,
                                              st);
  if (dtype == kBF16)
    return int4 ? dispatch_rows<__nv_bfloat16, true>(
                      x, q, scale, out, partial, M, K, N, q_rows, group,
                      block_m, tiles_per_chunk, splits, vec, st)
                : dispatch_rows<__nv_bfloat16, false>(
                      x, q, scale, out, partial, M, K, N, q_rows, group,
                      block_m, tiles_per_chunk, splits, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
