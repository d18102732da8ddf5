// Paged prefill: the in-place page write and the chunked flash read.
//
// Replaces the two TPU kernels of tensorflowonspark_tpu/ops/
// paged_prefill.py: `_page_write_kernel` (reached through `_write_pages`)
// and `_prefill_read_kernel` (reached through `_read_attention`), which
// `paged_prefill` runs back to back for every S > 1 prefill chunk.
//
// Page write.  Chunk position s of row b lands at
// pool[table[b, clip((start + s) // page, 0, max_pages - 1)],
// (start + s) % page] -- the same clip as the TPU kernel, so bucket-pad
// overshoot and the all-sink tables of pad rows land in the sink page.
// The pool is updated in place (the TPU kernel aliases it in and out).
// Two rows that both write the sink race here where the TPU kernel sums;
// sink bytes are garbage by contract and masked on every read.
// Bound: bytes, nothing else (FLAGSHIP_PREFILL_KERNEL: 4 rows x 256 x
// 8 x 128 x 2 B, read once and written once for k and v: 8.4 MB per
// layer, 2.5 us at 3.35 TB/s; a 16-row decode step moves 128 KB, where
// the time is latency).  Design: one warp per token row, four rows a
// block; each lane loads up to 4 16-byte chunks of k and 4 of v before
// the row's page lookup, so the data and the lookup are in flight
// together, then stores them; no arithmetic.  The lookup takes one trip
// to memory where a row's table holds at most 64 pages (the lanes read
// the whole table row beside starts[b] and the entry comes by a
// shuffle), two dependent ones (starts, then table) beyond.
//
// Prefill read.  Online softmax of the chunk's queries over
// [context pages < start || the chunk's own k/v], the chunk part under
// the causal triangle jc <= s.  Bound: operations (FLAGSHIP_PREFILL_
// KERNEL: 18.9 GFLOP per layer, 19 us at the bf16 tensor-core peak, 0.28
// ms at the 67 TFLOP/s f32 rate of the CUDA cores; its 33 MB of context
// would take 9.8 us).
//
// bf16 pools: `prefill_read_mma_kernel`, on the tensor cores.  One block
// of 4 warps per (64-row tile of grouped queries, kv head, batch row);
// row r of the tile is query position r / group and GQA member r %
// group, so each kv head's context is read once per 64-row tile.  The
// block stages its Q rows and 64-key K / V tiles in shared memory with
// 16-byte `cp.async` copies (two stages), first the context tiles, each
// 16-byte chunk of key row j through its own page-table entry (clipped
// to the pool, as below; the page size need not match the tile), then
// the chunk's own strided k / v, and each warp runs the shared tile loop
// of mma.cuh (`AttnWarp`: `mma.sync.m16n8k16`, online softmax in
// registers, P rounded to bf16 before P V).  Masks: context keys j <
// n_ctx = min(start, max_pages * page); chunk keys jc <= r / group;
// chunk tiles past the tile's last query position are skipped.  The
// longest tiles (the last rows) are scheduled first.  Left to later
// work: `wgmma`, TMA and warp specialisation.
//
// int8 pools with bf16 activations: `prefill_read_i8_mma_kernel`, on
// the tensor cores, with the same block layout (4 warps per 64-row tile
// of grouped queries, kv head and batch row; longest tiles first).  The
// per-(token, head) f32 scales fold into the products instead of into
// the values: an int8 payload value (-127..127) is exact in bf16, so the
// block stages the int8 K / V payload of a 64-key context tile (16-byte
// `cp.async`, each chunk of key row j through its own page-table entry)
// and its 64 + 64 scales (4-byte `cp.async`, stride n_kv in the
// canonical [NP, page, n_kv] scale pools) into a landing area, converts
// the payload exactly to 16-bit [64][D + 8] tiles (two stages,
// AttnSmem's layout; K as bf16, V as f16) one tile ahead, and keeps each
// stage's scales beside it.  Per tile each warp, from mma.cuh's
// warp-level steps:
//   S = Q K_int^T    mma_scores, f32 sums (exact products);
//   s = S * (k_scale[j] * sm_scale * log2 e), then the mask, per column;
//   m, alpha, l += sum p, with p = exp2(s - m) in f32 (unscaled);
//   O += P' V_int    P' = p * v_scale[j], rounded to f16 by c_to_a_f16,
//                    then mma_accumulate_f16;
// and O / l goes out through store_rows.  The one rounding added to the
// JAX kernel's f32 arithmetic is that of p' to f16 (relative 2^-11).
// In bf16, as the bf16-pool kernel rounds p, it would cost up to |v| x
// 2^-9 an output per dominant key, and an int8 pool's values reach
// +-6: more than the 1e-2 tolerance of an output near 0 (the CPU
// emulation measured 101% of it).  f16 holds the payload exactly and
// p' up to 65504, so the kernel takes pools whose scales stay below
// that (activations of |k|, |v| < 8.3e6); dequantising into a bf16
// tile instead would round every context value k * k_scale and v *
// v_scale to bf16 as well.  The chunk's own tiles (already dequantised
// and rounded to bf16 by the page write) are staged straight into the
// stage with scale 1 and multiply in bf16, as in the bf16-pool kernel.
// Trouble it handles: keys at or past n_ctx land as zero
// payload and zero scale and are still masked to NEG_INF (a zero scale
// never stands in for the mask); the page size need not match the
// tile; a pad row's all-sink table reads the sink's garbage, which only
// its own (never compared) output sees.  Shared memory at D 128:
// 104,960 B (Q, 2 x K, 2 x V bf16; the int8 landing tiles; 3 x 512 B of
// scales), two blocks an SM.
//
// f32 activations: `prefill_read_kernel`, in f32 on the CUDA cores (the
// tensor cores have no exact f32 product), far from the bound.  Design:
// one block per (64-row tile of grouped queries, kv head, batch row), 256
// threads.  The block keeps its q tile in shared memory, streams 32-key
// tiles of k and v through shared memory (context pages looked up in the
// table, then the chunk), and each thread holds 4 query rows x (2 scores,
// Dh/16 output columns) of f32 state.  A block reads the row's context
// once, so the context is read once per 64-row tile: ceil(S * group /
// 64) times in all (8 at FLAGSHIP_PREFILL_KERNEL).
//
// int8 kv pools (the JAX kernels' `quant` branch).  The page write takes
// the chunk in its activation dtype and fuses the JAX wrapper's
// `_quantize` into the store: a warp takes kv rows ((token, kv head)
// pairs) of k and of v together, reduces each row's amax over Dh, then
// scale = max(amax, 1e-12) / 127 and q = clip(rint(x / scale), -127,
// 127), with IEEE division and round-half-to-even, so the bytes equal
// `_kv_quantize`'s.  It issues every load of its rows, then their page
// lookups, then one shuffle tree for all their amaxes; a lane stores its
// payload in one 4- or 2-byte store and its dequantised values in one
// 8- or 4-byte (bf16) store.  Four rows a warp when that still leaves
// eight warps an SM (prefill), else one (a decode step's B x n_kv rows
// spread over B x n_kv warps).  It stores the int8 row and the scale (in
// the canonical [NP, page, n_kv] scale pool, under the same clip and
// dropped out-of-range store) and also writes the chunk dequantised and
// rounded to the activation dtype, which is what the read's chunk part
// attends to (JAX `_dequantize(k_st, k_sc, k.dtype)`).  Bound: bytes
// (FLAGSHIP_PREFILL_KERNEL: the bf16 chunk read once, the dequantised
// bf16 chunk written once, int8 payload and f32 scales stored: 10.55 MB
// per layer, 3.1 us; a 16-row decode step 161 KB).  The decode step's
// one-token write of an int8 pool runs the same kernel (S = 1).  With
// f32 activations the read dequantises each context value in f32
// (payload x its token's scale) as it fills the shared-memory key and
// value tiles, as `_prefill_read_kernel` does; with bf16 activations it
// folds the scales into the products on the tensor cores (above).
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace tos {

constexpr int kWriteWarps = 4;  // warps a page-write block
constexpr int kWriteU = 4;      // 16-byte chunks of k and of v a lane holds

// The pool row (physical page * page + offset) where chunk position s of
// row b lands, or -1 when the page id is out of range: the store drops,
// as a JAX scatter drops it.  Two dependent loads (starts, then table).
__device__ __forceinline__ long long page_row(const int* __restrict__ table,
                                              const int* __restrict__ starts,
                                              int b, int s, int page,
                                              int max_pages, int n_pages) {
  const int pos = starts[b] + s;
  const int blk = min(max(pos / page, 0), max_pages - 1);
  const int phys = table[size_t(b) * max_pages + blk];
  if (phys < 0 || phys >= n_pages) return -1;
  return static_cast<long long>(phys) * page + pos % page;
}

// page_row for a whole warp (b and s the same in every lane), in one
// trip to memory where the row's table fits in two entries a lane
// (max_pages <= 64): the lanes read the table row beside starts[b]
// instead of after it, and the entry comes from its lane by a shuffle.
__device__ __forceinline__ long long warp_page_row(
    const int* __restrict__ table, const int* __restrict__ starts, int b,
    int s, int page, int max_pages, int n_pages, int lane) {
  if (max_pages > 64)
    return page_row(table, starts, b, s, page, max_pages, n_pages);
  const int* tr = table + size_t(b) * max_pages;
  const int t0 = tr[min(lane, max_pages - 1)];
  const int t1 = tr[min(lane + 32, max_pages - 1)];
  const int pos = starts[b] + s;
  const int blk = min(max(pos / page, 0), max_pages - 1);
  const int phys = __shfl_sync(0xffffffffu, blk < 32 ? t0 : t1, blk & 31);
  if (phys < 0 || phys >= n_pages) return -1;
  return static_cast<long long>(phys) * page + pos % page;
}

// One warp a token row (n_kv * Dh values of k and of v, n16 16-byte
// chunks each).  The lane's first kWriteU chunks of k and of v are loaded
// before the page lookup, so the data and the lookup are in flight
// together; the stores follow.
__global__ void __launch_bounds__(32 * kWriteWarps)
page_write_kernel(const uint4* __restrict__ k, const uint4* __restrict__ v,
                  uint4* __restrict__ pk, uint4* __restrict__ pv,
                  const int* __restrict__ table,
                  const int* __restrict__ starts, int B, int S, int n16,
                  int page, int max_pages, int n_pages) {
  const int lane = threadIdx.x & 31;
  const int tok = blockIdx.x * kWriteWarps + (threadIdx.x >> 5);
  if (tok >= B * S) return;
  const uint4* ks = k + size_t(tok) * n16;
  const uint4* vs = v + size_t(tok) * n16;
  uint4 kr[kWriteU], vr[kWriteU];
#pragma unroll
  for (int u = 0; u < kWriteU; ++u) {
    const int i = lane + 32 * u;
    if (i < n16) {
      kr[u] = ks[i];
      vr[u] = vs[i];
    }
  }
  const int b = tok / S;
  const long long row = warp_page_row(table, starts, b, tok - b * S, page,
                                      max_pages, n_pages, lane);
  if (row < 0) return;
  uint4* kd = pk + row * n16;
  uint4* vd = pv + row * n16;
  for (int base = 0;;) {
#pragma unroll
    for (int u = 0; u < kWriteU; ++u) {
      const int i = base + lane + 32 * u;
      if (i < n16) {
        kd[i] = kr[u];
        vd[i] = vr[u];
      }
    }
    base += 32 * kWriteU;
    if (base >= n16) break;
#pragma unroll
    for (int u = 0; u < kWriteU; ++u) {
      const int i = base + lane + 32 * u;
      if (i < n16) {
        kr[u] = ks[i];
        vr[u] = vs[i];
      }
    }
  }
}

// Quantise one kv row held as EPT values a lane, its amax already
// reduced over the warp: the dequantised row (one EPT-value store a
// lane), and, where the page is in range (dst >= 0), the int8 payload
// (one 4- or 2-byte store a lane) and the scale.  The arithmetic of
// `_kv_quantize`: IEEE division, round half to even, the clip to +-127.
template <typename T, int EPT>
__device__ __forceinline__ void quantize_store(const float (&x)[EPT],
                                               float amax, long long dst,
                                               int8_t* __restrict__ pool,
                                               float* __restrict__ scales,
                                               T* __restrict__ deq,
                                               int lane) {
  using Word = std::conditional_t<EPT == 4, uint32_t, uint16_t>;
  const float scale = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  Pack<T, EPT> d;
  Word q = 0;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const float r = rintf(__fdiv_rn(x[e], scale));
    const int8_t q8 = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
    q |= static_cast<Word>(static_cast<uint8_t>(q8)) << (8 * e);
    d.v[e] = from_f32<T>(__fmul_rn(static_cast<float>(q8), scale));
  }
  *reinterpret_cast<Pack<T, EPT>*>(deq + lane * EPT) = d;
  if (dst >= 0) {
    *reinterpret_cast<Word*>(pool + dst * (32 * EPT) + lane * EPT) = q;
    if (lane == 0) scales[dst] = scale;
  }
}

// One warp quantises RW consecutive kv rows ((token, head) pairs, Dh =
// 32 * EPT values) of k and of v together: every row's loads, then the
// page lookups, then one shuffle tree for all 2 * RW amaxes, then the
// stores.  RW > 1 at prefill puts more bytes in flight a warp; RW 1 at
// a decode step spreads the B x n_kv rows over B x n_kv warps.
template <typename T, int EPT, int RW>
__global__ void __launch_bounds__(32 * kWriteWarps)
page_write_int8_kernel(const T* __restrict__ k, const T* __restrict__ v,
                       int8_t* __restrict__ pk, int8_t* __restrict__ pv,
                       float* __restrict__ ks, float* __restrict__ vs,
                       T* __restrict__ ck, T* __restrict__ cv,
                       const int* __restrict__ table,
                       const int* __restrict__ starts, int B, int S, int n_kv,
                       int page, int max_pages, int n_pages) {
  constexpr int DH = 32 * EPT;
  const int lane = threadIdx.x & 31;
  const int rows = B * S * n_kv;
  const int r0 = (blockIdx.x * kWriteWarps + (threadIdx.x >> 5)) * RW;
  if (r0 >= rows) return;
  // unconditional loads, all issued before the first use: a row past
  // the end reads the last row and is neither stored nor written
  Pack<T, EPT> ka[RW], va[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const size_t at = size_t(min(r0 + j, rows - 1)) * DH + lane * EPT;
    ka[j] = *reinterpret_cast<const Pack<T, EPT>*>(k + at);
    va[j] = *reinterpret_cast<const Pack<T, EPT>*>(v + at);
  }
  // the scale pools' row of each kv row: (pool row) * n_kv + head
  long long dst[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int r = min(r0 + j, rows - 1);
    const int tok = r / n_kv;
    const int b = tok / S;
    // the plain two-trip lookup: warp_page_row's extra table loads, four
    // rows a warp, measured slower at prefill on the H100 and no faster
    // at a decode step
    const long long row =
        page_row(table, starts, b, tok - b * S, page, max_pages, n_pages);
    dst[j] = row < 0 ? -1 : row * n_kv + (r - tok * n_kv);
  }
  float xk[RW][EPT], xv[RW][EPT];
#pragma unroll
  for (int j = 0; j < RW; ++j)
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      xk[j][e] = to_f32(ka[j].v[e]);
      xv[j][e] = to_f32(va[j].v[e]);
    }
  float ak[RW], av[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    ak[j] = av[j] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      ak[j] = fmaxf(ak[j], fabsf(xk[j][e]));
      av[j] = fmaxf(av[j], fabsf(xv[j][e]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      ak[j] = fmaxf(ak[j], __shfl_xor_sync(0xffffffffu, ak[j], o));
      av[j] = fmaxf(av[j], __shfl_xor_sync(0xffffffffu, av[j], o));
    }
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    if (r0 + j >= rows) break;
    const size_t at = size_t(r0 + j) * DH;
    quantize_store<T, EPT>(xk[j], ak[j], dst[j], pk, ks, ck + at, lane);
    quantize_store<T, EPT>(xv[j], av[j], dst[j], pv, vs, cv + at, lane);
  }
}

constexpr int kBR = 64;   // grouped query rows per block
constexpr int kBC = 32;   // keys per shared-memory tile
constexpr int kNT = 256;  // threads: 16 (tx) x 16 (ty)

template <int DH>
constexpr int prefill_smem_bytes() {
  return ((kBR + 2 * kBC) * (DH + 1) + kBR * (kBC + 1)) * 4;
}

// One key tile: scores, online-softmax update, P @ V.  `visible(row, j)`
// says whether grouped row `row` sees tile key `j`.
template <int DH, typename Vis>
__device__ __forceinline__ void prefill_tile(
    const float* Qs, const float* Ks, const float* Vs, float* Ps, int tx,
    int ty, int r0, int j0, float sm_scale, Vis visible, float (&m)[4],
    float (&l)[4], float (&acc)[4][DH / 16]) {
  constexpr int DP = DH + 1;
  constexpr int CPT = DH / 16;
  float sc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * DP + d];
    const float k0 = Ks[tx * DP + d];
    const float k1 = Ks[(tx + 16) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sc[i][0] = fmaf(a[i], k0, sc[i][0]);
      sc[i][1] = fmaf(a[i], k1, sc[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    const float s0 = visible(row, j0 + tx) ? sc[i][0] * sm_scale : NEG_INF;
    const float s1 = visible(row, j0 + tx + 16) ? sc[i][1] * sm_scale
                                                : NEG_INF;
    const float mn = fmaxf(m[i], half_warp_max(fmaxf(s0, s1)));
    const float alpha = expf(m[i] - mn);
    const float p0 = expf(s0 - mn);
    const float p1 = expf(s1 - mn);
    l[i] = l[i] * alpha + half_warp_sum(p0 + p1);
    m[i] = mn;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    Ps[(ty * 4 + i) * (kBC + 1) + tx] = p0;
    Ps[(ty * 4 + i) * (kBC + 1) + tx + 16] = p1;
  }
  __syncthreads();
#pragma unroll 4
  for (int c = 0; c < kBC; ++c) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * (kBC + 1) + c];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const float vv = Vs[c * DP + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(p[i], vv, acc[i][cc]);
    }
  }
  __syncthreads();
}

// T: q's and the chunk's type; TK: the pool's storage type (T, or int8_t
// with the f32 scale pools ks / vs).
template <typename T, typename TK, int DH>
__global__ void __launch_bounds__(kNT)
prefill_read_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                    const T* __restrict__ cv, const TK* __restrict__ pk,
                    const TK* __restrict__ pv, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table,
                    const int* __restrict__ starts, T* __restrict__ out,
                    int S, int H, int n_kv, int page, int max_pages,
                    int n_pages, float sm_scale) {
  constexpr int DP = DH + 1;
  constexpr int CPT = DH / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBR][DP]
  float* Ks = Qs + kBR * DP;     // [kBC][DP]
  float* Vs = Ks + kBC * DP;     // [kBC][DP]
  float* Ps = Vs + kBC * DP;     // [kBR][kBC + 1]

  const int r0 = blockIdx.x * kBR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / n_kv;
  const int rows = S * group;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_ctx = min(starts[b], max_pages * page);

  for (int i = tid; i < kBR * DH; i += kNT) {
    const int r = i / DH;
    const int d = i % DH;
    const int row = r0 + r;
    float val = 0.f;
    if (row < rows) {
      const int s = row / group;
      const int hq = h * group + row % group;
      val = to_f32(q[((size_t(b) * S + s) * H + hq) * DH + d]);
    }
    Qs[r * DP + d] = val;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // context: every chunk query sits at or past `start`, so all keys
  // j < start are visible
  const int* row_table = table + size_t(b) * max_pages;
  for (int j0 = 0; j0 < n_ctx; j0 += kBC) {
    for (int i = tid; i < kBC * DH; i += kNT) {
      const int c = i / DH;
      const int d = i % DH;
      const int j = j0 + c;
      float kv = 0.f, vv = 0.f;
      if (j < n_ctx) {
        const int phys = min(max(row_table[j / page], 0), n_pages - 1);
        const size_t row = (size_t(phys) * page + j % page) * n_kv + h;
        kv = to_f32(pk[row * DH + d]);
        vv = to_f32(pv[row * DH + d]);
        if constexpr (std::is_same<TK, int8_t>::value) {
          kv *= ks[row];
          vv *= vs[row];
        }
      }
      Ks[c * DP + d] = kv;
      Vs[c * DP + d] = vv;
    }
    __syncthreads();
    prefill_tile<DH>(Qs, Ks, Vs, Ps, tx, ty, r0, j0, sm_scale,
                     [n_ctx](int, int j) { return j < n_ctx; }, m, l, acc);
  }

  // the chunk's own keys under the causal triangle jc <= s; tiles past
  // the tile's last query position are skipped
  const int last_row = min(rows, r0 + kBR) - 1;
  const int n_ck = min(S, last_row / group + 1);
  for (int j0 = 0; j0 < n_ck; j0 += kBC) {
    for (int i = tid; i < kBC * DH; i += kNT) {
      const int c = i / DH;
      const int d = i % DH;
      const int j = j0 + c;
      float kv = 0.f, vv = 0.f;
      if (j < S) {
        const size_t src = ((size_t(b) * S + j) * n_kv + h) * DH + d;
        kv = to_f32(ck[src]);
        vv = to_f32(cv[src]);
      }
      Ks[c * DP + d] = kv;
      Vs[c * DP + d] = vv;
    }
    __syncthreads();
    prefill_tile<DH>(
        Qs, Ks, Vs, Ps, tx, ty, r0, j0, sm_scale,
        [S, group](int row, int j) { return j < S && j <= row / group; }, m,
        l, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= rows) continue;
    const int s = row / group;
    const int hq = h * group + row % group;
    T* dst = out + ((size_t(b) * S + s) * H + hq) * DH;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      dst[tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
  }
}

// The bf16-pool read on the tensor cores (see the header): q / out [B,
// S, H, D], ck / cv [B, S, n_kv, D], pools pk / pv [n_pages, page, n_kv,
// D], all bf16.
template <int D>
__global__ void __launch_bounds__(kAttnThreads, 2)
prefill_read_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ ck,
                        const __nv_bfloat16* __restrict__ cv,
                        const __nv_bfloat16* __restrict__ pk,
                        const __nv_bfloat16* __restrict__ pv,
                        const int* __restrict__ table,
                        const int* __restrict__ starts,
                        __nv_bfloat16* __restrict__ out, int S, int H,
                        int n_kv, int page, int max_pages, int n_pages,
                        float sm_scale) {
  using Sm = AttnSmem<D>;
  constexpr int LD = Sm::LD, CH = Sm::CHUNKS;
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const unsigned base = smem_u32(attn_smem);

  const int r0 = (gridDim.x - 1 - blockIdx.x) * kAttnRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / n_kv;
  const int rows = S * group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_ctx = min(starts[b], max_pages * page);
  const int* row_table = table + size_t(b) * max_pages;

  // grouped query row r0 + r -> q[b, r / group, h * group + r % group]
  auto q_row = [&](int row) {
    return (size_t(b) * S + row / group) * H + h * group + row % group;
  };
#pragma unroll
  for (int i = tid; i < kAttnRows * CH; i += kAttnThreads) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < rows;
    cp_async16(base + Sm::Q + (r * LD + c * 8) * 2,
               ok ? q + q_row(r0 + r) * D + c * 8 : q, ok);
  }
  cp_async_commit();

  // context tiles first (every chunk query sits at or past `start`, so
  // all keys j < n_ctx are visible), then the chunk's own keys up to the
  // tile's last query position
  const int n_ctx_t = (n_ctx + kAttnKeys - 1) / kAttnKeys;
  const int n_ck = min(S, (min(rows, r0 + kAttnRows) - 1) / group + 1);
  const int n_t = n_ctx_t + (n_ck + kAttnKeys - 1) / kAttnKeys;
  auto stage_tile = [&](int t, int st) {
    const unsigned kd = base + Sm::K(st), vd = base + Sm::V(st);
    if (t < n_ctx_t) {
      const int j0 = t * kAttnKeys;
#pragma unroll
      for (int i = tid; i < kAttnKeys * CH; i += kAttnThreads) {
        const int r = i / CH, c = i % CH;
        const int j = j0 + r;
        const bool ok = j < n_ctx;
        size_t src = 0;
        if (ok) {
          const int phys = min(max(row_table[j / page], 0), n_pages - 1);
          src = ((size_t(phys) * page + j % page) * n_kv + h) * D + c * 8;
        }
        const unsigned off = (r * LD + c * 8) * 2;
        cp_async16(kd + off, pk + src, ok);
        cp_async16(vd + off, pv + src, ok);
      }
    } else {
      const int j0 = (t - n_ctx_t) * kAttnKeys;
#pragma unroll
      for (int i = tid; i < kAttnKeys * CH; i += kAttnThreads) {
        const int r = i / CH, c = i % CH;
        const int j = j0 + r;
        const bool ok = j < S;
        const size_t src =
            ok ? ((size_t(b) * S + j) * n_kv + h) * D + c * 8 : 0;
        const unsigned off = (r * LD + c * 8) * 2;
        cp_async16(kd + off, ck + src, ok);
        cp_async16(vd + off, cv + src, ok);
      }
    }
  };
  // the lane's two fragment rows, and the chunk keys they see (jc <= s)
  const int row0 = r0 + warp * 16 + (lane >> 2);
  const int ck_lim0 = min(S, row0 / group + 1);
  const int ck_lim1 = min(S, (row0 + 8) / group + 1);
  AttnWarp<D> w;
  w.run(base, n_t, sm_scale * kLog2e, stage_tile,
        [&](int t, int (&lim)[2]) {
          if (t < n_ctx_t) {
            lim[0] = lim[1] = n_ctx - t * kAttnKeys;
          } else {
            const int j0 = (t - n_ctx_t) * kAttnKeys;
            lim[0] = ck_lim0 - j0;
            lim[1] = ck_lim1 - j0;
          }
        });

  float row_lse[2];
  w.store(attn_smem, row_lse, [&](int r) -> __nv_bfloat16* {
    const int row = r0 + warp * 16 + r;
    return row < rows ? out + q_row(row) * D : nullptr;
  });
}

// Shared memory of the int8-pool read: Q, K and V as bf16 tiles in two
// stages (AttnSmem's layout), then the landing area of one context tile
// (its int8 K and V payload [64][D] and its 64 k and 64 v scales), then
// the scales of each bf16 stage.
template <int D>
struct PrefillI8Smem {
  using Tiles = AttnSmem<D>;
  static constexpr int I8_TILE = kAttnKeys * D;        // bytes
  static constexpr int SCALES = 2 * kAttnKeys * 4;     // bytes
  static constexpr unsigned K8 = Tiles::BYTES;
  static constexpr unsigned V8 = K8 + I8_TILE;
  static constexpr unsigned SC8 = V8 + I8_TILE;
  static __host__ __device__ constexpr unsigned SC(int stage) {
    return SC8 + (1 + stage) * SCALES;
  }
  static constexpr int BYTES = SC8 + 3 * SCALES;
};

// bytes 2 i and 2 i + 1 of w (int8) as one bf16x2 (or f16x2) register,
// exactly
template <bool F16>
__device__ __forceinline__ unsigned i8x2_to_16x2(unsigned w, int i) {
  const float lo = static_cast<float>(static_cast<int>(w << (24 - 16 * i))
                                      >> 24);
  const float hi = static_cast<float>(static_cast<int>(w << (16 - 16 * i))
                                      >> 24);
  return F16 ? pack_f16(lo, hi) : pack_bf16(lo, hi);
}

// 16 int8 payload values at `src` (shared) as 16 bf16 (or f16) at `dst`
template <bool F16>
__device__ __forceinline__ void i8x16_to_16(const unsigned char* src,
                                            unsigned char* dst) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(i8x2_to_16x2<F16>(w.x, 0), i8x2_to_16x2<F16>(w.x, 1),
                 i8x2_to_16x2<F16>(w.y, 0), i8x2_to_16x2<F16>(w.y, 1));
  *reinterpret_cast<uint4*>(dst + 16) =
      make_uint4(i8x2_to_16x2<F16>(w.z, 0), i8x2_to_16x2<F16>(w.z, 1),
                 i8x2_to_16x2<F16>(w.w, 0), i8x2_to_16x2<F16>(w.w, 1));
}

// The int8-pool read with bf16 activations on the tensor cores (see the
// header): q / out [B, S, H, D] and ck / cv [B, S, n_kv, D] bf16, pools
// pk / pv [n_pages, page, n_kv, D] int8, scale pools ks / vs [n_pages,
// page, n_kv] f32.
template <int D>
__global__ void __launch_bounds__(kAttnThreads, 2)
prefill_read_i8_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ ck,
                           const __nv_bfloat16* __restrict__ cv,
                           const int8_t* __restrict__ pk,
                           const int8_t* __restrict__ pv,
                           const float* __restrict__ ks,
                           const float* __restrict__ vs,
                           const int* __restrict__ table,
                           const int* __restrict__ starts,
                           __nv_bfloat16* __restrict__ out, int S, int H,
                           int n_kv, int page, int max_pages, int n_pages,
                           float sm_scale) {
  using Sm = PrefillI8Smem<D>;
  using Tiles = AttnSmem<D>;
  constexpr int LD = Tiles::LD, CH = Tiles::CHUNKS, CH8 = D / 16;
  static_assert(kAttnThreads == 2 * kAttnKeys, "one scale copy a thread");
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const unsigned base = smem_u32(attn_smem);

  const int r0 = (gridDim.x - 1 - blockIdx.x) * kAttnRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / n_kv;
  const int rows = S * group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_ctx = min(starts[b], max_pages * page);
  const int* row_table = table + size_t(b) * max_pages;

  // grouped query row r0 + r -> q[b, r / group, h * group + r % group]
  auto q_row = [&](int row) {
    return (size_t(b) * S + row / group) * H + h * group + row % group;
  };
#pragma unroll
  for (int i = tid; i < kAttnRows * CH; i += kAttnThreads) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < rows;
    cp_async16(base + Tiles::Q + (r * LD + c * 8) * 2,
               ok ? q + q_row(r0 + r) * D + c * 8 : q, ok);
  }
  cp_async_commit();

  // context tiles first (every chunk query sits at or past `start`, so
  // all keys j < n_ctx are visible), then the chunk's own keys up to the
  // tile's last query position
  const int n_ctx_t = (n_ctx + kAttnKeys - 1) / kAttnKeys;
  const int n_ck = min(S, (min(rows, r0 + kAttnRows) - 1) / group + 1);
  const int n_t = n_ctx_t + (n_ck + kAttnKeys - 1) / kAttnKeys;
  // (token j, head h) of the pool, clipped into it as a JAX gather clips
  auto pool_row = [&](int j) {
    const int phys = min(max(row_table[j / page], 0), n_pages - 1);
    return (size_t(phys) * page + j % page) * n_kv + h;
  };
  // context tile t's payload and scales into the landing area; keys at
  // or past n_ctx land as zeros (and are masked all the same)
  auto land = [&](int t) {
    const int j0 = t * kAttnKeys;
#pragma unroll
    for (int i = tid; i < kAttnKeys * CH8; i += kAttnThreads) {
      const int r = i / CH8, c = i % CH8;
      const bool ok = j0 + r < n_ctx;
      const size_t src = ok ? pool_row(j0 + r) * D + c * 16 : 0;
      cp_async16(base + Sm::K8 + r * D + c * 16, pk + src, ok);
      cp_async16(base + Sm::V8 + r * D + c * 16, pv + src, ok);
    }
    // thread i < 64 copies key i's k scale, thread 64 + i its v scale
    const int r = tid & (kAttnKeys - 1);
    const bool ok = j0 + r < n_ctx;
    cp_async4(base + Sm::SC8 + tid * 4,
              (tid < kAttnKeys ? ks : vs) + (ok ? pool_row(j0 + r) : 0), ok);
  };
  // tile t into bf16 stage st: a context tile converted from the landing
  // area with its scales, a chunk tile copied in with scale 1
  auto prepare = [&](int t, int st) {
    float* sc = reinterpret_cast<float*>(attn_smem + Sm::SC(st));
    if (t < n_ctx_t) {
      // K as bf16 (for the bf16 q), V as f16 (for P' in f16)
#pragma unroll
      for (int i = tid; i < kAttnKeys * CH8; i += kAttnThreads) {
        const int r = i / CH8, c = i % CH8;
        const unsigned src = r * D + c * 16, dst = (r * LD + c * 16) * 2;
        i8x16_to_16<false>(attn_smem + Sm::K8 + src,
                           attn_smem + Tiles::K(st) + dst);
        i8x16_to_16<true>(attn_smem + Sm::V8 + src,
                          attn_smem + Tiles::V(st) + dst);
      }
      sc[tid] = reinterpret_cast<const float*>(attn_smem + Sm::SC8)[tid];
    } else {
      const int j0 = (t - n_ctx_t) * kAttnKeys;
#pragma unroll
      for (int i = tid; i < kAttnKeys * CH; i += kAttnThreads) {
        const int r = i / CH, c = i % CH;
        const int j = j0 + r;
        const bool ok = j < S;
        const size_t src =
            ok ? ((size_t(b) * S + j) * n_kv + h) * D + c * 8 : 0;
        const unsigned off = (r * LD + c * 8) * 2;
        cp_async16(base + Tiles::K(st) + off, ck + src, ok);
        cp_async16(base + Tiles::V(st) + off, cv + src, ok);
      }
      sc[tid] = 1.f;
    }
  };

  if (n_ctx_t > 0) land(0);
  cp_async_commit();
  cp_async_wait<0>();       // the Q tile and tile 0's payload landed
  __syncthreads();
  prepare(0, 0);
  __syncthreads();          // the landing area read before it is refilled
  if (n_ctx_t > 1) land(1);
  cp_async_commit();

  unsigned qf[D / 16][4];   // Q as A fragments, one per k16 step
  load_a<D>(qf, base + Tiles::Q + warp * 16 * LD * 2, lane);
  float o[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float scale2 = sm_scale * kLog2e;
  const int c = (lane & 3) * 2;
  // the lane's two fragment rows, and the chunk keys they see (jc <= s)
  const int row0 = r0 + warp * 16 + (lane >> 2);
  const int ck_lim0 = min(S, row0 / group + 1);
  const int ck_lim1 = min(S, (row0 + 8) / group + 1);

  for (int t = 0; t < n_t; ++t) {
    cp_async_wait<0>();     // tile t's copies and tile t + 1's payload
    __syncthreads();        // landed; tile t - 1 is done with its stage
    if (t + 1 < n_t) prepare(t + 1, (t + 1) & 1);
    __syncthreads();        // the landing area read before it is refilled
    if (t + 2 < n_ctx_t) land(t + 2);
    cp_async_commit();

    const int st = t & 1;
    const float* ksc = reinterpret_cast<const float*>(attn_smem + Sm::SC(st));
    const float* vsc = ksc + kAttnKeys;
    int lim[2];
    if (t < n_ctx_t) {
      lim[0] = lim[1] = n_ctx - t * kAttnKeys;
    } else {
      const int j0 = (t - n_ctx_t) * kAttnKeys;
      lim[0] = ck_lim0 - j0;
      lim[1] = ck_lim1 - j0;
    }
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    mma_scores<D, 8>(
        s,
        [&](int kk, unsigned (&f)[4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) f[e] = qf[kk][e];
        },
        base + Tiles::K(st), lane);

    // each column's k scale (times sm_scale log2 e), the mask, the
    // running max over the quad that shares a row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 kf = *reinterpret_cast<const float2*>(ksc + n * 8 + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        float x = s[n][e] * ((e & 1 ? kf.y : kf.x) * scale2);
        if (n * 8 + c + (e & 1) >= lim[hh]) x = NEG_INF;
        s[n][e] = x;
        mx[hh] = fmaxf(mx[hh], x);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float alpha = exp2f(m[hh] - mx[hh]);
      m[hh] = mx[hh];
      l[hh] *= alpha;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * hh] *= alpha;
        o[n][2 * hh + 1] *= alpha;
      }
    }

    // p in f32 for l; a context tile's P' = p times its column's v scale
    // as f16 A fragments of O += P' V_int, a chunk tile's p as bf16 ones
    // of O += P V (as the bf16-pool kernel rounds p)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 vf = *reinterpret_cast<const float2*>(vsc + n * 8 + c);
      const float p0 = exp2f(s[n][0] - mx[0]);
      const float p1 = exp2f(s[n][1] - mx[0]);
      const float p2 = exp2f(s[n][2] - mx[1]);
      const float p3 = exp2f(s[n][3] - mx[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      s[n][0] = p0 * vf.x;
      s[n][1] = p1 * vf.y;
      s[n][2] = p2 * vf.x;
      s[n][3] = p3 * vf.y;
    }
    unsigned pf[4][4];
    if (t < n_ctx_t) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        c_to_a_f16(pf[kk], s[2 * kk], s[2 * kk + 1]);
      mma_accumulate_f16<D, 4>(o, pf, base + Tiles::V(st), lane);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) c_to_a(pf[kk], s[2 * kk], s[2 * kk + 1]);
      mma_accumulate<D, 4>(o, pf, base + Tiles::V(st), lane);
    }
  }

  // O / l (l summed over the quad, clamped at 1e-30) out through the
  // warp's own Q rows
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lv = l[hh];
    lv += __shfl_xor_sync(0xffffffffu, lv, 1);
    lv += __shfl_xor_sync(0xffffffffu, lv, 2);
    inv[hh] = 1.f / fmaxf(lv, 1e-30f);
  }
  store_rows<D>(reinterpret_cast<__nv_bfloat16*>(attn_smem + Tiles::Q) +
                    warp * 16 * LD,
                o, inv[0], inv[1], lane, [&](int r) -> __nv_bfloat16* {
                  const int row = r0 + warp * 16 + r;
                  return row < rows ? out + q_row(row) * D : nullptr;
                });
}

template <int D>
static int launch_prefill_read_i8_mma(dim3 grid, cudaStream_t st,
                                      const void* q, const void* ck,
                                      const void* cv, const void* pk,
                                      const void* pv, const float* ks,
                                      const float* vs, const int* table,
                                      const int* starts, void* out, int S,
                                      int H, int n_kv, int page,
                                      int max_pages, int n_pages,
                                      float sm_scale) {
  using BF = __nv_bfloat16;
  constexpr int smem = PrefillI8Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      prefill_read_i8_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  prefill_read_i8_mma_kernel<D><<<grid, kAttnThreads, smem, st>>>(
      static_cast<const BF*>(q), static_cast<const BF*>(ck),
      static_cast<const BF*>(cv), static_cast<const int8_t*>(pk),
      static_cast<const int8_t*>(pv), ks, vs, table, starts,
      static_cast<BF*>(out), S, H, n_kv, page, max_pages, n_pages, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
static int launch_prefill_read_mma(dim3 grid, cudaStream_t st,
                                   const void* q, const void* ck,
                                   const void* cv, const void* pk,
                                   const void* pv, const int* table,
                                   const int* starts, void* out, int S,
                                   int H, int n_kv, int page, int max_pages,
                                   int n_pages, float sm_scale) {
  using BF = __nv_bfloat16;
  constexpr int smem = AttnSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      prefill_read_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  prefill_read_mma_kernel<D><<<grid, kAttnThreads, smem, st>>>(
      static_cast<const BF*>(q), static_cast<const BF*>(ck),
      static_cast<const BF*>(cv), static_cast<const BF*>(pk),
      static_cast<const BF*>(pv), table, starts, static_cast<BF*>(out), S, H,
      n_kv, page, max_pages, n_pages, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TK, int DH>
static int launch_prefill_read(dim3 grid, cudaStream_t st, const void* q,
                               const void* ck, const void* cv, const void* pk,
                               const void* pv, const float* ks,
                               const float* vs, const int* table,
                               const int* starts, void* out, int S, int H,
                               int n_kv, int page, int max_pages, int n_pages,
                               float sm_scale) {
  constexpr int smem = prefill_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      prefill_read_kernel<T, TK, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  prefill_read_kernel<T, TK, DH><<<grid, kNT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck),
      static_cast<const T*>(cv), static_cast<const TK*>(pk),
      static_cast<const TK*>(pv), ks, vs, table, starts, static_cast<T*>(out),
      S, H, n_kv, page, max_pages, n_pages, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TK>
static int launch_prefill_read_dh(int Dh, dim3 grid, cudaStream_t st,
                                  const void* q, const void* ck,
                                  const void* cv, const void* pk,
                                  const void* pv, const float* ks,
                                  const float* vs, const int* table,
                                  const int* starts, void* out, int S, int H,
                                  int n_kv, int page, int max_pages,
                                  int n_pages, float sm_scale) {
  if (Dh == 128)
    return launch_prefill_read<T, TK, 128>(grid, st, q, ck, cv, pk, pv, ks,
                                           vs, table, starts, out, S, H,
                                           n_kv, page, max_pages, n_pages,
                                           sm_scale);
  if (Dh == 64)
    return launch_prefill_read<T, TK, 64>(grid, st, q, ck, cv, pk, pv, ks,
                                          vs, table, starts, out, S, H, n_kv,
                                          page, max_pages, n_pages, sm_scale);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
static int launch_page_write_int8(int Dh, cudaStream_t st, const void* k,
                                  const void* v, void* pk, void* pv,
                                  float* ks, float* vs, void* ck, void* cv,
                                  const int* table, const int* starts, int B,
                                  int S, int n_kv, int page, int max_pages,
                                  int n_pages) {
  const int rows = B * S * n_kv;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  // 4 rows a warp while that still leaves 8 warps an SM, else 1
  const bool wide = rows >= 4 * 8 * sm_count();
  const int warps = wide ? (rows + 3) / 4 : rows;
  const int grid = (warps + kWriteWarps - 1) / kWriteWarps;
#define TOS_WRITE8(EPT, RW)                                                 \
  page_write_int8_kernel<T, EPT, RW><<<grid, 32 * kWriteWarps, 0, st>>>(    \
      static_cast<const T*>(k), static_cast<const T*>(v),                   \
      static_cast<int8_t*>(pk), static_cast<int8_t*>(pv), ks, vs,           \
      static_cast<T*>(ck), static_cast<T*>(cv), table, starts, B, S, n_kv,  \
      page, max_pages, n_pages)
  if (Dh == 128 && wide)
    TOS_WRITE8(4, 4);
  else if (Dh == 128)
    TOS_WRITE8(4, 1);
  else if (Dh == 64 && wide)
    TOS_WRITE8(2, 4);
  else if (Dh == 64)
    TOS_WRITE8(2, 1);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef TOS_WRITE8
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tos

// The page write of a float pool: k / v [B, S, n_kv, Dh] in the pool's
// dtype, row_bytes = n_kv * Dh * its size (a multiple of 16), every
// pointer 16-byte aligned.
extern "C" int tos_page_write(const void* k, const void* v, void* pk,
                              void* pv, const int* table, const int* starts,
                              int B, int S, int row_bytes, int page,
                              int max_pages, int n_pages, void* stream) {
  using namespace tos;
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
      reinterpret_cast<uintptr_t>(pk) | reinterpret_cast<uintptr_t>(pv);
  if (row_bytes % 16 || addr % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * S == 0) return static_cast<int>(cudaSuccess);
  const int grid = (B * S + kWriteWarps - 1) / kWriteWarps;
  page_write_kernel<<<grid, 32 * kWriteWarps, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(k), static_cast<const uint4*>(v),
      static_cast<uint4*>(pk), static_cast<uint4*>(pv), table, starts, B, S,
      row_bytes / 16, page, max_pages, n_pages);
  return static_cast<int>(cudaGetLastError());
}

// The page write of an int8 pool: k / v [B, S, n_kv, Dh] in `dtype`,
// payload pools pk / pv int8, scale pools ks / vs f32 [NP, page, n_kv],
// ck / cv [B, S, n_kv, Dh] in `dtype` receive the dequantised chunk.
extern "C" int tos_page_write_int8(const void* k, const void* v, void* pk,
                                   void* pv, float* ks, float* vs, void* ck,
                                   void* cv, const int* table,
                                   const int* starts, int B, int S, int n_kv,
                                   int Dh, int page, int max_pages,
                                   int n_pages, int dtype, void* stream) {
  using namespace tos;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TOS_ARGS                                                          \
  Dh, st, k, v, pk, pv, ks, vs, ck, cv, table, starts, B, S, n_kv, page, \
      max_pages, n_pages
  if (dtype == kBF16) return launch_page_write_int8<__nv_bfloat16>(TOS_ARGS);
  if (dtype == kF32) return launch_page_write_int8<float>(TOS_ARGS);
#undef TOS_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// kv_dtype: the pool's storage code, q's dtype or kI8 (then ks / vs are
// the f32 scale pools; otherwise they are unused).
extern "C" int tos_prefill_read(const void* q, const void* ck, const void* cv,
                                const void* pk, const void* pv,
                                const float* ks, const float* vs,
                                const int* table, const int* starts, void* out,
                                int B, int S, int H, int n_kv, int Dh,
                                int page, int max_pages, int n_pages,
                                float sm_scale, int dtype, int kv_dtype,
                                void* stream) {
  using namespace tos;
  const int rows = S * (H / n_kv);
  const dim3 grid((rows + kBR - 1) / kBR, n_kv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TOS_ARGS                                                          \
  Dh, grid, st, q, ck, cv, pk, pv, ks, vs, table, starts, out, S, H, n_kv, \
      page, max_pages, n_pages, sm_scale
  if (dtype == kBF16 && kv_dtype == kBF16) {
    // bf16 pools: the tensor cores
    if (Dh == 128)
      return launch_prefill_read_mma<128>(grid, st, q, ck, cv, pk, pv, table,
                                          starts, out, S, H, n_kv, page,
                                          max_pages, n_pages, sm_scale);
    if (Dh == 64)
      return launch_prefill_read_mma<64>(grid, st, q, ck, cv, pk, pv, table,
                                         starts, out, S, H, n_kv, page,
                                         max_pages, n_pages, sm_scale);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == kBF16 && kv_dtype == kI8) {
    // int8 pools, bf16 activations: the tensor cores, scales folded
    if (Dh == 128)
      return launch_prefill_read_i8_mma<128>(grid, st, q, ck, cv, pk, pv, ks,
                                             vs, table, starts, out, S, H,
                                             n_kv, page, max_pages, n_pages,
                                             sm_scale);
    if (Dh == 64)
      return launch_prefill_read_i8_mma<64>(grid, st, q, ck, cv, pk, pv, ks,
                                            vs, table, starts, out, S, H,
                                            n_kv, page, max_pages, n_pages,
                                            sm_scale);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == kF32 && kv_dtype == kF32)
    return launch_prefill_read_dh<float, float>(TOS_ARGS);
  if (dtype == kF32 && kv_dtype == kI8)
    return launch_prefill_read_dh<float, int8_t>(TOS_ARGS);
#undef TOS_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
