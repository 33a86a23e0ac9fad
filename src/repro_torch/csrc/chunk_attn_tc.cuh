// Tensor-core machinery of the chunk-attention kernels for Hopper (sm_90a):
// TMA tile loads under mbarriers, wgmma products (their PTX, and
// issue_scores(), in hopper_tc.cuh, shared with K4), and the online-softmax
// tile update on wgmma fragments. chunk_attn.cu includes it; the bf16
// bodies of K1 (chunk attention), K2 (pool attention over a slot stack)
// and K3 (the same over pages read in place) are one kernel built from it,
// attn_tc_kernel, over three unit walks.
//
// The pieces:
//   Ring          STAGES stages of K and V tiles in shared memory; K and V
//                 each have a "full" mbarrier (TMA bytes landed) and an
//                 "empty" one (the consumer warpgroup is done with it).
//   Tiles         a producer source: a unit's K/V tiles as TMA loads, in
//                 the order of a cursor that knows where each tile lies:
//                 DenseCursor, the tiles of one (batch row, kv head) of
//                 k/v [B,T,KVH,D] (K1); SlotCursor, the tiles of the valid
//                 slots of one group of k/v [S,G*B,T,KVH,D] (K2);
//                 PagedCursor, the same slots' pages of the store
//                 [G,P,B,pt,KVH,D] through the page handles (K3).
//   produce()     the producer's loop (one thread) over a source's tiles.
//   TileState, issue_scores(), softmax_max(), softmax_p(), issue_pv()
//                 the consumer: one warpgroup's 64 query rows, their fp32
//                 (m, l, acc) in wgmma fragments, and the update by one
//                 64-key tile: S = Q·K^T (wgmma, bf16 in, fp32 out), the
//                 mask on diagonal and tail tiles before the exponential,
//                 the online softmax in fp32, then acc += P·V as two
//                 register-A wgmmas, P = hi + lo (hi = bf16(p), lo =
//                 bf16(p - hi)), so that P·V keeps p to ~16 bits where one
//                 bf16 rounding of p would move acc by ~2e-3 of max|acc|.
//                 In parts, so that the next tile's S can run under this
//                 tile's exponentials.
//   widen_tile()  an int8 / fp8-e4m3 tile (exact in bf16) widened once into
//                 the swizzled bf16 layout the wgmma reads.
//   ChunkWalk, StackWalk, PagedWalk
//                 the units (64-row query blocks) of K1, K2 and K3, longest
//                 first, with their tile counts and cursors, and what a
//                 unit stores (K1: out, acc, m, l; K2, K3: acc, m, l).
//
// Head dims D = 64, 80, 112 and 128. Shared-memory layout of a bf16
// operand tile: 64 rows x 128 bytes per box (8 KB, the 128-byte swizzle of
// TMA and of the wgmma descriptors), ceil(D / 64) boxes for the head dim
// (one at D = 64; columns 0-63 and 64-127 at D = 80, 112 and 128). At D =
// 80 and 112 the second box's columns past D lie past the tensor's inner
// dimension, so TMA fills them with zeros (the widened 1-byte tiles zero
// them too); no product reads them: Q·K^T runs D / 16 k-steps, and P·V is
// a wgmma of N = D columns (n80, n112), whose accumulators end at D (out's
// TMA store clips the box at D; acc is stored up to D). A 32-byte swizzle
// in 16-column slabs would avoid the padding but needs D / 16 descriptors
// and boxes per tile instead of 2; the padding costs only shared memory,
// never device-memory bytes.
#pragma once

#include <cuda_fp8.h>

#include "hopper_tc.cuh"     // mbarriers, TMA, wgmma, descriptors, encoder

// Internal linkage, as in hopper_tc.cuh: the libraries built from
// chunk_attn.cu share no symbol, so no static of one is another's.
namespace {
namespace tc {

constexpr int BQ = 64;               // query rows of one unit: one consumer warpgroup
constexpr int BK = 64;               // keys per tile
constexpr int STAGES = 2;            // K/V ring depth (per consumer warpgroup)
constexpr int QBUFS = 3;             // Q tiles in flight (per consumer warpgroup)
constexpr int NCONSUMER = 2 * WG;    // two consumer warpgroups
constexpr int NTHREADS = NCONSUMER + WG;   // + a producer warpgroup
// setmaxnreg: the producer warpgroup's registers go to the consumers
// (128 x 40 + 256 x 232 <= 65536, one block an SM)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------- tile layouts

// The head dims the tensor-core body is built for (chunk_attn.cu routes
// bf16 q at these to it, statically).
__host__ __device__ constexpr bool tc_head_dim(int d) {
  return d == 64 || d == 80 || d == 112 || d == 128;
}

// 64-column swizzled boxes of a bf16 row of D columns: a Q tile, a bf16 K
// or V tile, a widened 1-byte one.
template <int D>
constexpr int NBOX = (D + 63) / 64;

// How one 64-key tile of K (or V) of storage type TKV lands: 16-bit tiles
// as NBOX<D> swizzled boxes that the wgmma reads in place; 1-byte tiles
// as one dense [64][D] box, widened to bf16 before use.
template <typename TKV, int D>
struct KVBox {
  static constexpr bool WIDE = sizeof(TKV) == 2;
  static constexpr int BOXES = WIDE ? NBOX<D> : 1;
  static constexpr int COLS = WIDE ? 64 : D;           // box width (elements)
  static constexpr uint32_t BYTES = BK * COLS * sizeof(TKV);
  static constexpr int TILE = WIDE ? BOXES * BOX : BOX;   // bytes a K (or V) tile takes
};

// K and V tiles have barriers of their own, so that a K tile's stage is
// refilled as soon as its scores are done, while its V tile is still read.
template <typename TKV, int D>
struct Ring {
  unsigned char* tiles;          // [STAGES][K | V][KVBox::TILE]
  uint64_t* bars;                // kfull, kempty, vfull, vempty: [STAGES] each
  __device__ unsigned char* k(int s) const { return tiles + s * 2 * KVBox<TKV, D>::TILE; }
  __device__ unsigned char* v(int s) const { return k(s) + KVBox<TKV, D>::TILE; }
  __device__ uint64_t* kfull(int s) const { return bars + s; }
  __device__ uint64_t* kempty(int s) const { return bars + STAGES + s; }
  __device__ uint64_t* vfull(int s) const { return bars + 2 * STAGES + s; }
  __device__ uint64_t* vempty(int s) const { return bars + 3 * STAGES + s; }
};

// Where the tiles of one unit lie: each cursor knows the first key `key0`
// of the current tile, loads the current tile's box of columns
// [col, col + box width) of kv head hk into dst (load()), and steps to the
// next tile (next()). The producer and the consumer warpgroup each walk a
// unit's tiles with their own cursor, in one order. K1 and K2 read a 4-D
// tensor [rows, T, KVH, D] at row `row4`.

// K1: the tiles of one batch row b of k/v [B,T,KVH,D], 64 keys each.
struct DenseCursor {
  int row4, key0;
  __device__ void next() { key0 += BK; }
  __device__ void load(const CUtensorMap* map, unsigned char* dst, uint64_t* bar, int col,
                       int hk, int) const {
    tma_load_4d(dst, map, bar, col, hk, key0, row4);
  }
};

// The first slot at or after s whose bit is set in `bits` (one bit a slot,
// 32 a word; -1: none).
__device__ __forceinline__ int first_valid(const uint32_t* bits, int words, int s) {
  for (int w = s >> 5; w < words; ++w) {
    const uint32_t x = bits[w] & (w == (s >> 5) ? ~0u << (s & 31) : ~0u);
    if (x) return (w << 5) + __ffs(x) - 1;
  }
  return -1;
}

// K2: the tiles of the valid slots of one group, slot by slot (tps tiles a
// slot), of k/v [S,GB,T,KVH,D] seen as [S*GB, T, KVH, D]: tile j of slot s
// of row bg is at row4 = s * GB + bg, key0 = j * 64. `bits` holds the
// group's valid slots.
struct SlotCursor {
  const uint32_t* bits;
  int words, GB, bg, tps;
  int slot, j, row4, key0;
  __device__ void start() {
    slot = first_valid(bits, words, 0);
    j = key0 = 0;
    row4 = slot * GB + bg;
  }
  __device__ void next() {
    if (++j == tps) {
      j = 0;
      slot = first_valid(bits, words, slot + 1);
      row4 = slot * GB + bg;
    }
    key0 = j * BK;
  }
  __device__ void load(const CUtensorMap* map, unsigned char* dst, uint64_t* bar, int col,
                       int hk, int) const {
    tma_load_4d(dst, map, bar, col, hk, key0, row4);
  }
};

// K3: the same walk over the valid slots, but a slot's keys are the pt
// tokens of each of its ppc pages, read in place from the page store
// [G,P,B,pt,KVH,D] through the page handles [S*ppc], as a 5-D tensor
// {D, KVH, pt, n3, n4}: (n3, n4) = (B, G*P) when the group stride is P
// page strides, else (G*B, P); the unit's row is at c3 on the 4th axis,
// its page h at c4 + h on the 5th. A 64-key tile is one box of a page (pt
// a multiple of 64) or 64 / pt boxes of whole pages (pt dividing 64, a
// multiple of 8, so each box keeps the 128-byte swizzle's phase). A page
// past the chunk's last (only in a tile past kv_len) loads the last page
// again: its keys are masked. sbase: the unit's per-page scale offset.
struct PagedCursor {
  const uint32_t* bits;
  const int* handles;
  int words, tps, ppc, pt, c3, c4;
  long long sbase;
  int slot, j, key0;
  __device__ void start() {
    slot = first_valid(bits, words, 0);
    j = key0 = 0;
  }
  __device__ void next() {
    if (++j == tps) {
      j = 0;
      slot = first_valid(bits, words, slot + 1);
    }
    key0 = j * BK;
  }
  __device__ int handle(int tok) const { return handles[slot * ppc + min(tok / pt, ppc - 1)]; }
  __device__ void load(const CUtensorMap* map, unsigned char* dst, uint64_t* bar, int col,
                       int hk, int rowbytes) const {
    const int sub = min(pt, BK);
    for (int r = 0; r < BK / sub; ++r) {
      const int tok = key0 + r * sub, page = tok / pt;
      tma_load_5d(dst + r * sub * rowbytes, map, bar, col, hk, page < ppc ? tok - page * pt : 0,
                  c3, c4 + handle(tok));
    }
  }
};

// A producer source: the ntiles K/V tiles of one (unit, kv head hk), in
// the cursor's order, as TMA loads; rows past the tensor's end land as
// zeros (TMA's out-of-bounds fill), never as rows of the next row4 or page.
template <typename TKV, int D, class Cursor>
struct Tiles {
  const CUtensorMap* k;
  const CUtensorMap* v;
  int hk, ntiles;
  Cursor cur;
  static constexpr uint32_t TILE_TX = KVBox<TKV, D>::BOXES * KVBox<TKV, D>::BYTES;
  // the current tile of k (or v) into dst, completing on bar
  __device__ void load(const CUtensorMap* map, unsigned char* dst, uint64_t* bar) const {
#pragma unroll
    for (int c = 0; c < KVBox<TKV, D>::BOXES; ++c)
      cur.load(map, dst + c * BOX, bar, c * 64, hk,
               KVBox<TKV, D>::COLS * (int)sizeof(TKV));
  }
};

// The producer's loop (one thread) over a source's tiles, keeping STAGES
// in flight; `done` tiles went through the ring before. Returns the count
// after these.
template <typename TKV, int D, class Src>
__device__ int produce(Src src, const Ring<TKV, D>& ring, int done) {
  for (int t = 0; t < src.ntiles; ++t, src.cur.next()) {
    const int u = done + t, s = u % STAGES;
    const uint32_t parity = ((u / STAGES) + 1) & 1;
    if (u >= STAGES) mbar_wait(ring.kempty(s), parity);
    mbar_expect_tx(ring.kfull(s), Src::TILE_TX);
    src.load(src.k, ring.k(s), ring.kfull(s));
    if (u >= STAGES) mbar_wait(ring.vempty(s), parity);
    mbar_expect_tx(ring.vfull(s), Src::TILE_TX);
    src.load(src.v, ring.v(s), ring.vfull(s));
  }
  return done + src.ntiles;
}

// ------------------------------------------------------ 1-byte K/V tiles

template <typename TKV>
__device__ __forceinline__ float byte_to_f32(uint32_t x);
template <>
__device__ __forceinline__ float byte_to_f32<int8_t>(uint32_t x) {
  return static_cast<float>(static_cast<int8_t>(x & 0xff));
}
template <>
__device__ __forceinline__ float byte_to_f32<__nv_fp8_e4m3>(uint32_t x) {
  __nv_fp8_e4m3 f;
  f.__x = static_cast<__nv_fp8_storage_t>(x & 0xff);
  return static_cast<float>(f);
}

// A landed [64][D] byte tile -> NBOX<D> swizzled bf16 boxes (exact:
// int8 and e4m3 values are bf16 values); the columns past D of the last
// box become zeros, as TMA fills a bf16 tile's. tid: the thread's index in
// its warpgroup.
template <typename TKV, int D>
__device__ __forceinline__ void widen_tile(const unsigned char* raw, unsigned char* dst,
                                           int tid) {
  constexpr int UNITS = 8 * NBOX<D>;               // 16-byte units of a bf16 row
#pragma unroll 2
  for (int i = tid; i < BK * UNITS; i += WG) {
    const int r = i / UNITS, u = i % UNITS;            // row, 16-byte unit of the bf16 row
    uint4 w = make_uint4(0, 0, 0, 0);
    if (u * 8 < D) {
      const uint2 x = *reinterpret_cast<const uint2*>(raw + r * D + u * 8);
      const uint32_t lo = x.x, hi = x.y;
      w.x = pack_bf16(__float2bfloat16_rn(byte_to_f32<TKV>(lo)),
                      __float2bfloat16_rn(byte_to_f32<TKV>(lo >> 8)));
      w.y = pack_bf16(__float2bfloat16_rn(byte_to_f32<TKV>(lo >> 16)),
                      __float2bfloat16_rn(byte_to_f32<TKV>(lo >> 24)));
      w.z = pack_bf16(__float2bfloat16_rn(byte_to_f32<TKV>(hi)),
                      __float2bfloat16_rn(byte_to_f32<TKV>(hi >> 8)));
      w.w = pack_bf16(__float2bfloat16_rn(byte_to_f32<TKV>(hi >> 16)),
                      __float2bfloat16_rn(byte_to_f32<TKV>(hi >> 24)));
    }
    *reinterpret_cast<uint4*>(dst + (u >> 3) * BOX + r * 128 + (((u & 7) ^ (r & 7)) << 4)) = w;
  }
}

// ------------------------------------------------------------- consumer

// One thread's share of a warpgroup's 64 query rows: rows g and g + 8 of
// its warp's 16 (g = lane / 4), in the wgmma accumulator layout:
// o[4j + 2r + e] is row (g + 8r), column 8j + 2(lane % 4) + e. m is the row
// max of the scaled scores (natural-log units, as the reference), l this
// thread's part of the row sum (summed over the row's 4 lanes at the end).
template <int D>
struct TileState {
  float m[2], l[2];
  float o[D / 2];
  __device__ void init() {
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  }
};

// The rest of the update of `st` by one 64-key tile whose scores s have
// landed (with issue_scores, the counterpart of the reference's
// _block_update), in three parts, so that a caller can have the next
// tile's scores on the tensor cores from the second on: no part writes s,
// and only the first writes acc (ptxas serializes wgmma groups around an
// instruction that defines a wgmma's accumulator while one is in flight).
// QUANT: ksc / vsc are the tile's per-key fp32 scales; the k scale
// multiplies the score columns after Q·K^T, the v scale is folded into p
// (after l takes p unscaled) before the hi / lo split. `masked` tiles (the
// causal diagonal, the kv_len tail) drop every key past lim[r], the last
// key row r may see, before the exponential, so no 0·inf is ever formed;
// a row that sees no key keeps (-1e30, 0, 0) exactly.
struct TileScores {
  const float* ksc;
  const float* vsc;
  float scale;
  bool masked;
  int key0;
  int lim[2];
  int tig;
  // score (j, r, e) of the tile: row g + 8r, column 8j + 2 tig + e
  template <bool QUANT>
  __device__ __forceinline__ float at(const float (&s)[32], int j, int r, int e) const {
    const int col = 8 * j + 2 * tig + e;
    float x = s[4 * j + 2 * r + e] * scale;
    if (QUANT) x *= ksc[col];
    return masked && key0 + col > lim[r] ? NEG_INF : x;
  }
};

// 1. the new row max: m, and acc rescaled by corr; returns msafe (the max
// the exponentials are taken against) and corr.
template <int D, bool QUANT>
__device__ __forceinline__ void softmax_max(TileState<D>& st, const float (&s)[32],
                                            const TileScores& sc, float (&msafe)[2],
                                            float (&corr)[2]) {
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) mx[r] = fmaxf(mx[r], sc.at<QUANT>(s, j, r, e));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // a row with nothing visible yet: exp against 0, so p == 0, not exp(0)
    msafe[r] = mx[r] < NEG_INF / 2 ? 0.f : mx[r];
    corr[r] = exp2_approx((st.m[r] - msafe[r]) * LOG2E);
    st.m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      st.o[4 * j + 2 * r] *= corr[r];
      st.o[4 * j + 2 * r + 1] *= corr[r];
    }
}

// 2. p, l, and P = hi + lo as register A fragments (k-step ks: keys
// 16ks..16ks+15 are accumulator columns j = 2ks, 2ks + 1).
template <int D, bool QUANT>
__device__ __forceinline__ void softmax_p(TileState<D>& st, const float (&s)[32],
                                          const TileScores& sc, const float (&msafe)[2],
                                          const float (&corr)[2], uint32_t (&hi)[16],
                                          uint32_t (&lo)[16]) {
  float psum[2] = {0.f, 0.f};
  const float ml[2] = {msafe[0] * LOG2E, msafe[1] * LOG2E};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = exp2_approx(fmaf(sc.at<QUANT>(s, j, r, e), LOG2E, -ml[r]));
        psum[r] += p[e];
        if (QUANT) p[e] *= sc.vsc[8 * j + 2 * sc.tig + e];
      }
      const __nv_bfloat16 h0 = __float2bfloat16_rn(p[0]), h1 = __float2bfloat16_rn(p[1]);
      const int a = 4 * (j >> 1) + 2 * (j & 1) + r;    // a0: (g, lo keys), a1: (g+8, lo),
      hi[a] = pack_bf16(h0, h1);                       // a2: (g, hi keys), a3: (g+8, hi)
      lo[a] = pack_bf16(__float2bfloat16_rn(p[0] - __bfloat162float(h0)),
                        __float2bfloat16_rn(p[1] - __bfloat162float(h1)));
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * corr[r] + psum[r];
}

// 3. acc += hi·V + lo·V, issued as one wgmma commit group: four k-steps of
// 16 keys, V [64 keys][D] bf16 read MN-major (LBO: the next 64 head-dim
// columns, one box on; SBO: the next 8 keys), N = D columns. The caller
// waits for it.
template <int D>
__device__ __forceinline__ void issue_pv(TileState<D>& st, uint32_t (&hi)[16],
                                         uint32_t (&lo)[16], const unsigned char* v) {
  uint64_t dv[4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) dv[ks] = sw128_desc(v + ks * 2048, BOX, 1024);
  keep(dv);
  keep(hi);
  keep(lo);
  keep(st.o);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int a = 4 * ks;
    if constexpr (D == 128) {
      wgmma_rs_n128(st.o, hi[a], hi[a + 1], hi[a + 2], hi[a + 3], dv[ks]);
      wgmma_rs_n128(st.o, lo[a], lo[a + 1], lo[a + 2], lo[a + 3], dv[ks]);
    } else if constexpr (D == 112) {
      wgmma_rs_n112(st.o, hi[a], hi[a + 1], hi[a + 2], hi[a + 3], dv[ks]);
      wgmma_rs_n112(st.o, lo[a], lo[a + 1], lo[a + 2], lo[a + 3], dv[ks]);
    } else if constexpr (D == 80) {
      wgmma_rs_n80(st.o, hi[a], hi[a + 1], hi[a + 2], hi[a + 3], dv[ks]);
      wgmma_rs_n80(st.o, lo[a], lo[a + 1], lo[a + 2], lo[a + 3], dv[ks]);
    } else {
      static_assert(D == 64, "the tensor-core body takes D 64, 80, 112, 128");
      wgmma_rs_n64(st.o, hi[a], hi[a + 1], hi[a + 2], hi[a + 3], dv[ks]);
      wgmma_rs_n64(st.o, lo[a], lo[a + 1], lo[a + 2], lo[a + 3], dv[ks]);
    }
  }
  wgmma_commit();
  keep(st.o);
}

// ------------------------------------------------------- the unit walks

// A unit of work: one 64-row query block (rows q0..q0+63) of one query head
// h of Q / output row `row`, against ntiles K/V tiles of kv head hk; `grp`
// is K2's group.
struct Unit {
  int h, hk, row, q0, ntiles, grp;
};

// K1: the query blocks of q [B,C,H,D] against k/v [B,T,KVH,D] under the
// causal offset, numbered longest first: u = (z * B + b) * H + h for query
// block nqb - 1 - z. Tiles above the diagonal or at / past kv_len are not
// in a unit. out (bf16) leaves by TMA stores staged in the unit's Q tile,
// hence three Q tiles in flight.
struct ChunkWalk {
  static constexpr bool OUT = true;
  static constexpr int QBUFS = 3;
  static constexpr int TABLE = 0;                 // shared-memory bytes of setup()
  int B, C, H, KVH, T, nqb, causal_offset, kv_len;
  __device__ void setup(unsigned char*, int) const {}
  __device__ ChunkWalk bind(const unsigned char*) const { return *this; }
  __device__ int count() const { return nqb * B * H; }
  __device__ Unit at(int u) const {
    Unit x;
    x.h = u % H;
    x.hk = x.h / (H / KVH);
    x.row = (u / H) % B;
    x.q0 = (nqb - 1 - u / (H * B)) * BQ;
    x.grp = 0;
    const int last_q = min(x.q0 + BQ, C) - 1;
    const int rows = max(0, min(kv_len, last_q + causal_offset + 1));
    x.ntiles = (rows + BK - 1) / BK;
    return x;
  }
  __device__ DenseCursor tiles(const Unit& x) const { return DenseCursor{x.row, 0}; }
  // the per-token scale [B,T,KVH] of key `key` of the cursor's tile row
  __device__ size_t scale_at(const DenseCursor& c, int key, int hk) const {
    return ((size_t)c.row4 * T + key) * KVH + hk;
  }
};

constexpr int MAX_GROUPS = 64;                    // K2's stage groups
constexpr int MAX_WORDS = 1024;                   // K2's valid bits: G x ceil(S / 32) words

// K2: the query blocks of q [G*B,C,H,D] against the valid slots of their
// group g = row / B in k/v [S,G*B,T,KVH,D], every key below kv_len visible
// (the causal offset is kv_len, so only a slot's tail tile is masked).
// setup() collects valid [G,S] once a block into shared memory: one bit a
// slot, the count of valid slots of each group and the groups ordered by
// it, most first; units are numbered group by group in that order, so the
// longest go first. A group with no valid slot has units of no tile, which
// store the identity state (-1e30, 0, 0) without a K/V load. No out: two Q
// tiles in flight.
struct StackWalk {
  static constexpr bool OUT = false;
  static constexpr int QBUFS = 2;
  static constexpr int TABLE = 4 * (MAX_WORDS + 2 * MAX_GROUPS);
  int G, B, C, H, KVH, S, T, nqb, causal_offset, kv_len, tps, words;
  const uint8_t* valid;                           // [G, S] bool
  const uint32_t* bits;                           // [G][words]   (after bind)
  const int* nvalid;                              // [G]
  const int* order;                               // [G], most valid slots first
  __device__ void setup(unsigned char* table, int tid) const {
    uint32_t* b = reinterpret_cast<uint32_t*>(table);
    int* n = reinterpret_cast<int*>(b + MAX_WORDS);
    int* o = n + MAX_GROUPS;
    for (int i = tid; i < G * words; i += NTHREADS) b[i] = 0;
    __syncthreads();
    for (int i = tid; i < G * S; i += NTHREADS)   // one byte of valid a thread
      if (valid[i] != 0) atomicOr(&b[(i / S) * words + (i % S) / 32], 1u << ((i % S) & 31));
    __syncthreads();
    if (tid < G) {
      int c = 0;
      for (int w = 0; w < words; ++w) c += __popc(b[tid * words + w]);
      n[tid] = c;
    }
    __syncthreads();
    if (tid < G) {                                // rank: more slots first, then by index
      int r = 0;
      for (int g = 0; g < G; ++g) r += n[g] > n[tid] || (n[g] == n[tid] && g < tid);
      o[r] = tid;
    }
  }
  __device__ StackWalk bind(const unsigned char* table) const {
    StackWalk w = *this;
    w.bits = reinterpret_cast<const uint32_t*>(table);
    w.nvalid = reinterpret_cast<const int*>(w.bits + MAX_WORDS);
    w.order = w.nvalid + MAX_GROUPS;
    return w;
  }
  __device__ int count() const { return G * B * H * nqb; }
  __device__ Unit at(int u) const {
    const int per = B * H * nqb, r = u % per;
    Unit x;
    x.grp = order[u / per];
    x.h = r % H;
    x.hk = x.h / (H / KVH);
    x.row = x.grp * B + (r / H) % B;
    x.q0 = (r / (H * B)) * BQ;
    x.ntiles = nvalid[x.grp] * tps;
    return x;
  }
  __device__ SlotCursor tiles(const Unit& x) const {
    SlotCursor c{bits + x.grp * words, words, G * B, x.row, tps};
    c.start();
    return c;
  }
  // the per-token scale [S,GB,T,KVH] of key `key` of the cursor's slot
  __device__ size_t scale_at(const SlotCursor& c, int key, int hk) const {
    return ((size_t)c.row4 * T + key) * KVH + hk;
  }
};

// K3: K2's walk (T = ppc * pt, the chunk's tokens) over pages read in
// place: PagedCursor's tiles; per-page scales [G,P,B,KVH] by strides.
struct PagedWalk : StackWalk {
  const int* handles;                             // [S * ppc] int32
  int ppc, pt, P;
  bool gp;                                        // the group stride is P page strides
  long long ssg, ssp, ssb, ssh;                   // scale strides (elements)
  __device__ PagedWalk bind(const unsigned char* table) const {
    PagedWalk w = *this;
    static_cast<StackWalk&>(w) = StackWalk::bind(table);
    return w;
  }
  __device__ PagedCursor tiles(const Unit& x) const {
    const int g = x.grp, b = x.row - x.grp * B;
    PagedCursor c{bits + g * words, handles, words, tps, ppc, pt, gp ? b : x.row,
                  gp ? g * P : 0, g * ssg + b * ssb};
    c.start();
    return c;
  }
  __device__ size_t scale_at(const PagedCursor& c, int key, int hk) const {
    return (size_t)(c.sbase + (long long)c.handle(key) * ssp + hk * ssh);
  }
};

template <typename TKV, int D, int QBUFS, int TABLE>
struct TcSmem {   // byte offsets from a 1024-aligned base
  static constexpr bool QUANT = !KVBox<TKV, D>::WIDE;
  static constexpr int QTILE = NBOX<D> * BOX;  // a Q tile; a widened K (or V) tile
  // one consumer warpgroup's part (two parts, then both warpgroups' scales,
  // barriers and the walk's table)
  static constexpr int Q = 0;                     // QBUFS Q tiles (K1: then their out staging)
  static constexpr int RING = Q + QBUFS * QTILE;
  static constexpr int WIDE = RING + STAGES * 2 * KVBox<TKV, D>::TILE;   // widened K | V
  static constexpr int PART = WIDE + (QUANT ? 2 * QTILE : 0);
  static constexpr int SCALES = 2 * PART;         // per warpgroup: k | v scales
  static constexpr int BARS = SCALES + (QUANT ? 2 * 2 * BK * 4 : 0);
  static constexpr int NBARS = 4 * STAGES + 2 * QBUFS;   // the ring's, qfull, qempty
  static constexpr int TAB = BARS + 2 * NBARS * 8;
  static constexpr int BYTES = TAB + TABLE;
  static constexpr size_t DYNAMIC = BYTES + 1024;                        // + alignment slack
};

// ------------------------------------------------- the tensor-core body

// K1, K2 and K3 for bf16 q and bf16 / int8 / fp8 K/V at D = 64, 80, 112 or
// 128 (tc_head_dim): a
// persistent grid of one block an SM. Each block has two consumer
// warpgroups that walk their own units of the Walk (ChunkWalk: K1,
// StackWalk: K2), round robin over the grid's 2 x gridDim.x warpgroups in
// its longest-first order, and a producer warpgroup whose registers go to
// the consumers (setmaxnreg); one of its threads per consumer warpgroup
// loads that warpgroup's Q tiles (QBUFS in flight) and K/V tiles (a STAGES
// ring) by TMA, ahead across units, so that a unit's loads (and, K1, its
// predecessor's stores) run under products. In a unit, the scores of tile
// t + 1 run on the tensor cores during the exponentials of tile t (bf16
// tiles; 1-byte tiles are widened first, one at a time), and a K tile's
// stage is refilled once its scores are done. K1's out (bf16) leaves by
// TMA stores from the unit's own Q tile, swizzled; acc (fp32) by 8-byte
// stores that fill whole 32-byte sectors; m and l by plain stores. Rows
// past C and columns past D are never stored.
template <typename TKV, int D, class Walk>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
               const float* ks, const float* vs, float* m_out, float* l_out, float* acc_out,
               const Walk walk_in, float scale) {
  constexpr int QBUFS = Walk::QBUFS;
  using L = TcSmem<TKV, D, QBUFS, Walk::TABLE>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x;
  // whose unit stream: a consumer warpgroup's index, or a producer warp's;
  // read from lane 0 so that the compiler sees it warp-uniform (wgmma in a
  // branch it cannot prove uniform is serialized)
  const int wg = __shfl_sync(0xffffffffu, tid < NCONSUMER ? tid / WG : (tid - NCONSUMER) / 32, 0);
  unsigned char* smem = base + wg * L::PART;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::BARS) + wg * L::NBARS;
  const Ring<TKV, D> ring{smem + L::RING, bars};
  uint64_t* qfull = bars + 4 * STAGES;                    // [QBUFS]
  uint64_t* qempty = qfull + QBUFS;                       // [QBUFS]
  const int first = 2 * blockIdx.x + (wg & 1), stride = 2 * gridDim.x;
  const int C = walk_in.C, H = walk_in.H;

  walk_in.setup(base + L::TAB, tid);
  if (tid < 2) {
    uint64_t* b0 = reinterpret_cast<uint64_t*>(base + L::BARS) + tid * L::NBARS;
    for (int i = 0; i < 4 * STAGES; ++i)                 // full: TMA, empty: consumers
      mbar_init(&b0[i], (i / STAGES) % 2 == 0 ? 1 : WG);
    for (int i = 0; i < 2 * QBUFS; ++i) mbar_init(&b0[4 * STAGES + i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Walk walk = walk_in.bind(base + L::TAB);

  if (tid >= NCONSUMER) {                                 // ---- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == NCONSUMER || tid == NCONSUMER + 32) {      // one thread per consumer stream
      int done = 0, n = 0;
      for (int u = first; u < walk.count(); u += stride, ++n) {
        const Unit x = walk.at(u);
        const int qb = n % QBUFS;
        if (n >= QBUFS) mbar_wait(&qempty[qb], ((n / QBUFS) + 1) & 1);
        unsigned char* qt = smem + L::Q + qb * L::QTILE;
        mbar_expect_tx(&qfull[qb], L::QTILE);
#pragma unroll
        for (int c = 0; c < NBOX<D>; ++c)
          tma_load_4d(qt + c * BOX, &qmap, &qfull[qb], 64 * c, x.h, x.q0, x.row);
        using Src = Tiles<TKV, D, decltype(walk.tiles(x))>;
        done = produce(Src{&kmap, &vmap, x.hk, x.ntiles, walk.tiles(x)}, ring, done);
      }
    }
    return;
  }

  // --------------------------------------------------- consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wtid = tid & (WG - 1);
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int row[2] = {16 * warp + g, 16 * warp + g + 8};
  float* ksc = reinterpret_cast<float*>(base + L::SCALES) + wg * 2 * BK;
  float* vsc = ksc + BK;
  float sa[32], sb[32];                                   // scores (two tiles)
#pragma unroll
  for (int i = 0; i < 32; ++i) sa[i] = sb[i] = 0.f;
  int done = 0, n = 0;                                    // tiles through the ring, units
  for (int u = first; u < walk.count(); u += stride, ++n) {
    const Unit x = walk.at(u);
    const int h = x.h, hk = x.hk, q0 = x.q0;
    // from lane 0, so that ptxas sees the wgmmas' loop bounds warp-uniform
    // (K2's come from shared memory; a bound it cannot prove uniform
    // serializes the wgmmas)
    const int ntiles = __shfl_sync(0xffffffffu, x.ntiles, 0);
    const int causal_offset = walk.causal_offset, kv_len = walk.kv_len;
    auto cur = walk.tiles(x);
    const int qb = n % QBUFS;
    unsigned char* qt = smem + L::Q + qb * L::QTILE;
    const int lim[2] = {min(q0 + row[0] + causal_offset, kv_len - 1),
                        min(q0 + row[1] + causal_offset, kv_len - 1)};
    TileState<D> st;
    st.init();
    mbar_wait(&qfull[qb], (n / QBUFS) & 1);
    if constexpr (L::QUANT) {
      for (int t = 0; t < ntiles; ++t, cur.next()) {
        const int w = done + t, stage = w % STAGES, key0 = cur.key0;
        const bool masked = key0 + BK - 1 > q0 + causal_offset || key0 + BK > kv_len;
        mbar_wait(ring.kfull(stage), (w / STAGES) & 1);
        mbar_wait(ring.vfull(stage), (w / STAGES) & 1);
        wg_sync(wg);                     // the previous tile's wgmmas are done
        widen_tile<TKV, D>(ring.k(stage), smem + L::WIDE, wtid);
        widen_tile<TKV, D>(ring.v(stage), smem + L::WIDE + L::QTILE, wtid);
        {
          const int key = key0 + (wtid & (BK - 1));
          const float* src = wtid < BK ? ks : vs;
          ksc[wtid] = key < kv_len ? src[walk.scale_at(cur, key, hk)] : 0.f;
        }
        fence_async_smem();
        wg_sync(wg);
        mbar_arrive(ring.kempty(stage));
        mbar_arrive(ring.vempty(stage));
        issue_scores<D>(sa, qt, smem + L::WIDE);
        wgmma_wait0();
        keep(sa);
        const TileScores sc{ksc, vsc, scale, masked, key0, {lim[0], lim[1]}, tig};
        float msafe[2], corr[2];
        uint32_t hi[16], lo[16];
        softmax_max<D, true>(st, sa, sc, msafe, corr);
        softmax_p<D, true>(st, sa, sc, msafe, corr, hi, lo);
        issue_pv<D>(st, hi, lo, smem + L::WIDE + L::QTILE);
        wgmma_wait0();
        keep(st.o);
        keep(hi);
        keep(lo);
      }
    } else {
      // the scores of tile t + 1 go to the tensor cores after tile t's row
      // max (which rescales acc) and run under its exponentials; the two
      // score sets swap roles from tile to tile
      auto step = [&](int t, float (&now)[32], float (&nxt)[32]) {
        const int w = done + t, stage = w % STAGES, key0 = cur.key0;
        const bool masked = key0 + BK - 1 > q0 + causal_offset || key0 + BK > kv_len;
        wgmma_wait0();                   // the scores of tile t: its K is free
        keep(now);
        mbar_arrive(ring.kempty(stage));
        const TileScores sc{nullptr, nullptr, scale, masked, key0, {lim[0], lim[1]}, tig};
        float msafe[2], corr[2];
        softmax_max<D, false>(st, now, sc, msafe, corr);
        if (t + 1 < ntiles) {
          mbar_wait(ring.kfull((w + 1) % STAGES), ((w + 1) / STAGES) & 1);
          issue_scores<D>(nxt, qt, ring.k((w + 1) % STAGES));
        }
        uint32_t hi[16], lo[16];
        softmax_p<D, false>(st, now, sc, msafe, corr, hi, lo);
        mbar_wait(ring.vfull(stage), (w / STAGES) & 1);
        issue_pv<D>(st, hi, lo, ring.v(stage));
        wgmma_wait0();                   // this P·V and the next tile's scores
        keep(st.o);
        keep(hi);
        keep(lo);
        keep(nxt);
        mbar_arrive(ring.vempty(stage));
        cur.next();
      };
      if (ntiles > 0) {
        mbar_wait(ring.kfull(done % STAGES), (done / STAGES) & 1);
        issue_scores<D>(sa, qt, ring.k(done % STAGES));
      }
      for (int t = 0; t < ntiles; t += 2) {
        step(t, sa, sb);
        if (t + 1 < ntiles) step(t + 1, sb, sa);
      }
    }
    done += ntiles;

    // ---- this unit's outputs
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 1);
      st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 2);
    }
    wg_sync(wg);                         // every warp is done reading this Q tile
    if constexpr (Walk::OUT) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = row[r], sw = rr & 7, qi = q0 + rr;
        const float den = fmaxf(st.l[r], 1e-30f);
        float* arow = acc_out + (((size_t)x.row * C + qi) * H + h) * D + 2 * tig;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const float a0 = st.o[4 * j + 2 * r], a1 = st.o[4 * j + 2 * r + 1];
          *reinterpret_cast<uint32_t*>(qt + (j >> 3) * BOX + rr * 128 + (((j & 7) ^ sw) << 4) +
                                       4 * tig) =
              pack_bf16(__float2bfloat16_rn(a0 / den), __float2bfloat16_rn(a1 / den));
          if (acc_out != nullptr && qi < C)
            *reinterpret_cast<float2*>(arow + 8 * j) = make_float2(a0, a1);
        }
        if (m_out != nullptr && tig == 0 && qi < C) {
          const size_t ml = ((size_t)x.row * H + h) * C + qi;
          m_out[ml] = st.m[r];
          l_out[ml] = st.l[r];
        }
      }
      fence_async_smem();
      wg_sync(wg);
      if (wtid == 0) {
#pragma unroll
        for (int c = 0; c < NBOX<D>; ++c) tma_store_4d(&omap, qt + c * BOX, 64 * c, h, q0, x.row);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // the previous unit's stores have read their Q tile: it may be reloaded
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        if (n > 0) mbar_arrive(&qempty[(n - 1) % QBUFS]);
      }
    } else {
      if (wtid == 0) mbar_arrive(&qempty[qb]);   // the Q tile may be reloaded
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = q0 + row[r];
        if (qi >= C) continue;
        float* arow = acc_out + (((size_t)x.row * C + qi) * H + h) * D + 2 * tig;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(arow + 8 * j) =
              make_float2(st.o[4 * j + 2 * r], st.o[4 * j + 2 * r + 1]);
        if (tig == 0) {
          const size_t ml = ((size_t)x.row * H + h) * C + qi;
          m_out[ml] = st.m[r];
          l_out[ml] = st.l[r];
        }
      }
    }
  }
  if constexpr (Walk::OUT) {
    if (wtid == 0) tma_store_wait();
  }
}

// ------------------------------------------------------------- host side

// A contiguous [B, rows, heads, D] tensor as a 4-d map {D, heads, rows, B}
// with boxes of {cols, 1, 64, 1}; out-of-bounds elements load as zeros and
// are not stored.
inline bool rows_map(CUtensorMap* map, CUtensorMapDataType dt, int esize, const void* base,
                     int B, int rows, int heads, int D, int cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t e = static_cast<cuuint64_t>(esize);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {D * e, (cuuint64_t)heads * D * e,
                                 (cuuint64_t)rows * heads * D * e};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)BK, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return fn(map, dt, 4, const_cast<void*>(base), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TKV>
constexpr CUtensorMapDataType kv_map_type() {
  return sizeof(TKV) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

// The SM count, read once.
inline cudaError_t sm_count(int& sms) {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  sms = n;
  return cudaSuccess;
}

// Launches the tensor-core body over `walk` (units units): the kernel's
// shared-memory opt-in once, then a persistent grid of one block an SM, at
// most one block per two units. k/v maps km / vm; om: K1's out.
template <typename TKV, int D, class Walk>
int launch_tc(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
              const CUtensorMap& om, const float* ks, const float* vs, float* m, float* l,
              float* acc, const Walk& walk, int units, float scale, cudaStream_t stream) {
  using L = TcSmem<TKV, D, Walk::QBUFS, Walk::TABLE>;
  auto kern = attn_tc_kernel<TKV, D, Walk>;
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L::DYNAMIC);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  int sms = 0;
  cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return (int)err;
  const int grid = min(sms, (units + 1) / 2);
  kern<<<grid, NTHREADS, L::DYNAMIC, stream>>>(qm, km, vm, om, ks, vs, m, l, acc, walk, scale);
  return (int)cudaGetLastError();
}

// K1: q [B,C,H,D] bf16, k/v [B,T,KVH,D], out [B,C,H,D] bf16.
template <typename TKV, int D>
int launch_chunk_tc(const void* q, const void* k, const void* v, const float* ks,
                    const float* vs, void* out, float* m, float* l, float* acc, int B, int C,
                    int H, int T, int KVH, int causal_offset, int kv_len, float scale,
                    cudaStream_t stream) {
  using KB = KVBox<TKV, D>;
  if (B == 0 || C == 0 || H == 0) return (int)cudaSuccess;
  CUtensorMap qm, km, vm, om;
  const CUtensorMapSwizzle kv_sw = KB::WIDE ? CU_TENSOR_MAP_SWIZZLE_128B
                                            : CU_TENSOR_MAP_SWIZZLE_NONE;
  bool ok = rows_map(&qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, B, C, H, D, 64,
                     CU_TENSOR_MAP_SWIZZLE_128B) &&
            rows_map(&om, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, B, C, H, D, 64,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  km = vm = om;                          // never read when there are no keys
  if (T == 0)
    kv_len = 0;                          // no tile is loaded
  else
    ok = ok &&
         rows_map(&km, kv_map_type<TKV>(), sizeof(TKV), k, B, T, KVH, D, KB::COLS, kv_sw) &&
         rows_map(&vm, kv_map_type<TKV>(), sizeof(TKV), v, B, T, KVH, D, KB::COLS, kv_sw);
  if (!ok) return (int)cudaErrorInvalidValue;
  const int nqb = (C + BQ - 1) / BQ;
  const ChunkWalk walk{B, C, H, KVH, T, nqb, causal_offset, kv_len};
  return launch_tc<TKV, D>(qm, km, vm, om, ks, vs, m, l, acc, walk, B * H * nqb, scale, stream);
}

// K2: q [G*B,C,H,D] bf16, k/v [S,G*B,T,KVH,D] (the 4-D [S*G*B,T,KVH,D]),
// valid [G,S] bool; fp32 m, l [G*B,H,C] and acc [G*B,C,H,D].
template <typename TKV, int D>
int launch_pool_tc(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const uint8_t* valid, float* m, float* l, float* acc, int G,
                   int B, int C, int H, int S, int T, int KVH, int kv_len, float scale,
                   cudaStream_t stream) {
  using KB = KVBox<TKV, D>;
  const int words = (S + 31) / 32;
  if (G > MAX_GROUPS || G * words > MAX_WORDS) return (int)cudaErrorInvalidValue;
  if (G * B == 0 || C == 0 || H == 0) return (int)cudaSuccess;
  CUtensorMap qm, km, vm;
  const CUtensorMapSwizzle kv_sw = KB::WIDE ? CU_TENSOR_MAP_SWIZZLE_128B
                                            : CU_TENSOR_MAP_SWIZZLE_NONE;
  bool ok = rows_map(&qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, G * B, C, H, D, 64,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  km = vm = qm;                          // never read when there are no keys
  if (S == 0 || T == 0)
    kv_len = 0;                          // no tile is loaded
  else
    ok = ok &&
         rows_map(&km, kv_map_type<TKV>(), sizeof(TKV), k, S * G * B, T, KVH, D, KB::COLS,
                  kv_sw) &&
         rows_map(&vm, kv_map_type<TKV>(), sizeof(TKV), v, S * G * B, T, KVH, D, KB::COLS,
                  kv_sw);
  if (!ok) return (int)cudaErrorInvalidValue;
  const int nqb = (C + BQ - 1) / BQ;
  const StackWalk walk{G, B, C, H, KVH, S, T, nqb, kv_len, kv_len, (kv_len + BK - 1) / BK,
                       words, valid, nullptr, nullptr, nullptr};
  return launch_tc<TKV, D>(qm, km, vm, qm, ks, vs, m, l, acc, walk, G * B * H * nqb, scale,
                           stream);
}

// K3's tensor-core route takes pages that fill whole 64-key tiles (pt a
// multiple of 64, or a multiple of 8 dividing 64) of a store whose group
// stride is P page strides or B batch strides (one 5-D tensor map).
inline bool paged_tc_fits(int G, int P, int B, int pt, const long long* st) {
  const bool tiles = pt > 0 && pt % 8 == 0 && (pt % BK == 0 || BK % pt == 0);
  return tiles && (G == 1 || st[0] == (long long)P * st[1] || st[0] == (long long)B * st[2]);
}

// K3: q [G*B,C,H,D] bf16; the page store k/v [G,P,B,pt,KVH,D] by element
// strides st = (group, page, batch, token, head), the head dim contiguous;
// handles [S*ppc] int32, valid [G,S] bool; per-page scales [G,P,B,KVH] by
// strides sst. The caller has checked paged_tc_fits.
template <typename TKV, int D>
int launch_paged_tc(const void* q, const void* k, const void* v, const float* ks,
                    const float* vs, const int* handles, const uint8_t* valid, float* m,
                    float* l, float* acc, int G, int B, int C, int H, int S, int P, int ppc,
                    int pt, int KVH, int kv_len, const long long* st, const long long* sst,
                    float scale, cudaStream_t stream) {
  using KB = KVBox<TKV, D>;
  const int words = (S + 31) / 32;
  if (G > MAX_GROUPS || G * words > MAX_WORDS) return (int)cudaErrorInvalidValue;
  if (G * B == 0 || C == 0 || H == 0) return (int)cudaSuccess;
  CUtensorMap qm, km, vm;
  bool ok = rows_map(&qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, G * B, C, H, D, 64,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  km = vm = qm;                          // never read when there are no keys
  const bool gp = G == 1 || st[0] == (long long)P * st[1];
  if (S == 0 || P == 0 || kv_len == 0) {
    kv_len = 0;                          // no tile is loaded
  } else {
    EncodeTiled fn = encode_tiled();
    const cuuint64_t e = sizeof(TKV);
    // {D, KVH, pt, n3, n4} with strides (head, token, batch, page):
    // (n3, n4) = (B, G*P) or (G*B, P)
    const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)KVH, (cuuint64_t)pt,
                                (cuuint64_t)(gp ? B : G * B), (cuuint64_t)(gp ? G * P : P)};
    const cuuint64_t strides[4] = {st[4] * e, st[3] * e, st[2] * e, st[1] * e};
    const cuuint32_t box[5] = {(cuuint32_t)KB::COLS, 1, (cuuint32_t)min(pt, BK), 1, 1};
    const cuuint32_t one[5] = {1, 1, 1, 1, 1};
    const CUtensorMapSwizzle sw = KB::WIDE ? CU_TENSOR_MAP_SWIZZLE_128B
                                           : CU_TENSOR_MAP_SWIZZLE_NONE;
    for (int i = 0; i < 2 && ok; ++i)
      ok = fn != nullptr &&
           fn(i == 0 ? &km : &vm, kv_map_type<TKV>(), 5, const_cast<void*>(i == 0 ? k : v),
              dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const int nqb = (C + BQ - 1) / BQ;
  const PagedWalk walk{{G, B, C, H, KVH, S, ppc * pt, nqb, kv_len, kv_len, (kv_len + BK - 1) / BK,
                        words, valid, nullptr, nullptr, nullptr},
                       handles, ppc, pt, P, gp, sst[0], sst[1], sst[2], sst[3]};
  return launch_tc<TKV, D>(qm, km, vm, qm, ks, vs, m, l, acc, walk, G * B * H * nqb, scale,
                           stream);
}

}  // namespace tc
}  // namespace
