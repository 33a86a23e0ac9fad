// Flash-decode attention for Hopper (sm_90a): kernel K5 of the port.
//
// Replaces (TPU kernel): decode_attention_pallas / _decode_kernel in
// src/repro/kernels/decode_attn.py.
//
// What it computes: one query token per batch row against a KV cache, with
// GQA (G = H / KVH query heads share a kv head):
//   out[b, h] = softmax(q[b, h] . k[b, :len_b, h / G] * scale) . v[b, :len_b, h / G]
// q [B,H,D]; k, v [B,S,KVH,D] in q's dtype (fp32 or bf16); kv_len [B] int32
// read on the device, len_b = kv_len[b] clamped to [0, S]; out [B,H,D] in
// q's dtype. The softmax weights p stay in fp32 before the PV product and
// the sum is normalised once at the end by max(l, 1e-30), so a row with
// kv_len = 0 gives zeros.
//
// What bounds it on an H100: decode reads every K/V byte once and does
// ~4 G D flops per key, so the bytes bound it (qwen3-8b, B 8, S 32768,
// bf16: 1.07 GB, 0.32 ms at 3.35 TB/s). At G >= 8 the CUDA cores' issue
// rate does instead: every (query head, key) costs a row group 2 D FMAs and
// a shuffle reduction, ~8 SM clocks measured (G 16 over 4 kv heads: 0.61 ms
// against 0.16 ms of bytes; PERF.md); tensor cores are the way past it. The
// design keeps HBM busy and every SM equally loaded:
//
//  - Work: the keys of every (batch row, kv head) pair, laid end to end
//    (row-major, then kv head, then position), are one sequence of
//    total = KVH x sum(len_b) keys, counted on the device from kv_len (no
//    host sync). A grid sized to the card (as many blocks as fit at once)
//    cuts it into equal ranges of L keys, L = ceil(total / grid) rounded up
//    to a whole tile, so no block takes more than one tile above the mean,
//    whatever the lengths are; positions at or past len_b are in no range.
//    A range is cut at pair boundaries into segments (ops.decode_ranges
//    states the same rule in Python, and the tests hold it).
//  - Loads: a ring of STAGES tiles (K and V of KEYS keys, ~16 KB) in
//    shared memory, filled by 16-byte cp.async copies that every thread
//    issues STAGES - 1 tiles ahead, across segments; a key past the
//    segment's end is zero-filled without a read. So four tiles are in
//    flight while one is computed. (PERF.md has the ring depths, block
//    sizes and keys a row group a tile timed against this choice.)
//  - Compute: a "row group" of threads holds one key row, each thread 16
//    bytes of it (8 bf16 or 4 fp32 values), and keeps its slice of its
//    query heads, pre-scaled by scale * log2(e), in registers. It takes U
//    keys at a time, reduces the heads x U dot products with xor shuffles
//    inside the row group and folds them into its own fp32 (m, l, acc) in
//    base 2; keys past the segment's end enter as -inf before the
//    exponent, with zero values, so no 0 * inf is formed.
//  - Head slices: a thread keeps qf / acc (VEC values each), m, l and U
//    scores for every query head it serves, ~26 registers a head in bf16
//    at D 128, so 12 or 16 heads do not fit in 255 registers. A unit's G
//    query heads are therefore split into HS slices (head_slices: the
//    fewest of 1, 2 or 4 that leave at most MAX_HEADS = 4 heads a
//    thread; G 8 -> 2 slices of 4, G 12 -> 4 of 3, G 16 -> 4 of 4; G 5 and
//    7 keep one). HS adjacent row groups hold the same key row, one slice
//    each, reading the same shared-memory tile, so the K/V of a unit still
//    leave HBM once; each row group then takes HS x U keys of a tile, U at
//    a time, and a tile keeps its KEYS keys. The online-softmax state
//    stays per head and the merge is the same, over the row groups that
//    hold the same slice.
//  - End of a segment: the row groups' states merge (shuffles inside a
//    warp, shared memory across warps). A segment that is a whole pair
//    writes out = acc / max(l, 1e-30) at once; otherwise it writes a
//    partial state to fp32 scratch at slot (block + pair) (distinct for
//    distinct segments), and the last block to finish a pair (a counter
//    per pair, reset by that block) merges the pair's partials and writes
//    out. One launch, no combine kernel.
//  - Rows with kv_len = 0 are written as zeros by block pair % grid.
//  - Under MHA (G = 1) with rows of no whole number of 64-byte DRAM bursts
//    (bf16 at D = 112: 224 bytes, read as 256; at D = 80: 160 bytes), a
//    "pair" is two adjacent kv heads of a row (PAIR_HEADS): a key is their
//    two rows, 448 (320) contiguous bytes, and the two row groups of a warp
//    take one head each.
//  - A head row of no power-of-two number of 16-byte pieces (bf16 at
//    D = 80 or 112: 10 or 14) takes a row group padded to 16 threads; the
//    padding threads load nothing and hold zeros (`active`).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int U = 4;                      // keys a row group takes at a time (HS x U a tile)
constexpr int STAGES = 5;                 // tiles in the ring
constexpr float LOG2E = 1.4426950408889634f;

enum DType { F32 = 0, BF16 = 1 };

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32;
}

// Kv heads a unit takes at once: 2 when G = 1 and a head's row is no whole
// number of 64-byte DRAM bursts (bf16 at D = 16, 80 or 112: 224-byte rows
// cost 256 bytes each), so that a key's rows of two adjacent heads are one
// contiguous 64-byte-aligned span; else 1.
template <typename T, int D>
constexpr bool PAIR_HEADS = (D * (int)sizeof(T)) % 64 != 0;

// The most query heads one thread serves where the group allows it
// (head_slices). At 8 (G 8 unsplit, G 12 and 16 in 2 slices) the wide
// instances run at 246-254 registers and time ~5 % faster on an H100
// (PERF.md); at 4 they stay at <= 168, with room left under 255.
constexpr int MAX_HEADS = 4;

// Slices a unit's G query heads are split into: the fewest of 1, 2 and 4
// that divide G and leave at most MAX_HEADS heads a slice; 1 where none
// does (G 5, 7), as ops.decode_head_slices states.
__host__ __device__ constexpr int head_slices(int g) {
  return g <= MAX_HEADS                        ? 1
         : g % 2 == 0 && g / 2 <= MAX_HEADS ? 2
         : g % 4 == 0 && g / 4 <= MAX_HEADS ? 4
                                               : 1;
}

// Shapes of one instantiation: a thread holds VEC values of a head's key
// row, TPR threads a row (a row group of TPR_P, padded to a power of two),
// RG row groups a block; HP kv heads a unit and HS head slices, so RPK =
// HP x HS row groups (adjacent in a warp, or a whole REPW-thread span)
// hold one key: its HP rows, each once per slice. KR = RG / RPK keys are
// held at once, each row group takes UK = HS x U keys of a tile, and a
// tile has KEYS = KR x UK = RG / HP x U keys whatever HS is.
template <typename T, int D, int HP, int HS>
struct Geo {
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int TPR = D / VEC;
  static constexpr int TPR_P = pow2_at_least(TPR);
  static constexpr int RG = NTHREADS / TPR_P;
  static constexpr int RPK = HP * HS;
  static constexpr int KR = RG / RPK;
  static constexpr int UK = HS * U;
  static constexpr int KEYS = KR * UK;
  static constexpr int REPW = TPR_P * RPK;                  // threads holding one key
  static constexpr int REPS = REPW > 32 ? REPW : 32;        // threads a merged state spans
  static constexpr int NREP = NTHREADS / REPS;              // states left after the warp merge
  static constexpr int ROW = HP * D * (int)sizeof(T);  // bytes of a key (HP heads' rows)
  static constexpr int TILE = KEYS * ROW;              // bytes of a K (or V) tile
  static_assert(D % VEC == 0 && TPR <= 32 && TPR_P * HP <= 32, "head dim");
  static_assert(KR >= 1 && RG % RPK == 0 && KEYS == RG / HP * U, "head slices");
};

template <typename T, int D, int GG, int HP, int HS>
struct Smem {   // byte offsets into the dynamic shared memory; GG = HP x G
  static constexpr int NREP = Geo<T, D, HP, HS>::NREP;
  static constexpr int RING = 0;                                   // [STAGES][K | V][TILE]
  static constexpr int ACC = STAGES * 2 * Geo<T, D, HP, HS>::TILE; // [NREP][GG][D] fp32
  static constexpr int ML = ACC + NREP * GG * D * 4;               // m, l: [NREP][GG] each
  static constexpr int BYTES = ML + 2 * NREP * GG * 4;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 raw bytes -> 16 / sizeof(T) floats
template <typename T> __device__ __forceinline__ void unpack(const uint4& r, float* f);
template <> __device__ __forceinline__ void unpack<float>(const uint4& r, float* f) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& r, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ int clamp_len(const int* kv_len, int b, int S) {
  return min(max(kv_len[b], 0), S);
}

// A walk over this block's range of the key sequence, one segment (the
// keys [pos, end) of pair (b, hk), whose keys start at gstart in the
// sequence) and one tile (keys [key0, key0 + KEYS) of it) at a time.
struct Cursor {
  const int* kv_len;
  int B, KVH, S, keys;
  int b, hk, len, pos, end, key0;
  long long rowstart, left;      // sequence index of row b's first key; keys left after `end`
  bool done;

  __device__ long long gstart() const { return rowstart + (long long)hk * len; }
  __device__ int pair() const { return b * KVH + hk; }
  __device__ void open(int p, long long budget) {   // a segment from position p of (b, hk)
    pos = key0 = p;
    const long long n = min((long long)(len - p), budget);
    end = p + (int)n;
    left = budget - n;
  }
  __device__ void first(int row, long long row0, long long offset, long long budget) {
    b = row;
    rowstart = row0;
    len = clamp_len(kv_len, b, S);
    done = budget <= 0;
    if (done) return;
    hk = (int)(offset / len);
    open((int)(offset % len), budget);
  }
  // the next tile; past the segment's end, the next segment's first
  __device__ void next() {
    key0 += keys;
    if (key0 < end) return;
    if (left <= 0) {
      done = true;
      return;
    }
    if (++hk == KVH) {
      hk = 0;
      do {
        rowstart += (long long)KVH * len;
        len = clamp_len(kv_len, ++b, S);
      } while (len == 0);
    }
    open(0, left);
  }
};

// Blocks an SM the register budget must allow (0: ptxas's own choice). At
// fp32 D 64 G 3 ptxas's own budget (80 registers) spills 4 bytes; asking
// for one block an SM lets it keep them in registers (105), and no other
// instance changes.
template <typename T, int D, int G>
constexpr int MIN_BLOCKS = sizeof(T) == 4 && D == 64 && G == 3 ? 1 : 0;

// One unit = HP adjacent kv heads (hk0 = hk * HP, ...) of one row, GG = HP x G
// query heads, HS head slices of G / HS heads; the Cursor walks units (its
// KVH is KVH / HP).
template <typename T, int D, int G, int HP, int HS>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS<T, D, G>)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ kv_len, float* __restrict__ part,
                   int* __restrict__ counters, T* __restrict__ out, int B, int H, int KVH,
                   int S, float qscale) {
  using Gm = Geo<T, D, HP, HS>;
  constexpr int GG = HP * G, GT = G / HS;        // query heads a unit, a thread
  using L = Smem<T, D, GG, HP, HS>;
  constexpr int VEC = Gm::VEC, TPR = Gm::TPR, TPR_P = Gm::TPR_P, RPK = Gm::RPK;
  constexpr int KEYS = Gm::KEYS, ROW = Gm::ROW, TILE = Gm::TILE, KR = Gm::KR;
  constexpr int REPW = Gm::REPW, REPS = Gm::REPS, NREP = Gm::NREP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm_acc = reinterpret_cast<float*>(smem + L::ACC);
  float* sm_m = reinterpret_cast<float*>(smem + L::ML);
  float* sm_l = sm_m + NREP * GG;
  __shared__ long long s_range[3];       // L, the first key of the range's first row, keys
  __shared__ int s_row, s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rl = tid % TPR_P, rg = tid / TPR_P;  // lane in the row group, row group
  const int wi = rg % RPK, kr = rg / RPK;        // its place in the key's row groups, key row
  const int hs = wi % HP, sl = wi / HP;          // its kv head in the unit, its head slice
  const int h0 = hs * G + sl * GT;               // its first query head of the unit's GG
  const bool active = rl < TPR;
  const int nblk = gridDim.x, blk = blockIdx.x;
  const int KU = KVH / HP;                       // units a row

  // ---- the range: warp 0 counts the keys and finds the range's first row
  if (warp == 0) {
    long long total = 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
      long long x = b0 + lane < B ? (long long)KU * clamp_len(kv_len, b0 + lane, S) : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      total += x;
    }
    const long long per = (total + nblk - 1) / nblk;
    const long long len_r = max((long long)KEYS, (per + KEYS - 1) / KEYS * KEYS);
    const long long start = (long long)blk * len_r;
    int row = -1;
    long long row0 = 0, acc = 0;
    for (int b0 = 0; b0 < B && start < total; b0 += 32) {
      const long long x = b0 + lane < B ? (long long)KU * clamp_len(kv_len, b0 + lane, S) : 0;
      long long incl = x;                       // inclusive scan over the lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      const unsigned hit = __ballot_sync(0xffffffffu, acc + incl > start);
      if (hit) {
        const int first = __ffs(hit) - 1;
        row = b0 + first;
        row0 = acc + __shfl_sync(0xffffffffu, incl - x, first);
        break;
      }
      acc += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) {
      s_row = row;
      s_range[0] = len_r;
      s_range[1] = row0;
      s_range[2] = row < 0 ? 0 : min(len_r, total - start);   // keys in this range
    }
  }
  // ---- rows with kv_len = 0: zeros, from block unit % grid
  for (int b = 0; b < B; ++b) {
    if (clamp_len(kv_len, b, S) != 0) continue;
    for (int hk = 0; hk < KU; ++hk) {
      if ((long long)(b * KU + hk) % nblk != blk) continue;
      for (int e = tid; e < GG * D; e += NTHREADS)
        out[((size_t)b * H + (size_t)hk * GG) * D + e] = from_f32<T>(0.f);
    }
  }
  __syncthreads();
  const long long len_r = s_range[0];
  if (s_row < 0) return;                       // no key in this block's range

  Cursor prod{kv_len, B, KU, S, KEYS};
  prod.first(s_row, s_range[1], (long long)blk * len_r - s_range[1], s_range[2]);
  Cursor cons = prod;

  // issue the copies of the producer's tile into stage st, then move on
  auto issue = [&](int st) {
    if (prod.done) return;
    unsigned char* kd = smem + L::RING + st * 2 * TILE;
    const size_t base = (((size_t)prod.b * S) * KVH + (size_t)prod.hk * HP) * D;
    const size_t pstride = (size_t)KVH * D;
    for (int c = tid; c < TILE / 16; c += NTHREADS) {
      const int r = c / (ROW / 16), piece = c % (ROW / 16);
      const int key = prod.key0 + r;
      const bool ok = key < prod.end;
      const size_t off = ok ? base + (size_t)key * pstride : 0;
      cp_async16(kd + r * ROW + piece * 16, reinterpret_cast<const char*>(k + off) + piece * 16,
                 ok ? 16 : 0);
      cp_async16(kd + TILE + r * ROW + piece * 16,
                 reinterpret_cast<const char*>(v + off) + piece * 16, ok ? 16 : 0);
    }
    prod.next();
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    issue(st);
    cp_async_commit();
  }

  // this row group's heads: kv head cons.hk * HP + hs, query heads h0 ..
  // h0 + GT - 1 of the unit
  float qf[GT][VEC], acc[GT][VEC], m[GT], l[GT];
  auto load_q = [&]() {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (active) {
        const uint4 r = __ldg(reinterpret_cast<const uint4*>(
            q + ((size_t)cons.b * H + (size_t)cons.hk * GG + h0 + g) * D + rl * VEC));
        unpack<T>(r, qf[g]);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        qf[g][i] = active ? qf[g][i] * qscale : 0.f;
        acc[g][i] = 0.f;
      }
      m[g] = -INFINITY;
      l[g] = 0.f;
    }
  };
  load_q();

  const int col = hs * (ROW / HP) + rl * 16;     // this thread's bytes in a key
  for (int w = 0; !cons.done; ++w) {
    issue((w + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();               // this thread's copies of tile w
    __syncthreads();                           // everyone's
    const unsigned char* kt = smem + L::RING + (w % STAGES) * 2 * TILE;
    const unsigned char* vt = kt + TILE;
    const int nkeys = min(KEYS, cons.end - cons.key0);

    // HS sub-steps of U keys each: keys k0 + u * KR of the tile
#pragma unroll 1
    for (int sub = 0; sub < HS; ++sub) {
      const int k0 = kr + sub * U * KR;
      float s[GT][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[VEC];
        if (active) {
          unpack<T>(*reinterpret_cast<const uint4*>(kt + (k0 + u * KR) * ROW + col), kf);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) kf[i] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < VEC; ++i) d = fmaf(qf[g][i], kf[i], d);
          s[g][u] = d;
        }
      }
#pragma unroll
      for (int o = TPR_P / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < GT; ++g) {
#pragma unroll
          for (int u = 0; u < U; ++u) s[g][u] += __shfl_xor_sync(0xffffffffu, s[g][u], o);
        }
      }
      if (k0 < nkeys) {                        // key k0 is valid (uniform in the row group)
        float p[GT][U];
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float mx = m[g];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (k0 + u * KR >= nkeys) s[g][u] = -INFINITY;   // masked before the exponent
            mx = fmaxf(mx, s[g][u]);
          }
          const float corr = exp2f(m[g] - mx);   // mx is finite
          float sum = 0.f;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            p[g][u] = exp2f(s[g][u] - mx);
            sum += p[g][u];
          }
          l[g] = l[g] * corr + sum;
          m[g] = mx;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] *= corr;
        }
        if (active) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float vf[VEC];
            unpack<T>(*reinterpret_cast<const uint4*>(vt + (k0 + u * KR) * ROW + col), vf);
#pragma unroll
            for (int g = 0; g < GT; ++g) {
#pragma unroll
              for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(p[g][u], vf[i], acc[g][i]);
            }
          }
        }
      }
    }
    const bool seg_end = cons.key0 + KEYS >= cons.end;
    if (seg_end) {
      // ---- merge the row groups of each head: inside the warp by shuffles
      // (lanes REPW apart hold the same heads) ...
#pragma unroll
      for (int o = REPW; o < 32; o <<= 1) {
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
          const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
          const float mn = fmaxf(m[g], mo);
          const float wa = m[g] == -INFINITY ? 0.f : exp2f(m[g] - mn);
          const float wb = mo == -INFINITY ? 0.f : exp2f(mo - mn);
          l[g] = l[g] * wa + lo * wb;
          m[g] = mn;
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], o);
            acc[g][i] = acc[g][i] * wa + ao * wb;
          }
        }
      }
      // ... and across the NREP spans of REPS threads through shared
      // memory (each span's first REPW threads write: one row group for
      // each of the unit's (kv head, slice))
      const int rep = tid / REPS;
      const bool writer = tid % REPS < REPW;
      if (writer && active) {
#pragma unroll
        for (int g = 0; g < GT; ++g) {
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            sm_acc[(rep * GG + h0 + g) * D + rl * VEC + i] = acc[g][i];
        }
      }
      if (writer && rl == 0) {
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          sm_m[rep * GG + h0 + g] = m[g];
          sm_l[rep * GG + h0 + g] = l[g];
        }
      }
      __syncthreads();
      const int unit = cons.pair();
      const long long gs = cons.gstart();
      const int jf = (int)(gs / len_r), jl = (int)((gs + cons.len - 1) / len_r);
      T* orow = out + ((size_t)cons.b * H + (size_t)cons.hk * GG) * D;
      float* slot = part + (size_t)(blk + unit) * GG * (D + 2);   // acc [GG][D], m, l [GG]
      for (int e = tid; e < GG * D; e += NTHREADS) {
        const int gq = e / D, d = e % D;
        float mx = -INFINITY;
#pragma unroll
        for (int r = 0; r < NREP; ++r) mx = fmaxf(mx, sm_m[r * GG + gq]);
        float ls = 0.f, as = 0.f;
#pragma unroll
        for (int r = 0; r < NREP; ++r) {
          const float mr = sm_m[r * GG + gq];
          if (mr == -INFINITY) continue;       // a span that saw no key
          const float wt = exp2f(mr - mx);
          ls = fmaf(sm_l[r * GG + gq], wt, ls);
          as = fmaf(sm_acc[(r * GG + gq) * D + d], wt, as);
        }
        if (jf == jl) {
          orow[e] = from_f32<T>(as / fmaxf(ls, 1e-30f));
        } else {
          slot[e] = as;
          if (d == 0) {
            slot[GG * D + gq] = mx;
            slot[GG * D + GG + gq] = ls;
          }
        }
      }
      if (jf != jl) {
        __threadfence();                       // the partial is visible before the count
        __syncthreads();
        if (tid == 0) s_last = atomicAdd(&counters[unit], 1) == jl - jf;
        __syncthreads();
        if (s_last) {                          // every other block of the unit is done
          __threadfence();
          for (int e = tid; e < GG * D; e += NTHREADS) {
            const int gq = e / D;
            float mx = -INFINITY;
            for (int j = jf; j <= jl; ++j)
              mx = fmaxf(mx, __ldcg(part + (size_t)(j + unit) * GG * (D + 2) + GG * D + gq));
            float ls = 0.f, as = 0.f;
            for (int j = jf; j <= jl; ++j) {
              const float* sj = part + (size_t)(j + unit) * GG * (D + 2);
              const float wt = exp2f(__ldcg(sj + GG * D + gq) - mx);
              ls = fmaf(__ldcg(sj + GG * D + GG + gq), wt, ls);
              as = fmaf(__ldcg(sj + e), wt, as);
            }
            orow[e] = from_f32<T>(as / fmaxf(ls, 1e-30f));
          }
          if (tid == 0) counters[unit] = 0;    // ready for the next launch
        }
      }
      __syncthreads();                         // sm_acc is free again
    }
    __syncthreads();                           // stage w % STAGES may be refilled
    const bool was_end = seg_end;
    cons.next();
    if (was_end && !cons.done) load_q();
  }
  cp_async_wait<0>();
}

// The grid: as many blocks as fit on the card at once, at most `cap` (the
// scratch holds cap + B x KVH / HP partial slots).
template <typename T, int D, int G, int HP>
int launch(const void* q, const void* k, const void* v, const int* kv_len, float* part,
           int* counters, void* out, int B, int H, int KVH, int S, int cap, float scale,
           cudaStream_t stream) {
  constexpr int HS = head_slices(G);
  auto kern = decode_attn_kernel<T, D, G, HP, HS>;
  constexpr int smem = Smem<T, D, HP * G, HP, HS>::BYTES;
  static int grid = 0;
  if (grid == 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NTHREADS, smem);
    if (err != cudaSuccess) return (int)err;
    grid = max(1, per_sm * sms);
  }
  kern<<<min(grid, cap), NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_len, part,
      counters, static_cast<T*>(out), B, H, KVH, S, scale * LOG2E);
  return (int)cudaGetLastError();
}

// G = 1 with rows of no whole number of 64-byte bursts and an even KVH: two
// kv heads a unit (PAIR_HEADS); otherwise one.
template <typename T, int D, int G>
int launch_g(const void* q, const void* k, const void* v, const int* kv_len, float* part,
             int* counters, void* out, int B, int H, int KVH, int S, int cap, float scale,
             cudaStream_t stream) {
  if constexpr (G == 1 && PAIR_HEADS<T, D>) {
    if (KVH % 2 == 0)
      return launch<T, D, G, 2>(q, k, v, kv_len, part, counters, out, B, H, KVH, S, cap, scale,
                                stream);
  }
  return launch<T, D, G, 1>(q, k, v, kv_len, part, counters, out, B, H, KVH, S, cap, scale,
                            stream);
}

// The (D, G) instances, each a model's decode shape (ops._DECODE_GROUPS
// lists the same pairs): G 1, 2, 4 and 8 at D 16 (the smoke configs), 112
// (zamba2-7b's shared block) and 128; at D 16 and 128 also G 5, 12 and 16
// (qwen3-14b; mistral-123b; qwen3-235b, llama3-405b) and at D 128 G 7
// (llava-next-34b); at D 64 G 1, 3 and 4 (whisper-small,
// granite-moe-3b-a800m, granite-3-2b) and at D 80 G 1 (stablelm-3b). A
// thread keeps (VEC queries + VEC accumulators + m, l + U scores) for each
// of its G / HS query heads (head_slices): at most 4 at G 8, 12 and 16, 5
// and 7 at G 5 and 7, so no instance needs more than G 7's registers (the
// build phase of chip_smoke.py prints each instance's registers and
// spills).
#define DISPATCH_G(T, D, ...)                                                  \
  if (G == 1) return launch_g<T, D, 1>(__VA_ARGS__);                           \
  if (G == 2) return launch_g<T, D, 2>(__VA_ARGS__);                           \
  if (G == 4) return launch_g<T, D, 4>(__VA_ARGS__);                           \
  if (G == 8) return launch_g<T, D, 8>(__VA_ARGS__);                           \
  return (int)cudaErrorInvalidValue;

#define DISPATCH_G_WIDE(T, D, ...)                                             \
  if (G == 5) return launch_g<T, D, 5>(__VA_ARGS__);                           \
  if (G == 12) return launch_g<T, D, 12>(__VA_ARGS__);                         \
  if (G == 16) return launch_g<T, D, 16>(__VA_ARGS__);                         \
  DISPATCH_G(T, D, __VA_ARGS__)

#define DISPATCH_DG(T, ...)                                                    \
  if (D == 16) { DISPATCH_G_WIDE(T, 16, __VA_ARGS__) }                         \
  if (D == 64) {                                                               \
    if (G == 1) return launch_g<T, 64, 1>(__VA_ARGS__);                        \
    if (G == 3) return launch_g<T, 64, 3>(__VA_ARGS__);                        \
    if (G == 4) return launch_g<T, 64, 4>(__VA_ARGS__);                        \
    return (int)cudaErrorInvalidValue;                                         \
  }                                                                            \
  if (D == 80) {                                                               \
    if (G == 1) return launch_g<T, 80, 1>(__VA_ARGS__);                        \
    return (int)cudaErrorInvalidValue;                                         \
  }                                                                            \
  if (D == 112) { DISPATCH_G(T, 112, __VA_ARGS__) }                            \
  if (D == 128) {                                                              \
    if (G == 7) return launch_g<T, 128, 7>(__VA_ARGS__);                       \
    DISPATCH_G_WIDE(T, 128, __VA_ARGS__)                                       \
  }                                                                            \
  return (int)cudaErrorInvalidValue;

}  // namespace

extern "C" {

// K5. q [B,H,D], k/v [B,S,KVH,D] and out [B,H,D] contiguous, in one dtype
// (0 = fp32, 1 = bf16); kv_len [B] int32 on the device. part: fp32 scratch
// of (2 cap + B x KVH) x G x (D + 2) floats; counters: B x KVH int32, zero
// before the first launch and left zero by every launch. cap: the most
// blocks the grid may have. (D, G = H / KVH) is one of DISPATCH_DG's
// pairs. Returns cudaGetLastError() after the launch.
int decode_attention_launch(const void* q, const void* k, const void* v, const void* kv_len,
                            void* part, void* counters, void* out, int dtype, int B, int H,
                            int KVH, int D, int S, int cap, float scale, void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || S <= 0 || cap <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / KVH;
  const int* len = static_cast<const int*>(kv_len);
  float* pa = static_cast<float*>(part);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32) {
    DISPATCH_DG(float, q, k, v, len, pa, cnt, out, B, H, KVH, S, cap, scale, st)
  }
  if (dtype == BF16) {
    DISPATCH_DG(__nv_bfloat16, q, k, v, len, pa, cnt, out, B, H, KVH, S, cap, scale, st)
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
