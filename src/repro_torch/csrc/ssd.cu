// Mamba2 chunked SSD (state-space duality) scan for Hopper (sm_90a): kernel
// K4 of the port.
//
// Replaces (TPU kernel): ssd_pallas / _ssd_kernel in src/repro/kernels/ssd.py.
//
// What it computes, for every row r (stage x batch), head h and chunk of Q
// positions, with the state S [P, N] carried across chunks in fp32:
//   cs_i      = sum_{k <= i} dt_k * A,                 A = -exp(a_log)
//   y_i       = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j    (diagonal)
//             + exp(cs_i) C_i . S                                    (off-diagonal)
//             + d_skip * x_i
//   S        <- S exp(cs_last) + sum_q exp(cs_last - cs_q) dt_q x_q (x) B_q
// x [R,T,H,P] and b, c [R,T,G,N] in bf16 or fp32 (head h reads group
// h / (H/G)), each at its own row and position strides with a position's
// heads (groups) and the last dim dense: the Mamba2 block hands over views
// into its conv output [R, T, d_in + 2 G N], read in place. dt [R,T,H] fp32
// (after softplus); a_log, d_skip [Gs,H] fp32, one row per equal stage
// group of R/Gs rows (each pipeline stage has its own layer); init_state
// [R,H,P,N] fp32 or null. Outputs y [R,T,H,P] (dense) in x's dtype and the
// final state [R,H,P,N] fp32.
//
// Two bodies, chosen statically by dtype and shape (ssd_launch):
//
// ssd_tc_kernel<N>: bf16 at (P, N) = (64, 64) or (64, 128) and Q = 256,
// every K4 launch of the bf16 serve paths (zamba2-7b, mamba2-130m). What
// bounds it on an H100: at zamba2-7b's shape (16 rows x 112 heads x 2
// chunks, N = 64) the bytes (x in, y out, the fp32 state in and out: 0.30
// GB) take 0.089 ms at 3.35 TB/s, and the products, with the masked half
// skipped and the state update done twice (hi + lo), ~60 GFLOP, 0.061 ms at
// the bf16 tensor-core rate; so both the memory and the tensor cores must
// be kept busy. The design:
//   - one block of two consumer warpgroups a (row, head) unit; the TPU's
//     sequential chunk axis is a loop inside it. At a chunk's start one
//     thread loads its C, B and x as 64-position tiles by TMA (128-byte
//     swizzle, one mbarrier a tile), each tile read from device memory once
//     a chunk, x, b and c in place through their strides. At N = 64 the
//     tiles take 104 KB and two blocks share an SM, so one block's loads
//     run under the other's products; at N = 128, 176 KB, one block an SM.
//   - warpgroup w takes query tiles 3 - w and w (4 + 1 and 3 + 2 key tiles:
//     the causal work balances). For query tile i: Y = exp(cs_i) C_i.S^T +
//     d x_i; then for each key tile j <= i the scores C_i.B_j^T (wgmma, both
//     operands K-major in shared memory; only the 10 tile pairs with j <= i
//     of the 16), masked (j > i, diagonal tile) BEFORE the exponential, so
//     that no positive exponent, inf or 0*inf is formed, times
//     exp(cs_i - cs_j) dt_j in registers, rounded once to bf16 as a register
//     A operand, and Y += P.x_j (x_j MN-major, the transpose bit). The scores
//     of key tile j + 1 run on the tensor cores with P.x_j. y leaves from
//     the accumulator by 4-byte stores.
//   - the state lives in registers across the chunk loop, its columns split
//     between the two warpgroups (N/2 each), and is stored once, at the
//     end. The chunk's update U = x^T.(w o B), w = exp(cs_last - cs) dt: A is
//     x (MN-major, the transpose bit), B is (w o B)^T, which the warpgroup
//     builds K-major in its own C tiles (free by then; two buffers, so one
//     tile's build runs under the previous tile's wgmmas) as a hi and a lo
//     bf16 tile (hi = bf16(v), lo = bf16(v - hi)): one bf16 rounding of
//     w o B moves the state by ~3e-3 of max|S|, over the 1e-3 check, where
//     hi + lo keeps ~16 bits. S <- S exp(cs_last) + U accumulates in place.
//     A bf16 copy of the state in shared memory feeds the next chunk's
//     C.S^T (one rounding on the y side, as P's: ~2e-3 of max|y|, inside
//     y's 2e-2).
//   - the cumsum is a warp-shuffle scan with one block barrier, in log2
//     units, so that every decay is one ex2.
//
// ssd_kernel<TX, P, N>: fp32 inputs, (P, N) = (16, 16), and chunks other
// than 256. The first version, on the CUDA cores: one block per (row,
// head), the fp32 state in shared memory across the chunk loop, 64-position
// tiles in fp32 shared memory, rows padded by 4 floats so the float4 reads
// along the contracted axis of 8 neighbouring threads hit distinct banks,
// each of the 256 threads owning a 4x4 (strided by 16) register tile of
// every product; bound by the fp32 FMA rate and shared-memory bandwidth.
// PERF.md keeps both bodies' measured distance to the bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_tc.cuh"     // mbarriers, TMA, wgmma, descriptors, encoder

namespace {

enum DType { F32 = 0, BF16 = 1 };

// Element strides of x, b and c: a row (r) and a position (t); a position's
// heads (groups) and the last dim are dense.
struct Strides {
  long long xr, xt, br, bt, cr, ct;
};

// ================================================================ CUDA cores

constexpr int NTHREADS = 256;   // a 16 x 16 grid of threads
constexpr int BT = 64;          // query / key positions per tile
constexpr int MAX_Q = 256;      // chunk length limit (one position per thread)
constexpr int BS = BT + 4;      // padded row stride of the [*, BT] tiles

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int P, int NS>
constexpr size_t smem_floats() {
  return 4 * (size_t)MAX_Q                 // cs, exp(cs), w, dt
         + 2 * (size_t)BT * (NS + 4)       // C tile, B tile [BT][NS]
         + (size_t)NS * BS                 // B^T tile scaled by w [NS][BT]
         + (size_t)P * BS                  // x^T tile [P][BT]
         + (size_t)BT * BS                 // masked, decayed scores [BT][BT]
         + (size_t)P * (NS + 4);           // the carried state [P][NS]
}

template <typename TX, int P, int NS>
__global__ void __launch_bounds__(NTHREADS, 1)
ssd_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const TX* __restrict__ bm,
           const TX* __restrict__ cm, const float* __restrict__ d_skip,
           const float* __restrict__ init_state, TX* __restrict__ y,
           float* __restrict__ final_state, Strides sd, int T, int H, int G, int Q,
           int rows_per_group) {
  constexpr int CN = NS + 4;          // padded row stride of the [*, NS] tiles
  constexpr int PB = P / 16, NB = NS / 16;
  extern __shared__ __align__(16) float sm[];
  float* cs = sm;                     // inclusive cumsum of dt * A over the chunk
  float* ecs = cs + MAX_Q;            // exp(cs)
  float* wq = ecs + MAX_Q;            // exp(cs_last - cs_q) * dt_q
  float* dts = wq + MAX_Q;            // dt
  float* Cn = dts + MAX_Q;            // [BT][CN]
  float* Bn = Cn + BT * CN;           // [BT][CN]
  float* Bt = Bn + BT * CN;           // [NS][BS]
  float* Xt = Bt + NS * BS;           // [P][BS]
  float* Sp = Xt + P * BS;            // [BT][BS]
  float* St = Sp + BT * BS;           // [P][CN]

  const int h = blockIdx.x, r = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int sg = r / rows_per_group;
  const float A = -expf(a_log[sg * H + h]);
  const float dsk = d_skip[sg * H + h];
  const int g = h / (H / G);
  const size_t state_base = ((size_t)r * H + h) * P * NS;
  // the row's x (this head), b and c (this group), position 0
  const TX* xr = x + r * sd.xr + (long long)h * P;
  const TX* br = bm + r * sd.br + (long long)g * NS;
  const TX* cr = cm + r * sd.cr + (long long)g * NS;

  for (int idx = tid; idx < P * NS; idx += NTHREADS)
    St[(idx / NS) * CN + idx % NS] = init_state ? init_state[state_base + idx] : 0.f;

  for (int c0 = 0; c0 < T; c0 += Q) {
    // ---- cumsum of dt * A over the chunk (Hillis-Steele, one position a thread)
    float v = 0.f;
    if (tid < Q) {
      dts[tid] = dt[((size_t)r * T + c0 + tid) * H + h];
      v = dts[tid] * A;
    }
    cs[tid] = v;
    __syncthreads();
    for (int off = 1; off < Q; off <<= 1) {
      const float add = tid >= off ? cs[tid - off] : 0.f;
      __syncthreads();
      cs[tid] += add;
      __syncthreads();
    }
    const float last = cs[Q - 1];
    if (tid < Q) {
      ecs[tid] = expf(cs[tid]);
      wq[tid] = expf(last - cs[tid]) * dts[tid];
    }
    __syncthreads();

    float upd[PB][NB];
#pragma unroll
    for (int a = 0; a < PB; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) upd[a][b] = 0.f;

    for (int i0 = 0; i0 < Q; i0 += BT) {
      const int ni = min(BT, Q - i0);
      for (int idx = tid; idx < BT * NS; idx += NTHREADS) {
        const int i = idx / NS, n = idx % NS;
        Cn[i * CN + n] = i < ni ? to_f32(cr[(c0 + i0 + i) * sd.ct + n]) : 0.f;
      }
      __syncthreads();

      // off-diagonal: exp(cs_i) C_i . S (the state carried in)
      float yacc[4][PB];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < PB; ++b) yacc[a][b] = 0.f;
      for (int n = 0; n < NS; n += 4) {
        float4 cv[4], sv[PB];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = ld4(Cn + (ty + 16 * a) * CN + n);
#pragma unroll
        for (int b = 0; b < PB; ++b) sv[b] = ld4(St + (tx + 16 * b) * CN + n);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < PB; ++b) yacc[a][b] = fma4(cv[a], sv[b], yacc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        const float e = i < Q ? ecs[i] : 0.f;
#pragma unroll
        for (int b = 0; b < PB; ++b) yacc[a][b] *= e;
      }

      for (int j0 = 0; j0 <= i0; j0 += BT) {
        const int nj = min(BT, Q - j0);
        const bool diag = j0 == i0;
        for (int idx = tid; idx < BT * NS; idx += NTHREADS) {
          const int j = idx / NS, n = idx % NS;
          const float bv = j < nj ? to_f32(br[(c0 + j0 + j) * sd.bt + n]) : 0.f;
          Bn[j * CN + n] = bv;
          if (diag) Bt[n * BS + j] = j < nj ? bv * wq[j0 + j] : 0.f;
        }
        for (int idx = tid; idx < BT * P; idx += NTHREADS) {
          const int j = idx / P, p = idx % P;
          Xt[p * BS + j] = j < nj ? to_f32(xr[(c0 + j0 + j) * sd.xt + p]) : 0.f;
        }
        __syncthreads();

        // scores C_i . B_j, masked (j > i) before the decay exponential
        float s[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
        for (int n = 0; n < NS; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = ld4(Cn + (ty + 16 * a) * CN + n);
#pragma unroll
          for (int b = 0; b < 4; ++b) bv[b] = ld4(Bn + (tx + 16 * b) * CN + n);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) s[a][b] = fma4(cv[a], bv[b], s[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int i = i0 + ty + 16 * a, j = j0 + tx + 16 * b;
            float val = 0.f;
            if (j <= i && i < Q) val = s[a][b] * expf(cs[i] - cs[j]) * dts[j];
            Sp[(ty + 16 * a) * BS + tx + 16 * b] = val;
          }
        __syncthreads();

        // diagonal term: S' . x
        for (int j = 0; j < BT; j += 4) {
          float4 sv[4], xv[PB];
#pragma unroll
          for (int a = 0; a < 4; ++a) sv[a] = ld4(Sp + (ty + 16 * a) * BS + j);
#pragma unroll
          for (int b = 0; b < PB; ++b) xv[b] = ld4(Xt + (tx + 16 * b) * BS + j);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < PB; ++b) yacc[a][b] = fma4(sv[a], xv[b], yacc[a][b]);
        }
        if (diag) {
          // D skip (the query tile's own x is this key tile)
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < PB; ++b)
              yacc[a][b] = fmaf(Xt[(tx + 16 * b) * BS + ty + 16 * a], dsk, yacc[a][b]);
          // this tile's share of the chunk's state update: x^T . (w B)
          for (int q = 0; q < BT; q += 4) {
            float4 xv[PB], bv[NB];
#pragma unroll
            for (int a = 0; a < PB; ++a) xv[a] = ld4(Xt + (ty + 16 * a) * BS + q);
#pragma unroll
            for (int b = 0; b < NB; ++b) bv[b] = ld4(Bt + (tx + 16 * b) * BS + q);
#pragma unroll
            for (int a = 0; a < PB; ++a)
#pragma unroll
              for (int b = 0; b < NB; ++b) upd[a][b] = fma4(xv[a], bv[b], upd[a][b]);
          }
        }
        __syncthreads();               // the tiles are reloaded next
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        if (i < ni) {
          TX* yr = y + (((size_t)r * T + c0 + i0 + i) * H + h) * P;
#pragma unroll
          for (int b = 0; b < PB; ++b) yr[tx + 16 * b] = from_f32<TX>(yacc[a][b]);
        }
      }
    }

    // every query tile has read the old state: fold in the chunk's update
    const float decay = expf(last);
#pragma unroll
    for (int a = 0; a < PB; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float* sp = St + (ty + 16 * a) * CN + tx + 16 * b;
        *sp = fmaf(*sp, decay, upd[a][b]);
      }
    __syncthreads();
  }

  for (int idx = tid; idx < P * NS; idx += NTHREADS)
    final_state[state_base + idx] = St[(idx / NS) * CN + idx % NS];
}

template <typename TX, int P, int NS>
int launch(const void* x, const float* dt, const float* a_log, const void* b, const void* c,
           const float* d_skip, const float* init_state, void* y, float* final_state,
           const Strides& sd, int R, int T, int H, int G, int Q, int Gs, cudaStream_t stream) {
  auto kern = ssd_kernel<TX, P, NS>;
  const size_t smem = smem_floats<P, NS>() * sizeof(float);
  static bool ready = false;   // the opt-in above 48 KB, once per instantiation
  if (!ready) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  dim3 grid(H, R);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const TX*>(x), dt, a_log, static_cast<const TX*>(b),
      static_cast<const TX*>(c), d_skip, init_state, static_cast<TX*>(y), final_state, sd, T,
      H, G, Q, R / Gs);
  return (int)cudaGetLastError();
}

// ============================================================ tensor cores

namespace ssdtc {

using namespace tc;

constexpr int Q = 256;                 // the chunk this body takes
constexpr int TILES = Q / 64;          // 64-position tiles a chunk
constexpr int P = 64;                  // head dim
constexpr int THREADS = 2 * WG;        // two consumer warpgroups, one position a thread
constexpr float NEG_INF = -__builtin_huge_valf();   // ex2 of it is 0
static_assert(THREADS == Q, "the scan takes one position a thread");

template <int N>
struct Smem {   // byte offsets from a 1024-aligned base
  static constexpr int NB = N / 64;                // 64-column boxes of a B, C or S row
  static constexpr int CT = NB * BOX;              // one 64-position tile of C (or B)
  static constexpr int C = 0;                      // [TILES] C tiles; then each
                                                   // warpgroup's (w o B)^T tiles
  static constexpr int B = C + TILES * CT;         // [TILES] B tiles
  static constexpr int X = B + TILES * CT;         // [TILES] x tiles [64][P]
  static constexpr int S = X + TILES * BOX;        // the state's bf16 copy [P][N]
  static constexpr int CS = S + NB * BOX;          // fp32 [Q]: cumsum of dt A, log2 units
  static constexpr int DT = CS + 4 * Q;            // fp32 [Q]: dt
  static constexpr int W = DT + 4 * Q;             // fp32 [Q]: exp(cs_last - cs) dt
  static constexpr int WSUM = W + 4 * Q;           // fp32 [8]: the scan's warp totals
  static constexpr int BARS = WSUM + 32;           // [TILES] mbarriers: a tile's C, B, x
  static constexpr int BYTES = BARS + 8 * TILES;
  static constexpr size_t DYNAMIC = BYTES + 1024;  // + alignment slack
  static constexpr uint32_t TILE_TX = (2 * NB + 1) * BOX;   // bytes a tile's loads bring
};

// state += A^T.B over 16 positions: A a [16][64] x slab (MN-major), B
// n-columns of (w o B)^T (K-major); n = 32 (N = 64) or 64 (N = 128)
template <int NH>
__device__ __forceinline__ void wgmma_update(float (&d)[NH / 2], uint64_t da, uint64_t db) {
  if constexpr (NH == 32)
    wgmma_ss_n32_ta(d, da, db);
  else
    wgmma_ss_n64_ta(d, da, db);
}

// One thread: the C, B and x tiles of row r's chunk at position c0 (head
// h, group grp), tile t completing on bars[t].
template <int N>
__device__ __forceinline__ void load_chunk(unsigned char* base, uint64_t* bars,
                                           const CUtensorMap* xmap, const CUtensorMap* bmap,
                                           const CUtensorMap* cmap, int h, int grp, int r,
                                           int c0) {
  using L = Smem<N>;
  for (int t = 0; t < TILES; ++t) {
    mbar_expect_tx(&bars[t], L::TILE_TX);
    for (int b = 0; b < L::NB; ++b) {
      tma_load_4d(base + L::C + t * L::CT + b * BOX, cmap, &bars[t], 64 * b, grp, c0 + 64 * t, r);
      tma_load_4d(base + L::B + t * L::CT + b * BOX, bmap, &bars[t], 64 * b, grp, c0 + 64 * t, r);
    }
    tma_load_4d(base + L::X + t * BOX, xmap, &bars[t], 0, h, c0 + 64 * t, r);
  }
}

// A thread's accumulator entry (j, r, e) of a 64-row wgmma tile is row
// 16 warp + g + 8r, column 8j + 2 tig + e (g = lane / 4, tig = lane % 4).
template <int N>
__global__ void __launch_bounds__(THREADS, N == 64 ? 2 : 1)
ssd_tc_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap bmap,
              const __grid_constant__ CUtensorMap cmap, const float* __restrict__ dt,
              const float* __restrict__ a_log, const float* __restrict__ d_skip,
              const float* __restrict__ init_state, __nv_bfloat16* __restrict__ y,
              float* __restrict__ final_state, int T, int H, int G, int rows_per_group) {
  using L = Smem<N>;
  constexpr int NH = N / 2;              // state columns a warpgroup owns
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* cs = reinterpret_cast<float*>(base + L::CS);
  float* dts = reinterpret_cast<float*>(base + L::DT);
  float* wq = reinterpret_cast<float*>(base + L::W);
  float* wsum = reinterpret_cast<float*>(base + L::WSUM);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::BARS);

  const int tid = threadIdx.x;
  // from lane 0, so that ptxas sees the warpgroup index (and the loop bounds
  // that follow from it) warp-uniform; else it serializes the wgmmas
  const int wg = __shfl_sync(0xffffffffu, tid / WG, 0);
  const int wtid = tid & (WG - 1), lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int row0 = 16 * (wtid >> 5) + g;   // accumulator rows row0, row0 + 8
  const int h = blockIdx.x, r = blockIdx.y;
  const int sg = r / rows_per_group;
  const float a2 = -expf(a_log[sg * H + h]) * LOG2E;      // A in log2 units
  const float dsk = d_skip[sg * H + h];
  const int grp = h / (H / G);
  const int n0 = wg * NH;                  // this warpgroup's state columns n0..n0+NH-1
  const size_t sbase = ((size_t)r * H + h) * P * N;

  if (tid == 0) {
    for (int t = 0; t < TILES; ++t) mbar_init(&bars[t], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) load_chunk<N>(base, bars, &xmap, &bmap, &cmap, h, grp, r, 0);

  // this warpgroup's state columns, st[4j + 2rr + e]: row row0 + 8rr, column
  // n0 + 8j + 2 tig + e
  float st[NH / 2];
#pragma unroll
  for (int j = 0; j < NH / 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float2 v = make_float2(0.f, 0.f);
      if (init_state != nullptr)
        v = *reinterpret_cast<const float2*>(init_state + sbase + (row0 + 8 * rr) * N + n0 +
                                             8 * j + 2 * tig);
      st[4 * j + 2 * rr] = v.x;
      st[4 * j + 2 * rr + 1] = v.y;
    }

  const int nc = T / Q;
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
    const uint32_t ph = c & 1;
    // ---- the state's bf16 copy [P][N] (K-major, as a B operand of C.S^T)
#pragma unroll
    for (int j = 0; j < NH / 8; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int p = row0 + 8 * rr, n = n0 + 8 * j + 2 * tig, col = n & 63;
        *reinterpret_cast<uint32_t*>(base + L::S + (n >> 6) * BOX + p * 128 +
                                     ((((col >> 3) ^ (p & 7))) << 4) + (col & 7) * 2) =
            pack_bf16(__float2bfloat16_rn(st[4 * j + 2 * rr]),
                      __float2bfloat16_rn(st[4 * j + 2 * rr + 1]));
      }
    fence_async_smem();
    // ---- cs = cumsum(dt A) (log2 units), dt and w: a warp-shuffle scan,
    // then the warp totals; cs[Q - 1] and `tot` are the same sum
    {
      const float d = dt[((size_t)r * T + c0 + tid) * H + h];
      float v = d * a2;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      if (lane == 31) wsum[tid >> 5] = v;
      __syncthreads();
      float pre = 0.f, tot = 0.f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) {
        if (w == (tid >> 5)) pre = tot;
        tot += wsum[w];
      }
      const float csv = v + pre;
      cs[tid] = csv;
      dts[tid] = d;
      wq[tid] = exp2_approx(tot - csv) * d;
    }
    __syncthreads();

    // ---- y of the warpgroup's two query tiles, the longer first: 3 - wg, wg
#pragma unroll 1
    for (int k = 0; k < 2; ++k) {
      const int i = __shfl_sync(0xffffffffu, k == 0 ? TILES - 1 - wg : wg, 0), q0 = 64 * i;
      const unsigned char* ci = base + L::C + i * L::CT;
      const unsigned char* xi = base + L::X + i * BOX;
      float yacc[32], sc[32];
      uint32_t pa[16];
      // Y = C_i.S^T and the scores of key tile 0
      mbar_wait(&bars[i], ph);
      mbar_wait(&bars[0], ph);
      issue_scores<N>(yacc, ci, base + L::S);
      issue_scores<N>(sc, ci, base + L::B);
      wgmma_wait0();
      keep(yacc);
      keep(sc);
      float csi[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {     // Y = exp(cs_i) C_i.S^T + d x_i
        const int row = row0 + 8 * rr;
        csi[rr] = cs[q0 + row];
        const float e = exp2_approx(csi[rr]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
              xi + row * 128 + ((j ^ (row & 7)) << 4) + 4 * tig);
          yacc[4 * j + 2 * rr] = fmaf(yacc[4 * j + 2 * rr], e, dsk * __low2float(xv));
          yacc[4 * j + 2 * rr + 1] = fmaf(yacc[4 * j + 2 * rr + 1], e, dsk * __high2float(xv));
        }
      }
#pragma unroll 1
      for (int j = 0; j <= i; ++j) {
        // P = scores o exp(cs_i - cs_j) o dt_j in bf16, as register A
        // fragments (k-step ks: key columns 16ks..16ks+15)
        const int k0 = 64 * j;
        const bool diag = j == i;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            float pv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * jj + 2 * tig + e;
              const float dl = diag && col > row0 + 8 * rr ? NEG_INF : csi[rr] - cs[k0 + col];
              pv[e] = sc[4 * jj + 2 * rr + e] * exp2_approx(dl) * dts[k0 + col];
            }
            pa[4 * (jj >> 1) + 2 * (jj & 1) + rr] =
                pack_bf16(__float2bfloat16_rn(pv[0]), __float2bfloat16_rn(pv[1]));
          }
        // Y += P.x_j, with the scores of key tile j + 1
        uint64_t dx[4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          dx[ks] = sw128_desc(base + L::X + j * BOX + ks * 2048, BOX, 1024);
        if (j < i) mbar_wait(&bars[j + 1], ph);
        keep(dx);
        keep(pa);
        keep(yacc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_rs_n64(yacc, pa[4 * ks], pa[4 * ks + 1], pa[4 * ks + 2], pa[4 * ks + 3], dx[ks]);
        wgmma_commit();
        keep(yacc);
        if (j < i) issue_scores<N>(sc, ci, base + L::B + (j + 1) * L::CT);
        wgmma_wait0();
        keep(yacc);
        keep(sc);
        keep(pa);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        __nv_bfloat16* yr =
            y + (((size_t)r * T + c0 + q0 + row0 + 8 * rr) * H + h) * P + 2 * tig;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(yr + 8 * j) =
              pack_bf16(__float2bfloat16_rn(yacc[4 * j + 2 * rr]),
                        __float2bfloat16_rn(yacc[4 * j + 2 * rr + 1]));
      }
    }

    // ---- the state update of this warpgroup's columns: S = S exp(cs_last)
    // + x^T.(w o B), tile by tile; (w o B)^T rows n0.. as hi and lo tiles in
    // two buffers, the C tiles of the warpgroup's query tiles (done with)
    const float decay = exp2_approx(cs[Q - 1]);
#pragma unroll
    for (int k = 0; k < NH / 2; ++k) st[k] *= decay;
    auto build = [&](int t, unsigned char* dst) {
      const unsigned char* bt = base + L::B + t * L::CT;
      for (int it = wtid; it < NH * 8; it += WG) {
        const int nl = it % NH, qc = it / NH;       // row of the tile, 8 positions
        const int n = n0 + nl, col = n & 63;
        const unsigned char* bcol = bt + (n >> 6) * BOX + (col & 7) * 2;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float v[2];
          __nv_bfloat16 hv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = 8 * qc + 2 * u + e;
            const __nv_bfloat16 bv = *reinterpret_cast<const __nv_bfloat16*>(
                bcol + q * 128 + (((col >> 3) ^ (q & 7)) << 4));
            v[e] = wq[64 * t + q] * __bfloat162float(bv);
            hv[e] = __float2bfloat16_rn(v[e]);
          }
          hi[u] = pack_bf16(hv[0], hv[1]);
          lo[u] = pack_bf16(__float2bfloat16_rn(v[0] - __bfloat162float(hv[0])),
                            __float2bfloat16_rn(v[1] - __bfloat162float(hv[1])));
        }
        const int off = nl * 128 + ((qc ^ (nl & 7)) << 4);
        *reinterpret_cast<uint4*>(dst + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(dst + NH * 128 + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    };
    auto wbuf = [&](int t) { return base + L::C + ((t & 1) ? wg : TILES - 1 - wg) * L::CT; };
    mbar_wait(&bars[0], ph);
    build(0, wbuf(0));
    fence_async_smem();
    wg_sync(wg);
#pragma unroll 1
    for (int t = 0; t < TILES; ++t) {
      const unsigned char* wb = wbuf(t);
      uint64_t da[4], dh[4], dl[4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        da[ks] = sw128_desc(base + L::X + t * BOX + ks * 2048, BOX, 1024);
        dh[ks] = sw128_desc(wb + ks * 32, 16, 1024);
        dl[ks] = sw128_desc(wb + NH * 128 + ks * 32, 16, 1024);
      }
      keep(da);
      keep(dh);
      keep(dl);
      keep(st);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_update<NH>(st, da[ks], dh[ks]);
        wgmma_update<NH>(st, da[ks], dl[ks]);
      }
      wgmma_commit();
      keep(st);
      if (t + 1 < TILES) {           // the next tile's build under these wgmmas
        mbar_wait(&bars[t + 1], ph);
        build(t + 1, wbuf(t + 1));
      }
      wgmma_wait0();
      keep(st);
      fence_async_smem();
      wg_sync(wg);
    }
    __syncthreads();                 // every read of this chunk's tiles is done
    if (tid == 0 && c + 1 < nc)
      load_chunk<N>(base, bars, &xmap, &bmap, &cmap, h, grp, r, c0 + Q);
  }

#pragma unroll
  for (int j = 0; j < NH / 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      *reinterpret_cast<float2*>(final_state + sbase + (row0 + 8 * rr) * N + n0 + 8 * j +
                                 2 * tig) = make_float2(st[4 * j + 2 * rr], st[4 * j + 2 * rr + 1]);
}

// A bf16 [R, T, heads, cols] view, heads and cols dense, positions at
// stride st and rows at stride sr (elements): a 4-d map {cols, heads, T, R}
// with boxes of {64, 1, 64, 1}, 128-byte swizzle. Strides must be multiples
// of 16 bytes, the base 16-byte aligned.
inline bool view_map(CUtensorMap* map, const void* ptr, int R, int T, int heads, int cols,
                     long long st, long long sr) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)heads, (cuuint64_t)T, (cuuint64_t)R};
  const cuuint64_t strides[3] = {(cuuint64_t)cols * 2, (cuuint64_t)st * 2, (cuuint64_t)sr * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
int launch_tc(const void* x, const float* dt, const float* a_log, const void* b, const void* c,
              const float* d_skip, const float* init_state, void* y, float* final_state,
              const Strides& sd, int R, int T, int H, int G, int Gs, cudaStream_t stream) {
  using L = Smem<N>;
  auto kern = ssd_tc_kernel<N>;
  static bool ready = false;   // the opt-in above 48 KB, once per instantiation
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L::DYNAMIC);
    if (err == cudaSuccess)    // room for two blocks an SM at N = 64
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  CUtensorMap xm, bm, cm;
  if (!view_map(&xm, x, R, T, H, P, sd.xt, sd.xr) || !view_map(&bm, b, R, T, G, N, sd.bt, sd.br) ||
      !view_map(&cm, c, R, T, G, N, sd.ct, sd.cr))
    return (int)cudaErrorInvalidValue;
  dim3 grid(H, R);
  kern<<<grid, THREADS, L::DYNAMIC, stream>>>(xm, bm, cm, dt, a_log, d_skip, init_state,
                                              static_cast<__nv_bfloat16*>(y), final_state, T, H,
                                              G, R / Gs);
  return (int)cudaGetLastError();
}

}  // namespace ssdtc

#define DISPATCH_PN(TX, ...)                                                   \
  if (P == 16 && N == 16) return launch<TX, 16, 16>(__VA_ARGS__);              \
  if (P == 64 && N == 64) return launch<TX, 64, 64>(__VA_ARGS__);              \
  if (P == 64 && N == 128) return launch<TX, 64, 128>(__VA_ARGS__);            \
  return (int)cudaErrorInvalidValue;

}  // namespace

extern "C" {

// K4. x, b and c at the element strides (rows, positions) given, a
// position's heads (groups) and the last dim dense, strides multiples of 16
// bytes; dt, a_log, d_skip, init_state (may be null) contiguous (see the
// top of this file). dtype 0 = fp32, 1 = bf16 for x, b, c and y. Q divides
// T and is at most 256; (P, N) is (16, 16), (64, 64) or (64, 128). bf16 at
// (64, 64) or (64, 128) with Q = 256 runs the tensor-core body, the rest the
// CUDA-core body. Returns cudaGetLastError() after the launch.
int ssd_launch(const void* x, const void* dt, const void* a_log, const void* b,
               const void* c, const void* d_skip, const void* init_state, void* y,
               void* final_state, int dtype, int R, int T, int H, int P, int G, int N, int Q,
               int Gs, long long sxr, long long sxt, long long sbr, long long sbt,
               long long scr, long long sct, void* stream) {
  if (Q <= 0 || Q > MAX_Q || T % Q != 0 || H % G != 0 || Gs <= 0 || R % Gs != 0)
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(a_log);
  const float* ds = static_cast<const float*>(d_skip);
  const float* is = static_cast<const float*>(init_state);
  float* fs = static_cast<float*>(final_state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sd{sxr, sxt, sbr, sbt, scr, sct};
  if (dtype == BF16 && P == ssdtc::P && Q == ssdtc::Q) {
    if (N == 64)
      return ssdtc::launch_tc<64>(x, dtf, al, b, c, ds, is, y, fs, sd, R, T, H, G, Gs, st);
    if (N == 128)
      return ssdtc::launch_tc<128>(x, dtf, al, b, c, ds, is, y, fs, sd, R, T, H, G, Gs, st);
  }
  if (dtype == F32) {
    DISPATCH_PN(float, x, dtf, al, b, c, ds, is, y, fs, sd, R, T, H, G, Q, Gs, st)
  }
  if (dtype == BF16) {
    DISPATCH_PN(__nv_bfloat16, x, dtf, al, b, c, ds, is, y, fs, sd, R, T, H, G, Q, Gs, st)
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
