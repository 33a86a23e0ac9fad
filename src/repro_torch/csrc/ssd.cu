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
// h / (H/G)); dt [R,T,H] fp32 (after softplus); a_log, d_skip [Gs,H] fp32, one
// row per equal stage group of R/Gs rows (each pipeline stage has its own
// layer); init_state [R,H,P,N] fp32 or null. Outputs y in x's dtype and the
// final state [R,H,P,N] fp32.
//
// Design (first, simple version): one thread block per (row, head); the
// TPU's sequential chunk grid axis becomes a loop inside the block, and the
// state lives in fp32 shared memory across it (nothing crosses blocks).
// Within a chunk the block walks query tiles of 64 positions; for each, the
// off-diagonal term reads the state, then every key tile at or below the
// diagonal forms the 64x64 score tile C.B^T, masks j > i BEFORE taking
// exp(cs_i - cs_j) (above the diagonal the difference is positive and could
// overflow; no 0*inf is ever formed), and adds S'.x. The diagonal key tile
// is visited exactly once per chunk, so the chunk's state update
// sum_q w_q x_q (x) B_q accumulates in registers there and is folded into the
// state after the last query tile has read the old one. All tiles are fp32
// in shared memory, rows padded by 4 floats so the float4 reads along the
// contracted axis of 8 neighbouring threads hit distinct banks; each of the
// 256 threads owns a 4x4 (strided by 16) register tile of every product.
//
// What bounds it on an H100: at the serve shapes (zamba2-7b: 16 rows x 112
// heads x 2 chunks of 256, P = N = 64, bf16) the bytes (x and y, the fp32
// state in and out) and the operations on the bf16 tensor-core peak give
// about the same least time (~0.1 ms). This version runs its products on
// the CUDA cores in fp32 out of shared memory, so the fp32 FMA rate and
// shared-memory bandwidth bound it; wgmma on bf16 tiles fed by TMA is the
// next step, and PERF.md keeps the measured distance to the bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;   // a 16 x 16 grid of threads
constexpr int BT = 64;          // query / key positions per tile
constexpr int MAX_Q = 256;      // chunk length limit (one position per thread)
constexpr int BS = BT + 4;      // padded row stride of the [*, BT] tiles

enum DType { F32 = 0, BF16 = 1 };

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
           float* __restrict__ final_state, int T, int H, int G, int Q, int rows_per_group) {
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
        Cn[i * CN + n] =
            i < ni ? to_f32(cm[(((size_t)r * T + c0 + i0 + i) * G + g) * NS + n]) : 0.f;
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
          const float bv =
              j < nj ? to_f32(bm[(((size_t)r * T + c0 + j0 + j) * G + g) * NS + n]) : 0.f;
          Bn[j * CN + n] = bv;
          if (diag) Bt[n * BS + j] = j < nj ? bv * wq[j0 + j] : 0.f;
        }
        for (int idx = tid; idx < BT * P; idx += NTHREADS) {
          const int j = idx / P, p = idx % P;
          Xt[p * BS + j] =
              j < nj ? to_f32(x[(((size_t)r * T + c0 + j0 + j) * H + h) * P + p]) : 0.f;
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
           const float* d_skip, const float* init_state, void* y, float* final_state, int R,
           int T, int H, int G, int Q, int Gs, cudaStream_t stream) {
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
      static_cast<const TX*>(c), d_skip, init_state, static_cast<TX*>(y), final_state, T, H,
      G, Q, R / Gs);
  return (int)cudaGetLastError();
}

#define DISPATCH_PN(TX, ...)                                                   \
  if (P == 16 && N == 16) return launch<TX, 16, 16>(__VA_ARGS__);              \
  if (P == 64 && N == 64) return launch<TX, 64, 64>(__VA_ARGS__);              \
  if (P == 64 && N == 128) return launch<TX, 64, 128>(__VA_ARGS__);            \
  return (int)cudaErrorInvalidValue;

}  // namespace

extern "C" {

// K4. Pointers to contiguous tensors (see the top of this file); init_state
// may be null. dtype 0 = fp32, 1 = bf16 for x, b, c and y. Q divides T and
// is at most 256; (P, N) is (16, 16), (64, 64) or (64, 128). Returns
// cudaGetLastError() after the launch.
int ssd_launch(const void* x, const void* dt, const void* a_log, const void* b,
               const void* c, const void* d_skip, const void* init_state, void* y,
               void* final_state, int dtype, int R, int T, int H, int P, int G, int N, int Q,
               int Gs, void* stream) {
  if (Q <= 0 || Q > MAX_Q || T % Q != 0 || H % G != 0 || Gs <= 0 || R % Gs != 0)
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(a_log);
  const float* ds = static_cast<const float*>(d_skip);
  const float* is = static_cast<const float*>(init_state);
  float* fs = static_cast<float*>(final_state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32) {
    DISPATCH_PN(float, x, dtf, al, b, c, ds, is, y, fs, R, T, H, G, Q, Gs, st)
  }
  if (dtype == BF16) {
    DISPATCH_PN(__nv_bfloat16, x, dtf, al, b, c, ds, is, y, fs, R, T, H, G, Q, Gs, st)
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
