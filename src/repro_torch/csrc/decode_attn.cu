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
// Design (first, simple version). The Pallas kernel walks S in blocks on a
// sequential grid axis with (m, l, acc) of all G group queries in VMEM. Here
// S is cut into `nsplit` contiguous splits instead (flash-decoding), so that
// B x KVH x nsplit blocks fill the card:
//  - decode_partial_kernel: one block of 128 threads per (split, kv head,
//    batch row). A "row group" of threads holds one key row, each thread 16
//    bytes of it (8 bf16 or 4 fp32 values), and keeps its slice of the G
//    queries, pre-scaled by scale * log2(e), in registers. Each row group
//    loads U = 4 keys and their values at once (16-byte loads, all issued
//    before any use), reduces the G x U dot products with xor shuffles inside
//    the row group and folds them into its own fp32 (m, l, acc) in base 2.
//    Positions at or beyond len_b are never loaded: they enter the update as
//    -inf before the exponent, with zero values, so no 0 * inf is formed.
//    The row groups' states merge through shared memory into one partial
//    state per (split, query head), written to fp32 scratch.
//  - decode_combine_kernel: one block per (query head, batch row) merges the
//    splits' partial states and writes acc / max(l, 1e-30).
// A split that starts at or beyond len_b loads nothing and writes the
// identity state (m = -inf, l = 0, acc = 0).
//
// What bounds it on an H100: decode reads every K/V byte once and does
// ~4 G D flops per key, so the bytes bound it (qwen3-8b, B 8, S 32768, bf16:
// 1.07 GB, 0.32 ms at 3.35 TB/s). This version keeps 8 16-byte loads in
// flight per thread and no more (no cp.async / TMA pipeline), and the split
// count is chosen from S, not from the lengths, so ragged short rows leave
// blocks idle; PERF.md keeps the measured distance to the bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int U = 4;                      // keys a row group loads at once
constexpr float LOG2E = 1.4426950408889634f;

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
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

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32;
}

// Partial state of one (split, kv head, batch row) block. Scratch layout:
// part_m / part_l [B, KVH, nsplit, G], part_acc [B, KVH, nsplit, G, D].
template <typename T, int D, int G>
__global__ void __launch_bounds__(NTHREADS)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ kv_len,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int H, int S, int KVH,
                      int split_len, float qscale) {
  constexpr int VEC = 16 / (int)sizeof(T);   // values a thread loads per row
  constexpr int TPR = D / VEC;               // threads holding one key row
  constexpr int TPR_P = pow2_at_least(TPR);  // row group: TPR padded to 2^n
  constexpr int RG = NTHREADS / TPR_P;       // row groups per block
  constexpr int STEP = RG * U;               // keys per block iteration
  static_assert(D % VEC == 0 && TPR <= 32, "head dim");

  __shared__ float sm_m[RG][G];
  __shared__ float sm_l[RG][G];
  __shared__ float sm_acc[RG][G][D];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % TPR_P, rg = threadIdx.x / TPR_P;
  const bool active = lane < TPR;
  const int len = min(max(kv_len[b], 0), S);
  const int start = split * split_len;
  const int end = min(start + split_len, len);

  float qf[G][VEC], acc[G][VEC], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (active) {
      unpack<T>(ld16(q + ((size_t)b * H + (size_t)kvh * G + g) * D + lane * VEC), qf[g]);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qf[g][i] = active ? qf[g][i] * qscale : 0.f;
      acc[g][i] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  const size_t pos_stride = (size_t)KVH * D;   // elements between positions
  const size_t off = ((size_t)b * S * KVH + kvh) * D + lane * VEC;
  const T* kb = k + off;
  const T* vb = v + off;

  // every thread runs the same iterations (the shuffles need the whole warp)
  for (int base = start; base < end; base += STEP) {
    const int p0 = base + rg * U;
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u;
      if (active && p < end) {
        kr[u] = ld16(kb + (size_t)p * pos_stride);
        vr[u] = ld16(vb + (size_t)p * pos_stride);
      } else {
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float s[G][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      unpack<T>(kr[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) d = fmaf(qf[g][i], kf[i], d);
        s[g][u] = d;
      }
    }
#pragma unroll
    for (int o = TPR_P / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int u = 0; u < U; ++u) s[g][u] += __shfl_xor_sync(0xffffffffu, s[g][u], o);
      }
    }
    if (p0 >= end) continue;   // this row group has no key left (uniform in it)
    float p[G][U];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (p0 + u >= end) s[g][u] = -INFINITY;   // masked before the exponent
        mx = fmaxf(mx, s[g][u]);
      }
      // mx is finite: key p0 is valid
      const float corr = exp2f(m[g] - mx);
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
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VEC];
      unpack<T>(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(p[g][u], vf[i], acc[g][i]);
      }
    }
  }

  // merge the row groups' states
  if (active) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[rg][g][lane * VEC + i] = acc[g][i];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[rg][g] = m[g];
      sm_l[rg][g] = l[g];
    }
  }
  __syncthreads();
  const size_t part0 = (((size_t)b * KVH + kvh) * gridDim.x + split) * G;
  for (int e = threadIdx.x; e < G * D; e += NTHREADS) {
    const int g = e / D, d = e % D;
    float mx = -INFINITY;
    for (int r = 0; r < RG; ++r) mx = fmaxf(mx, sm_m[r][g]);
    float ls = 0.f, as = 0.f;
    if (mx != -INFINITY) {
      for (int r = 0; r < RG; ++r) {
        const float mr = sm_m[r][g];
        if (mr == -INFINITY) continue;   // a row group that saw no key
        const float w = exp2f(mr - mx);
        ls = fmaf(sm_l[r][g], w, ls);
        as = fmaf(sm_acc[r][g][d], w, as);
      }
    }
    part_acc[(part0 + g) * D + d] = as;
    if (d == 0) {
      part_m[part0 + g] = mx;
      part_l[part0 + g] = ls;
    }
  }
}

// out[b, h] = merged acc / max(l, 1e-30) over the splits; one block per
// (query head, batch row), one thread per output element.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ out, int H,
                      int KVH, int D, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = H / KVH, kvh = h / G, g = h % G;
  const size_t part0 = ((size_t)b * KVH + kvh) * nsplit;
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, part_m[(part0 + s) * G + g]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float ls = 0.f, as = 0.f;
    if (mx != -INFINITY) {
      for (int s = 0; s < nsplit; ++s) {
        const size_t i = (part0 + s) * G + g;
        const float ms = part_m[i];
        if (ms == -INFINITY) continue;   // a split beyond the valid length
        const float w = exp2f(ms - mx);
        ls = fmaf(part_l[i], w, ls);
        as = fmaf(part_acc[i * D + d], w, as);
      }
    }
    out[((size_t)b * H + h) * D + d] = from_f32<T>(as / fmaxf(ls, 1e-30f));
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const int* kv_len, float* part_m,
           float* part_l, float* part_acc, void* out, int B, int H, int KVH, int S,
           int nsplit, int split_len, float scale, cudaStream_t stream) {
  dim3 grid(nsplit, KVH, B);
  decode_partial_kernel<T, D, G><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_len,
      part_m, part_l, part_acc, H, S, KVH, split_len, scale * LOG2E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<dim3(H, B), NTHREADS, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), H, KVH, D, nsplit);
  return (int)cudaGetLastError();
}

#define DISPATCH_G(T, D, ...)                                                  \
  if (G == 1) return launch<T, D, 1>(__VA_ARGS__);                             \
  if (G == 2) return launch<T, D, 2>(__VA_ARGS__);                             \
  if (G == 4) return launch<T, D, 4>(__VA_ARGS__);                             \
  if (G == 8) return launch<T, D, 8>(__VA_ARGS__);                             \
  return (int)cudaErrorInvalidValue;

#define DISPATCH_DG(T, ...)                                                    \
  if (D == 16) { DISPATCH_G(T, 16, __VA_ARGS__) }                              \
  if (D == 112) { DISPATCH_G(T, 112, __VA_ARGS__) }                            \
  if (D == 128) { DISPATCH_G(T, 128, __VA_ARGS__) }                            \
  return (int)cudaErrorInvalidValue;

}  // namespace

extern "C" {

// K5. q [B,H,D], k/v [B,S,KVH,D] and out [B,H,D] contiguous, in one dtype
// (0 = fp32, 1 = bf16); kv_len [B] int32 on the device. part_m / part_l
// [B,KVH,nsplit,G] and part_acc [B,KVH,nsplit,G,D] are fp32 scratch, with
// nsplit * split_len >= S. D is 16, 112 or 128 and G = H / KVH is 1, 2, 4 or
// 8. Returns cudaGetLastError() after the launches.
int decode_attention_launch(const void* q, const void* k, const void* v, const void* kv_len,
                            void* part_m, void* part_l, void* part_acc, void* out, int dtype,
                            int B, int H, int KVH, int D, int S, int nsplit, int split_len,
                            float scale, void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || S <= 0 || nsplit <= 0 || split_len <= 0 ||
      (long long)nsplit * split_len < S)
    return (int)cudaErrorInvalidValue;
  const int G = H / KVH;
  const int* len = static_cast<const int*>(kv_len);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32) {
    DISPATCH_DG(float, q, k, v, len, pm, pl, pa, out, B, H, KVH, S, nsplit, split_len, scale, st)
  }
  if (dtype == BF16) {
    DISPATCH_DG(__nv_bfloat16, q, k, v, len, pm, pl, pa, out, B, H, KVH, S, nsplit, split_len,
                scale, st)
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
