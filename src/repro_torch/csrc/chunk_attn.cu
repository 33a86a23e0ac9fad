// Chunked-prefill flash attention for Hopper (sm_90a): the three attention
// kernels of MOCAP's prefill path, sharing one online-softmax block update.
//
// Replaces (TPU kernels in src/repro/kernels/chunk_attn.py):
//   chunk_attention_launch       <- chunk_attention_pallas       (K1, _attn_kernel)
//   pool_attention_launch        <- pool_attention_pallas        (K2, _pool_kernel)
//   pool_attention_paged_launch  <- pool_attention_paged_pallas  (K3, _paged_kernel)
// and block_update() below (CUDA cores) and tc::issue_scores() +
// softmax_max() + softmax_p() + issue_pv() in chunk_attn_tc.cuh (tensor
// cores) replace _block_update.
//
// What each computes (fp32 state throughout, as the TPU kernels):
//   K1  q [B,C,H,D] against k/v [B,T,KVH,D]; key j visible to query i iff
//       j <= i + causal_offset and j < kv_len; tiles above the causal
//       diagonal are never loaded. Returns out [B,C,H,D] in q's dtype and,
//       when asked, the state (m, l) [B,H,C] and unnormalized acc [B,C,H,D].
//   K2  q [G*B,C,H,D] against a stack of S stored chunks k/v
//       [S,G*B,T,KVH,D], all fully visible below kv_len; valid [G,S] gates
//       each (group, slot): an invalid slot is skipped before anything is
//       loaded, so it contributes the exact identity state (-1e30, 0, 0).
//   K3  the same state as K2, but K/V rows are read in place from a strided,
//       stage-stacked page store [G,P,B,pt,KVH,D] through page handles
//       [S*ppc] (no gathered stack exists anywhere); pages past kv_len are
//       never visited and a partial last page is masked.
// Head dims D = 16 (smoke), 64 (granite-3-2b, granite-moe-3b-a800m), 80
// (stablelm-3b), 112 (zamba2-7b's shared block) and 128 (qwen3-8b,
// qwen2-moe-a2.7b); D % 8 == 0 is what the float4 halves of a row need.
// GQA maps query head h to kv head h / (H / KVH), any group size G (1, 3,
// 4, ...: nothing assumes a power of two). int8 / fp8 K/V are
// dequantized inside the kernels: per-token fp32 scales [.., T, KVH] for
// K1/K2, per-page scales for K3.
//
// Two bodies, chosen statically by q's dtype and the head dim (launch_chunk,
// launch_pool, launch_paged; K3 also by its page shape; no runtime
// fallback: a body that fails to build or launch raises):
//
// * K1, K2 and K3 with bf16 q and bf16 / int8 / fp8 K/V at D = 64, 80, 112
//   or 128 (tc::tc_head_dim)
//   — every K1, K2 and K3 launch of the bf16 main paths (K3: pages that
//   fill whole 64-key tiles, tc::paged_tc_fits) — run the tensor-core
//   body (chunk_attn_tc.cuh), one kernel over three unit walks: a persistent
//   grid, one block an SM, with two consumer warpgroups, each walking its
//   own units (a 64-row query block of one head) longest first, and a
//   producer warpgroup that loads their Q and 64-key K/V tiles by TMA
//   ahead across units, into mbarrier rings (1-byte tiles are widened to
//   bf16 in shared memory once, exact), and lends its registers to the
//   consumers (setmaxnreg). S = Q·K^T and P·V are wgmma products with fp32
//   accumulators; the next tile's S runs under this tile's exponentials;
//   P is fed from registers and split hi + lo so that P·V keeps p to ~16
//   bits as the reference's fp32 p·V does. K1's units are causal (tiles
//   above the diagonal never load); out leaves by TMA stores, acc by
//   stores that fill whole 32-byte sectors. K2's units walk the valid
//   slots of their group (SlotCursor: tile j of valid slot s of row bg is
//   row s*G*B + bg of k/v seen as [S*G*B, T, KVH, D]); a block collects
//   valid [G, S] once, units of the groups with the most valid slots go
//   first, and a group with none stores the identity state without a
//   load. K3's units are K2's, with each tile loaded in place from the
//   page store through the page handles (PagedCursor: a box of a page, or
//   64 / pt boxes of whole pages, of a 5-D map of the strided store), so
//   K2 and K3 sum a slot stack in the same order. What bounds them: K1 at
//   qwen3-8b's shape (C = 512, D = 128) by bytes, two thirds of them the
//   outputs (out bf16 and the fp32 acc the combine chain needs); K2 and
//   K3 by operations (their fp32 acc is written once per query, their
//   products run over every valid slot), at the bf16 tensor-core rate
//   with P·V counted twice. PERF.md keeps the distances.
//
// * Everything else — fp32 q (the 1e-4 parity mode, which TF32 products
//   could not meet), D = 16, and K3's other page shapes — runs the first,
//   simple body: one thread block per (group*batch, head, 64-row query
//   block); 128 threads, two per query row, each owning half of the head
//   dim in registers (q, acc). A loop inside the block walks the K/V tiles (32 rows) of every
//   visited chunk — the Hopper form of the TPU's sequential inner grid
//   axes (nk for K1, (slot, nk) for K2, (slot, page) for K3). Tiles land
//   in shared memory in their storage dtype by cp.async, double-buffered:
//   the next tile (possibly the next valid slot's or page's) is in flight
//   while the current one computes — the counterpart of K3's
//   make_async_copy double buffer. Each landed tile is dequantized once
//   into fp32 shared tiles that every query row of the block reuses. Its
//   products run on the CUDA cores in fp32, so the fp32 FMA issue rate and
//   shared-memory reads bound it, far from the bf16 tensor-core rate.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

#include "chunk_attn_tc.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 32;          // key rows per tile
constexpr int NTHREADS = 128;   // two threads per query row
constexpr int MAX_SLOTS = 1024; // visited slots per launch (K2 / K3)
constexpr float NEG_INF = -1e30f;

enum DType { F32 = 0, BF16 = 1, I8 = 2, FP8 = 3 };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}
template <> __device__ __forceinline__ float to_f32<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ------------------------------------------------------------ K/V sources
// A source names the chunks a block visits and where row r of chunk ci
// lives; every chunk has the same row limit `rows`.

template <typename TKV>
struct DenseSrc {            // K1: one chunk, rows of k [B,T,KVH,D]
  const TKV* k; const TKV* v; const float* ks; const float* vs;
  int T, KVH, D, hk, b, rows, causal_offset;
  __device__ int nchunks() const { return rows > 0 ? 1 : 0; }
  __device__ size_t row(int, int r) const { return (size_t)(b * T + r) * KVH + hk; }
  __device__ const TKV* krow(int ci, int r) const { return k + row(ci, r) * D; }
  __device__ const TKV* vrow(int ci, int r) const { return v + row(ci, r) * D; }
  __device__ float kscale(int ci, int r) const { return ks ? ks[row(ci, r)] : 1.f; }
  __device__ float vscale(int ci, int r) const { return vs ? vs[row(ci, r)] : 1.f; }
  __device__ bool visible(int qpos, int kpos) const { return kpos <= qpos + causal_offset; }
};

template <typename TKV>
struct StackSrc {            // K2: valid slots of k [S,GB,T,KVH,D]
  const TKV* k; const TKV* v; const float* ks; const float* vs;
  const int* slots; int nslots;
  int GB, T, KVH, D, hk, bg, rows;
  __device__ int nchunks() const { return rows > 0 ? nslots : 0; }
  __device__ size_t row(int ci, int r) const {
    return ((size_t)(slots[ci] * GB + bg) * T + r) * KVH + hk;
  }
  __device__ const TKV* krow(int ci, int r) const { return k + row(ci, r) * D; }
  __device__ const TKV* vrow(int ci, int r) const { return v + row(ci, r) * D; }
  __device__ float kscale(int ci, int r) const { return ks ? ks[row(ci, r)] : 1.f; }
  __device__ float vscale(int ci, int r) const { return vs ? vs[row(ci, r)] : 1.f; }
  __device__ bool visible(int, int) const { return true; }
};

template <typename TKV>
struct PagedSrc {            // K3: valid slots' pages of a strided page store
  const TKV* k; const TKV* v; const float* ks; const float* vs;
  const int* handles; const int* slots; int nslots;
  int ppc, pt, hk, g, b, rows;
  long long sg, sp, sb, st, sh;       // page-store strides (elements)
  long long ssg, ssp, ssb, ssh;       // scale strides (elements)
  __device__ int nchunks() const { return rows > 0 ? nslots : 0; }
  __device__ int handle(int ci, int r) const { return handles[slots[ci] * ppc + r / pt]; }
  __device__ long long off(int ci, int r) const {
    return g * sg + (long long)handle(ci, r) * sp + b * sb + (long long)(r % pt) * st + hk * sh;
  }
  __device__ const TKV* krow(int ci, int r) const { return k + off(ci, r); }
  __device__ const TKV* vrow(int ci, int r) const { return v + off(ci, r); }
  __device__ long long soff(int ci, int r) const {
    return g * ssg + (long long)handle(ci, r) * ssp + b * ssb + hk * ssh;
  }
  __device__ float kscale(int ci, int r) const { return ks ? ks[soff(ci, r)] : 1.f; }
  __device__ float vscale(int ci, int r) const { return vs ? vs[soff(ci, r)] : 1.f; }
  __device__ bool visible(int, int) const { return true; }
};

// ------------------------------------------------------------- the update

// One online-softmax block update of this thread's query row against the
// fp32 tile in shared memory (the counterpart of _block_update). Both
// threads of a row hold the full score row after the pair reduction.
template <int D>
__device__ __forceinline__ void block_update(const float* q, float* acc, float& m_i,
                                             float& l_i, const float* Kf, const float* Vf,
                                             const bool* vis, float scale, int half) {
  float s[BK];
#pragma unroll
  for (int j = 0; j < BK; ++j) {
    const float4* kr = reinterpret_cast<const float4*>(Kf + j * D);
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float4 kk = kr[2 * i + half];
      part += q[4 * i] * kk.x + q[4 * i + 1] * kk.y + q[4 * i + 2] * kk.z + q[4 * i + 3] * kk.w;
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    s[j] = vis[j] ? part * scale : NEG_INF;
  }
  float m_new = m_i;
#pragma unroll
  for (int j = 0; j < BK; ++j) m_new = fmaxf(m_new, s[j]);
  // fully masked rows: exp against a safe max so p == 0, not exp(0) == 1
  const float m_safe = m_new < NEG_INF / 2 ? 0.f : m_new;
  const float corr = expf(m_i - m_safe);
  float psum = 0.f;
#pragma unroll
  for (int j = 0; j < BK; ++j) {
    s[j] = expf(s[j] - m_safe);
    psum += s[j];
  }
  l_i = l_i * corr + psum;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= corr;
#pragma unroll
  for (int j = 0; j < BK; ++j) {
    const float4* vr = reinterpret_cast<const float4*>(Vf + j * D);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float4 vv = vr[2 * i + half];
      acc[4 * i] += s[j] * vv.x;
      acc[4 * i + 1] += s[j] * vv.y;
      acc[4 * i + 2] += s[j] * vv.z;
      acc[4 * i + 3] += s[j] * vv.w;
    }
  }
  m_i = m_new;
}

template <typename TKV, int D>
constexpr size_t smem_bytes() {
  return 4 * (size_t)BK * D * sizeof(TKV) + 2 * (size_t)BK * D * sizeof(float)
         + 2 * BK * sizeof(float);
}

// The block body shared by all three kernels: stream every tile of every
// visited chunk through block_update, then hand back (m, l, acc).
template <typename TQ, typename TKV, int D, class Src>
__device__ void flash_block(const Src& src, const TQ* qrow_base, int qi, bool row_ok,
                            float scale, float& m_i, float& l_i, float* acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  TKV* raw = reinterpret_cast<TKV*>(smem);                 // [2][K|V][BK][D]
  float* Kf = reinterpret_cast<float*>(smem + 4 * (size_t)BK * D * sizeof(TKV));
  float* Vf = Kf + BK * D;
  float* ksc = Vf + BK * D;
  float* vsc = ksc + BK;

  const int tid = threadIdx.x;
  const int half = tid & 1;
  float q[D / 2];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      q[4 * i + e] = row_ok ? to_f32(qrow_base[8 * i + 4 * half + e]) : 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  m_i = NEG_INF;
  l_i = 0.f;

  const int tiles_per_chunk = (src.rows + BK - 1) / BK;
  const int ntiles = src.nchunks() * tiles_per_chunk;
  constexpr int CPR = D * (int)sizeof(TKV) / 16;          // 16-byte pieces per row

  auto issue = [&](int it) {
    const int ci = it / tiles_per_chunk, r0 = (it % tiles_per_chunk) * BK;
    const int nrows = min(BK, src.rows - r0);
    TKV* kb = raw + (size_t)(it & 1) * 2 * BK * D;
    TKV* vb = kb + BK * D;
    for (int idx = tid; idx < nrows * CPR; idx += NTHREADS) {
      const int r = idx / CPR, piece = idx % CPR;
      cp_async16(reinterpret_cast<char*>(kb + r * D) + piece * 16,
                 reinterpret_cast<const char*>(src.krow(ci, r0 + r)) + piece * 16);
      cp_async16(reinterpret_cast<char*>(vb + r * D) + piece * 16,
                 reinterpret_cast<const char*>(src.vrow(ci, r0 + r)) + piece * 16);
    }
  };

  if (ntiles > 0) issue(0);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) issue(it + 1);
    cp_async_commit();
    cp_async_wait_1();                 // tile `it` has landed
    const int ci = it / tiles_per_chunk, r0 = (it % tiles_per_chunk) * BK;
    const int nrows = min(BK, src.rows - r0);
    if (tid < BK) {
      ksc[tid] = tid < nrows ? src.kscale(ci, r0 + tid) : 0.f;
      vsc[tid] = tid < nrows ? src.vscale(ci, r0 + tid) : 0.f;
    }
    __syncthreads();
    // dequantize once into the fp32 tiles; rows past the limit become 0 so
    // masked probabilities (exactly 0) never meet garbage
    const TKV* kb = raw + (size_t)(it & 1) * 2 * BK * D;
    const TKV* vb = kb + BK * D;
    for (int idx = tid; idx < BK * D; idx += NTHREADS) {
      const int r = idx / D;
      const bool ok = r < nrows;
      Kf[idx] = ok ? to_f32(kb[idx]) * ksc[r] : 0.f;
      Vf[idx] = ok ? to_f32(vb[idx]) * vsc[r] : 0.f;
    }
    __syncthreads();
    bool vis[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) vis[j] = j < nrows && src.visible(qi, r0 + j);
    block_update<D>(q, acc, m_i, l_i, Kf, Vf, vis, scale, half);
    __syncthreads();                   // tiles are rewritten next iteration
  }
}

template <int D>
__device__ __forceinline__ void store_state(float m_i, float l_i, const float* acc, int half,
                                            float* m_out, float* l_out, float* acc_out,
                                            size_t ml_idx, size_t acc_base) {
  if (half == 0) {
    m_out[ml_idx] = m_i;
    l_out[ml_idx] = l_i;
  }
  float4* a = reinterpret_cast<float4*>(acc_out + acc_base);
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    a[2 * i + half] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
}

// ----------------------------------------------------------------- kernels

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(NTHREADS)
chunk_attn_kernel(const TQ* __restrict__ q, const TKV* k, const TKV* v, const float* ks,
                  const float* vs, TQ* out, float* m_out, float* l_out, float* acc_out,
                  int C, int H, int T, int KVH, int causal_offset, int kv_len, float scale) {
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, half = tid & 1;
  const int qi = q0 + (tid >> 1);
  const bool row_ok = qi < C;
  const int last_q = min(q0 + BQ, C) - 1;
  DenseSrc<TKV> src{k, v, ks, vs, T, KVH, D, h / (H / KVH), b,
                    max(0, min(kv_len, last_q + causal_offset + 1)), causal_offset};
  const size_t row = ((size_t)b * C + (row_ok ? qi : 0)) * H + h;
  float m_i, l_i, acc[D / 2];
  flash_block<TQ, TKV, D>(src, q + row * D, qi, row_ok, scale, m_i, l_i, acc);
  if (!row_ok) return;
  const float inv = 1.f / fmaxf(l_i, 1e-30f);
  TQ* o = out + row * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[8 * i + 4 * half + e] = from_f32<TQ>(acc[4 * i + e] * inv);
  if (m_out != nullptr)
    store_state<D>(m_i, l_i, acc, half, m_out, l_out, acc_out,
                   ((size_t)b * H + h) * C + qi, row * D);
}

__device__ int collect_slots(const uint8_t* valid, int g, int S, int* slots) {
  __shared__ int n_valid;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int s = 0; s < S; ++s)
      if (valid[g * S + s] != 0) slots[n++] = s;
    n_valid = n;
  }
  __syncthreads();
  return n_valid;
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(NTHREADS)
pool_attn_kernel(const TQ* __restrict__ q, const TKV* k, const TKV* v, const float* ks,
                 const float* vs, const uint8_t* valid, float* m_out, float* l_out,
                 float* acc_out, int B, int C, int H, int S, int T, int KVH, int kv_len,
                 float scale) {
  __shared__ int slots[MAX_SLOTS];
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bg = blockIdx.z;
  const int GB = gridDim.z;
  const int tid = threadIdx.x, half = tid & 1;
  const int qi = q0 + (tid >> 1);
  const bool row_ok = qi < C;
  const int nslots = collect_slots(valid, bg / B, S, slots);
  StackSrc<TKV> src{k, v, ks, vs, slots, nslots, GB, T, KVH, D, h / (H / KVH), bg, kv_len};
  const size_t row = ((size_t)bg * C + (row_ok ? qi : 0)) * H + h;
  float m_i, l_i, acc[D / 2];
  flash_block<TQ, TKV, D>(src, q + row * D, qi, row_ok, scale, m_i, l_i, acc);
  if (row_ok)
    store_state<D>(m_i, l_i, acc, half, m_out, l_out, acc_out,
                   ((size_t)bg * H + h) * C + qi, row * D);
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(NTHREADS)
paged_attn_kernel(const TQ* __restrict__ q, const TKV* k, const TKV* v, const float* ks,
                  const float* vs, const int* handles, const uint8_t* valid, float* m_out,
                  float* l_out, float* acc_out, int B, int C, int H, int S, int ppc, int pt,
                  int KVH, int kv_len, long long sg, long long sp, long long sb,
                  long long st, long long sh, long long ssg, long long ssp, long long ssb,
                  long long ssh, float scale) {
  __shared__ int slots[MAX_SLOTS];
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bg = blockIdx.z;
  const int g = bg / B, b = bg % B;
  const int tid = threadIdx.x, half = tid & 1;
  const int qi = q0 + (tid >> 1);
  const bool row_ok = qi < C;
  const int nslots = collect_slots(valid, g, S, slots);
  PagedSrc<TKV> src{k, v, ks, vs, handles, slots, nslots, ppc, pt, h / (H / KVH), g, b,
                    kv_len, sg, sp, sb, st, sh, ssg, ssp, ssb, ssh};
  const size_t row = ((size_t)bg * C + (row_ok ? qi : 0)) * H + h;
  float m_i, l_i, acc[D / 2];
  flash_block<TQ, TKV, D>(src, q + row * D, qi, row_ok, scale, m_i, l_i, acc);
  if (row_ok)
    store_state<D>(m_i, l_i, acc, half, m_out, l_out, acc_out,
                   ((size_t)bg * H + h) * C + qi, row * D);
}

// --------------------------------------------------------------- dispatch

// Above 48 KB a block needs the opt-in; each launcher instantiation sets it
// once for its own kernel (the flag lives in the launcher, not here, since
// kernels of one signature share a function-pointer type).
template <typename F>
cudaError_t prepare(F kernel, size_t smem, bool& ready) {
  if (ready) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  ready = err == cudaSuccess;
  return err;
}

template <typename TQ, typename TKV, int D>
int launch_chunk(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                 void* out, float* m, float* l, float* acc, int B, int C, int H, int T, int KVH,
                 int causal_offset, int kv_len, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value && tc::tc_head_dim(D)) {
    return tc::launch_chunk_tc<TKV, D>(q, k, v, ks, vs, out, m, l, acc, B, C, H, T, KVH,
                                       causal_offset, kv_len, scale, stream);
  } else {
    auto kern = chunk_attn_kernel<TQ, TKV, D>;
    const size_t smem = smem_bytes<TKV, D>();
    static bool ready = false;
    cudaError_t err = prepare(kern, smem, ready);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((C + BQ - 1) / BQ, H, B);
    kern<<<grid, NTHREADS, smem, stream>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), ks,
        vs, static_cast<TQ*>(out), m, l, acc, C, H, T, KVH, causal_offset, kv_len, scale);
    return (int)cudaGetLastError();
  }
}

template <typename TQ, typename TKV, int D>
int launch_pool(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                const uint8_t* valid, float* m, float* l, float* acc, int G, int B, int C,
                int H, int S, int T, int KVH, int kv_len, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value && tc::tc_head_dim(D)) {
    return tc::launch_pool_tc<TKV, D>(q, k, v, ks, vs, valid, m, l, acc, G, B, C, H, S, T,
                                      KVH, kv_len, scale, stream);
  } else {
    auto kern = pool_attn_kernel<TQ, TKV, D>;
    const size_t smem = smem_bytes<TKV, D>();
    static bool ready = false;
    cudaError_t err = prepare(kern, smem, ready);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((C + BQ - 1) / BQ, H, G * B);
    kern<<<grid, NTHREADS, smem, stream>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), ks,
        vs, valid, m, l, acc, B, C, H, S, T, KVH, kv_len, scale);
    return (int)cudaGetLastError();
  }
}

template <typename TQ, typename TKV, int D>
int launch_paged(const void* q, const void* k, const void* v, const float* ks,
                 const float* vs, const int* handles, const uint8_t* valid, float* m, float* l,
                 float* acc, int G, int B, int C, int H, int S, int P, int ppc, int pt, int KVH,
                 int kv_len, const long long* st, const long long* sst, float scale,
                 cudaStream_t stream) {
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value && tc::tc_head_dim(D)) {
    if (tc::paged_tc_fits(G, P, B, pt, st))
      return tc::launch_paged_tc<TKV, D>(q, k, v, ks, vs, handles, valid, m, l, acc, G, B, C,
                                         H, S, P, ppc, pt, KVH, kv_len, st, sst, scale, stream);
  }
  auto kern = paged_attn_kernel<TQ, TKV, D>;
  const size_t smem = smem_bytes<TKV, D>();
  static bool ready = false;
  cudaError_t err = prepare(kern, smem, ready);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C + BQ - 1) / BQ, H, G * B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), ks,
      vs, handles, valid, m, l, acc, B, C, H, S, ppc, pt, KVH, kv_len, st[0], st[1], st[2],
      st[3], st[4], sst[0], sst[1], sst[2], sst[3], scale);
  return (int)cudaGetLastError();
}

// (q dtype, kv dtype, head dim) -> one instantiation; unknown combos return
// cudaErrorInvalidValue (the Python wrappers refuse them first).
#define DISPATCH_D(FN, TQ, TKV, ...)                                   \
  switch (D) {                                                         \
    case 16: return FN<TQ, TKV, 16>(__VA_ARGS__);                      \
    case 64: return FN<TQ, TKV, 64>(__VA_ARGS__);                      \
    case 80: return FN<TQ, TKV, 80>(__VA_ARGS__);                      \
    case 112: return FN<TQ, TKV, 112>(__VA_ARGS__);                    \
    case 128: return FN<TQ, TKV, 128>(__VA_ARGS__);                    \
    default: return (int)cudaErrorInvalidValue;                        \
  }

// One library per (q dtype, kv dtype) combination: kernels/build.py compiles
// this file once for each KV_COMBO in 0..5, all six nvcc processes at once.
#if !defined(KV_COMBO)
#error "compile with -DKV_COMBO=k, k in 0..5 (see kernels/build.py)"
#elif KV_COMBO == 0
#define COMBO F32, F32, float, float
#elif KV_COMBO == 1
#define COMBO F32, I8, float, int8_t
#elif KV_COMBO == 2
#define COMBO F32, FP8, float, __nv_fp8_e4m3
#elif KV_COMBO == 3
#define COMBO BF16, BF16, __nv_bfloat16, __nv_bfloat16
#elif KV_COMBO == 4
#define COMBO BF16, I8, __nv_bfloat16, int8_t
#elif KV_COMBO == 5
#define COMBO BF16, FP8, __nv_bfloat16, __nv_fp8_e4m3
#else
#error "KV_COMBO must be in 0..5"
#endif

#define DISPATCH_ONE(QC, KC, TQ, TKV, FN, ...) \
  if (q_dtype == QC && kv_dtype == KC) { DISPATCH_D(FN, TQ, TKV, __VA_ARGS__) }
#define APPLY(X, ...) X(__VA_ARGS__)
#define DISPATCH(FN, ...)                          \
  APPLY(DISPATCH_ONE, COMBO, FN, __VA_ARGS__)      \
  return (int)cudaErrorInvalidValue;

}  // namespace

extern "C" {

// K1. Pointers to contiguous tensors; ks/vs null for float K/V; m/l/acc
// null when the state is not wanted. Returns cudaGetLastError().
int chunk_attention_launch(const void* q, const void* k, const void* v, const void* ks,
                           const void* vs, void* out, void* m, void* l, void* acc,
                           int q_dtype, int kv_dtype, int B, int C, int H, int T, int KVH,
                           int D, int causal_offset, int kv_len, float scale, void* stream) {
  DISPATCH(launch_chunk, q, k, v, static_cast<const float*>(ks),
           static_cast<const float*>(vs), out, static_cast<float*>(m),
           static_cast<float*>(l), static_cast<float*>(acc), B, C, H, T, KVH, causal_offset,
           kv_len, scale, static_cast<cudaStream_t>(stream))
}

// K2. valid: [G, S] bool (one byte each); k/v [S, G*B, T, KVH, D]; scales
// [S, G*B, T, KVH].
// The tensor-core body takes G <= 64 groups and G x ceil(S / 32) <= 1024.
int pool_attention_launch(const void* q, const void* k, const void* v, const void* ks,
                          const void* vs, const void* valid, void* m, void* l, void* acc,
                          int q_dtype, int kv_dtype, int G, int B, int C, int H, int S, int T,
                          int KVH, int D, int kv_len, float scale, void* stream) {
  if (S > MAX_SLOTS) return (int)cudaErrorInvalidValue;
  DISPATCH(launch_pool, q, k, v, static_cast<const float*>(ks),
           static_cast<const float*>(vs), static_cast<const uint8_t*>(valid),
           static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(acc), G, B, C,
           H, S, T, KVH, kv_len, scale, static_cast<cudaStream_t>(stream))
}

// K3. Page store k/v [G, P, B, pt, KVH, D] given by 5 element strides
// (group, page, batch, token, head; the head dim is contiguous); scales
// [G, P, B, KVH] by 4 strides; handles [S*ppc] int32 and valid [G, S] bool.
// bf16 q at D 64 / 80 / 112 / 128 runs the tensor-core body when tc::paged_tc_fits
// (pages that fill whole 64-key tiles, strides one 5-D map can hold);
// other page shapes run flash_block.
int pool_attention_paged_launch(const void* q, const void* k, const void* v, const void* ks,
                                const void* vs, const void* handles, const void* valid,
                                void* m, void* l, void* acc, int q_dtype, int kv_dtype, int G,
                                int B, int C, int H, int S, int P, int ppc, int pt, int KVH,
                                int D, int kv_len, long long sg, long long sp, long long sb,
                                long long st, long long sh, long long ssg, long long ssp,
                                long long ssb, long long ssh, float scale, void* stream) {
  if (S > MAX_SLOTS) return (int)cudaErrorInvalidValue;
  const long long strides[5] = {sg, sp, sb, st, sh};
  const long long sstrides[4] = {ssg, ssp, ssb, ssh};
  DISPATCH(launch_paged, q, k, v, static_cast<const float*>(ks),
           static_cast<const float*>(vs), static_cast<const int*>(handles),
           static_cast<const uint8_t*>(valid), static_cast<float*>(m), static_cast<float*>(l),
           static_cast<float*>(acc), G, B, C, H, S, P, ppc, pt, KVH, kv_len, strides, sstrides,
           scale, static_cast<cudaStream_t>(stream))
}

}  // extern "C"
