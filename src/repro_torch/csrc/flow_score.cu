// Streaming-score stage of flow ingest for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flow_ingest/kernel.py::
// flow_ingest_scores_pallas (:53, pallas_call at :209).  Per lane (packet in
// flight): the class head pooled @ W_cls (K outputs) and the anomaly head
// pooled @ w_anom, the TCAM ternary match all_w((sig & mask) == (val & mask))
// over every rule (a loop over M, no cap), hard = any(hit & hard) | sticky,
// s_sym = sum(W * hit), and Eq. 15 cascade fusion into trust.
//
// Bound on this card: bytes, and at the main path's size (256 lanes, d=256,
// 8 classes, one rule) the launch itself: the kernel moves ~0.3 MB, 0.09 us
// at 3.35 TB/s, well below the ~1 us an empty kernel on the same grid takes
// on an H100.  A first design reduced the K class heads, then the anomaly
// head, one after the other (K + 1 dependent shuffle chains, each reading
// cls_w at a stride of K floats), and its rule loop stopped at the first
// mismatching word; it took 6.3 us, a chain of memory round trips.  Now one
// warp per lane (eight lanes per block) makes one pass over d: thread t
// reads pooled[i], anom_w[i] and cls_w row i (two float4, consecutive
// threads on consecutive rows) for i = t, t + 32, ..., and its first rule
// (lane t takes rules t, t + 32, ...) with 16-byte loads, all issued before
// any is used, so the kernel waits for memory once; the K logits, the
// anomaly head and the soft score are reduced over the warp together.
// Shapes other than K = 8, W = 8, d % 32 == 0 up to 256 take generic loops.
//
// Contract (contiguous): pooled (B,d) f32, sig (B,W) int32 bit patterns,
// sticky (B,) bool, cls_w (d,K) f32, cls_b (K,) or null, anom_w (d,) f32,
// anom_b (1,) or null, values/masks (M,W) int32, weights (M,) f32,
// hard (M,) bool, alpha/beta device scalars; outputs logits (B,K),
// s_nn/s_sym/trust (B,) f32 and hard_out (B,) bool.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tcam.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerBlock = kThreads / 32;
constexpr int kKG = 8;  // class logits summed per pass of the generic path

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// s[0..N) summed over the warp, the N reductions interleaved
template <int N>
__device__ __forceinline__ void warp_sum_n(float* s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int c = 0; c < N; ++c) s[c] += __shfl_xor_sync(0xffffffffu, s[c], o);
}

// FAST: K = 8, W = 8, d a multiple of 32 up to 256, M >= 1 and 16-byte
// aligned rows.  Then every load of the lane's first rule, of its pooled
// row and of the head weights is issued before the first is used, so the
// kernel waits for memory once; other shapes take generic loops.
template <bool FAST>
__global__ void __launch_bounds__(kThreads) flow_score_kernel(
    const float* __restrict__ pooled, const int32_t* __restrict__ sig,
    const uint8_t* __restrict__ sticky, const float* __restrict__ cls_w,
    const float* __restrict__ cls_b, const float* __restrict__ anom_w,
    const float* __restrict__ anom_b, const int32_t* __restrict__ values,
    const int32_t* __restrict__ masks, const float* __restrict__ weights,
    const uint8_t* __restrict__ hard, const float* __restrict__ alpha,
    const float* __restrict__ beta, float* __restrict__ logits,
    float* __restrict__ s_nn, float* __restrict__ s_sym,
    float* __restrict__ trust, uint8_t* __restrict__ hard_out, int B, int d,
    int K, int W, int M, int lambda_h) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLanesPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;  // warp-uniform
  const float* x = pooled + (size_t)row * d;
  const int32_t* sg = sig + (size_t)row * W;
  float* lg = logits + (size_t)row * K;
  const float al = alpha[0], be = beta[0];
  const float ab = anom_b != nullptr ? anom_b[0] : 0.f;
  const bool st = sticky[row] != 0;
  bool any_hard = false;
  float soft = 0.f;
  float a;  // the anomaly head

  if constexpr (FAST) {
    constexpr int kIt = 256 / 32;
    const float cb = cls_b != nullptr && lane < kKG ? cls_b[lane] : 0.f;
    // the lane's first rule (rule lane, or a repeat of rule M - 1 that counts for nothing)
    const int r = min(lane, M - 1);
    const int4 s0 = reinterpret_cast<const int4*>(sg)[0], s1 = reinterpret_cast<const int4*>(sg)[1];
    const int4 v0 = reinterpret_cast<const int4*>(values + (size_t)r * 8)[0];
    const int4 v1 = reinterpret_cast<const int4*>(values + (size_t)r * 8)[1];
    const int4 m0 = reinterpret_cast<const int4*>(masks + (size_t)r * 8)[0];
    const int4 m1 = reinterpret_cast<const int4*>(masks + (size_t)r * 8)[1];
    const float wr = weights[r];
    const bool hr = hard[r] != 0;
    float xv[kIt], av[kIt];
    float4 w0[kIt], w1[kIt];
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = lane + 32 * it;
      const bool in = i < d;  // warp-uniform: d is a multiple of 32
      xv[it] = in ? x[i] : 0.f;
      av[it] = in ? anom_w[i] : 0.f;
      w0[it] = in ? reinterpret_cast<const float4*>(cls_w)[2 * i] : make_float4(0.f, 0.f, 0.f, 0.f);
      w1[it] = in ? reinterpret_cast<const float4*>(cls_w)[2 * i + 1]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int32_t miss = ((s0.x ^ v0.x) & m0.x) | ((s0.y ^ v0.y) & m0.y) |
                         ((s0.z ^ v0.z) & m0.z) | ((s0.w ^ v0.w) & m0.w) |
                         ((s1.x ^ v1.x) & m1.x) | ((s1.y ^ v1.y) & m1.y) |
                         ((s1.z ^ v1.z) & m1.z) | ((s1.w ^ v1.w) & m1.w);
    const bool hit = lane < M && miss == 0;
    soft = hit ? wr : 0.f;
    any_hard = hit && hr;
    match_rules(sg, values, masks, weights, hard, W, M, lane + 32, soft, any_hard);
    // K logits, the anomaly head and the soft score summed over the warp together
    float s[kKG + 2] = {};
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      s[0] = fmaf(xv[it], w0[it].x, s[0]); s[1] = fmaf(xv[it], w0[it].y, s[1]);
      s[2] = fmaf(xv[it], w0[it].z, s[2]); s[3] = fmaf(xv[it], w0[it].w, s[3]);
      s[4] = fmaf(xv[it], w1[it].x, s[4]); s[5] = fmaf(xv[it], w1[it].y, s[5]);
      s[6] = fmaf(xv[it], w1[it].z, s[6]); s[7] = fmaf(xv[it], w1[it].w, s[7]);
      s[kKG] = fmaf(xv[it], av[it], s[kKG]);
    }
    s[kKG + 1] = soft;
    warp_sum_n<kKG + 2>(s);
    if (lane < kKG) {
      float y = s[0];
#pragma unroll
      for (int c = 1; c < kKG; ++c) y = lane == c ? s[c] : y;
      lg[lane] = y + cb;
    }
    a = s[kKG];
    soft = s[kKG + 1];
  } else {
    // any K: groups of kKG logits per pass over d, the anomaly head with the
    // first (which runs for K = 0 too)
    match_rules(sg, values, masks, weights, hard, W, M, lane, soft, any_hard);
    a = 0.f;
    for (int k0 = 0; k0 == 0 || k0 < K; k0 += kKG) {
      float s[kKG + 1] = {};
      for (int i = lane; i < d; i += 32) {
        const float xi = x[i];
#pragma unroll
        for (int c = 0; c < kKG; ++c)
          if (k0 + c < K) s[c] = fmaf(xi, cls_w[(size_t)i * K + k0 + c], s[c]);
        if (k0 == 0) s[kKG] = fmaf(xi, anom_w[i], s[kKG]);
      }
      warp_sum_n<kKG + 1>(s);
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kKG; ++c)
          if (k0 + c < K) lg[k0 + c] = cls_b ? s[c] + cls_b[k0 + c] : s[c];
      }
      if (k0 == 0) a = s[kKG];
    }
    soft = warp_sum(soft);
  }
  a += ab;
  any_hard = __any_sync(0xffffffffu, any_hard);

  if (lane == 0) {
    const bool h = any_hard || st;
    const float z = al * a + be * soft;
    const float soft_trust = 1.f / (1.f + expf(-z));
    s_nn[row] = a;
    s_sym[row] = soft;
    hard_out[row] = h ? 1 : 0;
    trust[row] = (lambda_h && h) ? 1.f : soft_trust;
  }
}

}  // namespace

extern "C" int flow_score_launch(
    const float* pooled, const int32_t* sig, const uint8_t* sticky,
    const float* cls_w, const float* cls_b, const float* anom_w,
    const float* anom_b, const int32_t* values, const int32_t* masks,
    const float* weights, const uint8_t* hard, const float* alpha,
    const float* beta, float* logits, float* s_nn, float* s_sym, float* trust,
    uint8_t* hard_out, int B, int d, int K, int W, int M, int lambda_h,
    void* stream) {
  const int blocks = (B + kLanesPerBlock - 1) / kLanesPerBlock;
  if (blocks == 0) return (int)cudaSuccess;
  const bool fast = K == kKG && W == 8 && d % 32 == 0 && d <= 256 && M >= 1 &&
                    (((uintptr_t)cls_w | (uintptr_t)sig | (uintptr_t)values |
                      (uintptr_t)masks) & 15) == 0;
  auto kernel = fast ? flow_score_kernel<true> : flow_score_kernel<false>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      pooled, sig, sticky, cls_w, cls_b, anom_w, anom_b, values, masks,
      weights, hard, alpha, beta, logits, s_nn, s_sym, trust, hard_out, B, d,
      K, W, M, lambda_h);
  return (int)cudaGetLastError();
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// An empty kernel on flow_score's grid: its device time is the launch floor
// that flow_score's own time is read against.
extern "C" int empty_launch(int B, void* stream) {
  const int blocks = (B + kLanesPerBlock - 1) / kLanesPerBlock;
  if (blocks == 0) return (int)cudaSuccess;
  empty_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
