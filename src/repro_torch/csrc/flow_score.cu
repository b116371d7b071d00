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
// 8 classes, one rule) the launch itself: the kernel moves ~0.3 MB.  One warp
// per lane, eight lanes per block: the warp reads the lane's pooled row once
// (consecutive threads on consecutive features), reduces each head with
// shuffles, and spreads the rules over its 32 threads; the rule tables are
// shared by every block and stay in L1/L2.
//
// Contract (contiguous): pooled (B,d) f32, sig (B,W) int32 bit patterns,
// sticky (B,) bool, cls_w (d,K) f32, cls_b (K,) or null, anom_w (d,) f32,
// anom_b (1,) or null, values/masks (M,W) int32, weights (M,) f32,
// hard (M,) bool, alpha/beta device scalars; outputs logits (B,K),
// s_nn/s_sym/trust (B,) f32 and hard_out (B,) bool.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerBlock = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

  // class head and anomaly head (GEMVs over d)
  for (int k = 0; k < K; ++k) {
    float acc = 0.f;
    for (int i = lane; i < d; i += 32) acc += x[i] * cls_w[(size_t)i * K + k];
    acc = warp_sum(acc);
    if (lane == 0) logits[(size_t)row * K + k] = cls_b ? acc + cls_b[k] : acc;
  }
  float a = 0.f;
  for (int i = lane; i < d; i += 32) a += x[i] * anom_w[i];
  a = warp_sum(a);
  if (anom_b != nullptr) a += anom_b[0];

  // TCAM ternary match, rules spread over the warp
  const int32_t* sg = sig + (size_t)row * W;
  bool any_hard = false;
  float soft = 0.f;
  for (int r = lane; r < M; r += 32) {
    bool hit = true;
    for (int w = 0; w < W; ++w) {
      const int32_t mk = masks[(size_t)r * W + w];
      hit = hit && ((sg[w] & mk) == (values[(size_t)r * W + w] & mk));
    }
    if (hit) {
      soft += weights[r];
      any_hard = any_hard || (hard[r] != 0);
    }
  }
  soft = warp_sum(soft);
  any_hard = __any_sync(0xffffffffu, any_hard);

  if (lane == 0) {
    const bool h = any_hard || (sticky[row] != 0);
    const float z = alpha[0] * a + beta[0] * soft;
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
  flow_score_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      pooled, sig, sticky, cls_w, cls_b, anom_w, anom_b, values, masks,
      weights, hard, alpha, beta, logits, s_nn, s_sym, trust, hard_out, B, d,
      K, W, M, lambda_h);
  return (int)cudaGetLastError();
}
