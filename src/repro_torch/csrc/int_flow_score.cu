// Integer score stage of flow ingest (the int-emulation backend) for
// Hopper (sm_90a).
//
// Replaces repro/compile/int_lowering.py::int_flow_score (:367), which the
// JAX package computes in jnp int32 (no pallas_call; XLA lowers its int32
// dot).  Per lane (packet in flight), over the lowered tables of an
// IntScorePlan: the floor-division pooling pooled = hidden_sum // max(count,
// 1), the class head pooled @ cls_w (+ cls_b) and the anomaly head pooled @
// anom_w (+ anom_b) as int32 MACs, the rounding shift (x + 2^(k-1)) >> k of
// the anomaly score, the TCAM ternary match with the sticky hard veto and
// the rule-weight sum (shifted the same way), the Eq. 15 fusion u = (alpha *
// s_nn + beta * s_sym) >> f_ab, the sigmoid LUT index ((u - u_min) >> shift,
// clamped) and the pin trust_q = one_q on a veto.
//
// Bit-exact with int32 two's-complement arithmetic, as XLA computes it:
// every add and multiply runs on uint32 (well defined modulo 2^32, so the
// warp's sums give the same bits in any order), and only the shifts and
// compares read the bits as int32.  No signed overflow is relied upon.
//
// Bound on this card: at the main path's shapes (256 lanes, d 256, 8
// classes, 24 signature words, 1 rule) the kernel moves ~0.3 MB, 0.1 us at
// 3.35 TB/s, below the ~1 us an empty kernel on the same grid takes: the
// launch bounds it.  So the design is flow_score.cu's generic path, simple
// and right: one warp per lane (eight lanes per block), one pass over d per
// group of 8 class logits with the anomaly head in the first, the rules
// split over the warp's threads (tcam.cuh), warp-shuffle sums.
//
// Contract (contiguous): hidden_sum (B,d) int32, count (B,) int32, sig (B,W)
// int32 bit patterns, sticky (B,) bool, cls_w (d,K) int32, cls_b (K,) or
// null, anom_w (d,) int32, anom_b (1,) or null, values/masks (M,W) int32,
// rule_w (M,) int32, hard (M,) bool, alpha/beta device int32 scalars, lut
// (n_lut,) int32; outputs logits (B,K), s_nn_q/s_sym_q/trust_q (B,) int32
// and hard_out (B,) bool.  Shifts 0..31, |lut_shift| < 32, n_lut >= 1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tcam.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerBlock = kThreads / 32;
constexpr int kKG = 8;  // class logits summed per pass over d

template <int N>
__device__ __forceinline__ void warp_sum_n(uint32_t* s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int c = 0; c < N; ++c) s[c] += __shfl_xor_sync(0xffffffffu, s[c], o);
}

// floor(a / b) for b > 0 (C++ division truncates toward zero)
__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// (x + (1 << (k-1))) >> k on int32 bits, the add wrapping; k = 0 is the identity
__device__ __forceinline__ int32_t rshift_round(uint32_t x, int k) {
  if (k == 0) return (int32_t)x;
  return (int32_t)(x + (1u << (k - 1))) >> k;
}

__global__ void __launch_bounds__(kThreads) int_flow_score_kernel(
    const int32_t* __restrict__ hidden_sum, const int32_t* __restrict__ count,
    const int32_t* __restrict__ sig, const uint8_t* __restrict__ sticky,
    const int32_t* __restrict__ cls_w, const int32_t* __restrict__ cls_b,
    const int32_t* __restrict__ anom_w, const int32_t* __restrict__ anom_b,
    const int32_t* __restrict__ values, const int32_t* __restrict__ masks,
    const int32_t* __restrict__ rule_w, const uint8_t* __restrict__ hard,
    const int32_t* __restrict__ alpha, const int32_t* __restrict__ beta,
    const int32_t* __restrict__ lut, int32_t* __restrict__ logits,
    int32_t* __restrict__ s_nn_q, int32_t* __restrict__ s_sym_q, int32_t* __restrict__ trust_q,
    uint8_t* __restrict__ hard_out, int B, int d, int K, int W, int M, int nn_shift,
    int sym_shift, int fusion_frac, int u_min_q, int lut_shift, int n_lut, int one_q) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLanesPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;  // warp-uniform
  const int32_t* x = hidden_sum + (size_t)row * d;
  const int32_t* sg = sig + (size_t)row * W;
  int32_t* lg = logits + (size_t)row * K;
  const int32_t c = max(count[row], 1);

  uint32_t sym = 0;
  bool any_hard = false;
  match_rules(sg, values, masks, rule_w, hard, W, M, lane, sym, any_hard);

  uint32_t a = 0;  // the anomaly head's MACs
  for (int k0 = 0; k0 == 0 || k0 < K; k0 += kKG) {
    uint32_t s[kKG + 1] = {};
    for (int i = lane; i < d; i += 32) {
      const uint32_t p = (uint32_t)floor_div(x[i], c);
#pragma unroll
      for (int j = 0; j < kKG; ++j)
        if (k0 + j < K) s[j] += p * (uint32_t)cls_w[(size_t)i * K + k0 + j];
      if (k0 == 0) s[kKG] += p * (uint32_t)anom_w[i];
    }
    warp_sum_n<kKG + 1>(s);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kKG; ++j)
        if (k0 + j < K) lg[k0 + j] = (int32_t)(cls_b ? s[j] + (uint32_t)cls_b[k0 + j] : s[j]);
    }
    if (k0 == 0) a = s[kKG];
  }
  warp_sum_n<1>(&sym);
  any_hard = __any_sync(0xffffffffu, any_hard);

  if (lane == 0) {
    const int32_t snn = rshift_round(a + (anom_b ? (uint32_t)anom_b[0] : 0u), nn_shift);
    const int32_t ssym = rshift_round(sym, sym_shift);
    const uint32_t u_acc = (uint32_t)alpha[0] * (uint32_t)snn + (uint32_t)beta[0] * (uint32_t)ssym;
    const int32_t off = (int32_t)((uint32_t)rshift_round(u_acc, fusion_frac) - (uint32_t)u_min_q);
    int32_t idx = lut_shift >= 0 ? off >> lut_shift : (int32_t)((uint32_t)off << -lut_shift);
    idx = min(max(idx, 0), n_lut - 1);
    const bool h = any_hard || sticky[row] != 0;
    s_nn_q[row] = snn;
    s_sym_q[row] = ssym;
    hard_out[row] = h ? 1 : 0;
    trust_q[row] = h ? one_q : lut[idx];
  }
}

}  // namespace

extern "C" int int_flow_score_launch(
    const int32_t* hidden_sum, const int32_t* count, const int32_t* sig, const uint8_t* sticky,
    const int32_t* cls_w, const int32_t* cls_b, const int32_t* anom_w, const int32_t* anom_b,
    const int32_t* values, const int32_t* masks, const int32_t* rule_w, const uint8_t* hard,
    const int32_t* alpha, const int32_t* beta, const int32_t* lut, int32_t* logits,
    int32_t* s_nn_q, int32_t* s_sym_q, int32_t* trust_q, uint8_t* hard_out, int B, int d, int K,
    int W, int M, int nn_shift, int sym_shift, int fusion_frac, int u_min_q, int lut_shift,
    int n_lut, int one_q, void* stream) {
  const bool shifts_ok = nn_shift >= 0 && nn_shift < 32 && sym_shift >= 0 && sym_shift < 32 &&
                         fusion_frac >= 0 && fusion_frac < 32 && lut_shift > -32 &&
                         lut_shift < 32;
  if (d <= 0 || W <= 0 || K < 0 || M < 0 || n_lut <= 0 || !shifts_ok)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + kLanesPerBlock - 1) / kLanesPerBlock;
  if (blocks == 0) return (int)cudaSuccess;
  int_flow_score_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      hidden_sum, count, sig, sticky, cls_w, cls_b, anom_w, anom_b, values, masks, rule_w, hard,
      alpha, beta, lut, logits, s_nn_q, s_sym_q, trust_q, hard_out, B, d, K, W, M, nn_shift,
      sym_shift, fusion_frac, u_min_q, lut_shift, n_lut, one_q);
  return (int)cudaGetLastError();
}
