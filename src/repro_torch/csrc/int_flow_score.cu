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
// 3.35 TB/s, below the ~1 us an empty kernel takes: the launch and the
// latency of its memory round trips bound it.  A first design (flow_score's
// old generic loops, eight lanes a block, 32 blocks) took 8.3 us: it read
// count, then the rule, then cls_w at a stride of K ints inside a loop of
// runtime trip count, then alpha/beta/anom_b/sticky, then the LUT, each
// load waiting on the one before, and divided with a signed '/' and '%' per
// element.  Now, on the FAST path (K 8, W 24 or 8, d a multiple of 32 up
// to 256, M >= 1, 16-byte aligned rows), every load of a lane is issued before
// any is used: its hidden-sum row, count, sticky, alpha, beta, anom_b,
// cls_b, cls_w rows as two 16-byte loads, anom_w, the signature and the
// lane's first rule as W / 4 16-byte loads each; the LUT is copied to shared
// memory by cp.async meanwhile (n_lut <= 1024), so the kernel waits for
// device memory once.  The floor division is a Granlund-Montgomery magic
// multiply (__umulhi) with the lane's divisor prepared once, exact over the
// whole int32 range.  Two lanes a block (128 blocks for 256 lanes) spread
// the grid over the SMs.  Other shapes take the generic loops.
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

constexpr int kLanesPerBlock = 2;
constexpr int kThreads = 32 * kLanesPerBlock;
constexpr int kKG = 8;         // class logits summed per pass over d (the fast path's K)
constexpr int kDMax = 256;     // the fast path's largest d
constexpr int kLutSmem = 1024;  // LUT entries staged in shared memory

template <int N>
__device__ __forceinline__ void warp_sum_n(uint32_t* s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int c = 0; c < N; ++c) s[c] += __shfl_xor_sync(0xffffffffu, s[c], o);
}

// Unsigned division by a divisor c >= 1 fixed for the lane (Granlund and
// Montgomery, "Division by invariant integers using multiplication", 1994,
// Fig. 4.1): with l = ceil(log2 c) and m = floor(2^32 (2^l - c) / c) + 1,
// n / c = (t + ((n - t) >> min(l, 1))) >> max(l - 1, 0), t = umulhi(m, n),
// exact for every 32-bit n.
struct Divider {
  uint32_t m;
  int s1, s2;
  __device__ __forceinline__ explicit Divider(uint32_t c) {
    const int l = 32 - __clz(c - 1);  // c = 1: __clz(0) = 32, l = 0
    m = (uint32_t)(((((uint64_t)1 << l) - c) << 32) / c) + 1u;
    s1 = min(l, 1);
    s2 = max(l - 1, 0);
  }
  __device__ __forceinline__ uint32_t udiv(uint32_t n) const {
    const uint32_t t = __umulhi(m, n);
    return (t + ((n - t) >> s1)) >> s2;
  }
  // floor(a / c): for a < 0, floor(a / c) = ~(~a / c), and ~a = -a - 1 >= 0
  __device__ __forceinline__ int32_t floor_div(int32_t a) const {
    const uint32_t s = (uint32_t)(a >> 31);
    return (int32_t)(udiv((uint32_t)a ^ s) ^ s);
  }
};

// (x + (1 << (k-1))) >> k on int32 bits, the add wrapping; k = 0 is the identity
__device__ __forceinline__ int32_t rshift_round(uint32_t x, int k) {
  if (k == 0) return (int32_t)x;
  return (int32_t)(x + (1u << (k - 1))) >> k;
}

__device__ __forceinline__ int32_t miss4(int4 s, int4 v, int4 m) {
  return ((s.x ^ v.x) & m.x) | ((s.y ^ v.y) & m.y) | ((s.z ^ v.z) & m.z) | ((s.w ^ v.w) & m.w);
}

// the W words of rule r against the signature held in registers
template <int W>
__device__ __forceinline__ int32_t rule_miss(const int4 (&sg)[W / 4],
                                             const int32_t* __restrict__ values,
                                             const int32_t* __restrict__ masks, int r) {
  const int4* v = reinterpret_cast<const int4*>(values + (size_t)r * W);
  const int4* m = reinterpret_cast<const int4*>(masks + (size_t)r * W);
  int4 vv[W / 4], mm[W / 4];
#pragma unroll
  for (int j = 0; j < W / 4; ++j) {
    vv[j] = v[j];
    mm[j] = m[j];
  }
  int32_t miss = 0;
#pragma unroll
  for (int j = 0; j < W / 4; ++j) miss |= miss4(sg[j], vv[j], mm[j]);
  return miss;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

struct Args {
  const int32_t* __restrict__ hidden_sum;
  const int32_t* __restrict__ count;
  const int32_t* __restrict__ sig;
  const uint8_t* __restrict__ sticky;
  const int32_t* __restrict__ cls_w;
  const int32_t* __restrict__ cls_b;
  const int32_t* __restrict__ anom_w;
  const int32_t* __restrict__ anom_b;
  const int32_t* __restrict__ values;
  const int32_t* __restrict__ masks;
  const int32_t* __restrict__ rule_w;
  const uint8_t* __restrict__ hard;
  const int32_t* __restrict__ alpha;
  const int32_t* __restrict__ beta;
  const int32_t* __restrict__ lut;
  int32_t* __restrict__ logits;
  int32_t* __restrict__ s_nn_q;
  int32_t* __restrict__ s_sym_q;
  int32_t* __restrict__ trust_q;
  uint8_t* __restrict__ hard_out;
  int B, d, K, W, M, nn_shift, sym_shift, fusion_frac, u_min_q, lut_shift, n_lut, one_q;
};

// the fusion, the LUT and the veto pin, on the lane's reduced sums
__device__ __forceinline__ void finish(const Args& a, int row, uint32_t nn_acc, uint32_t sym,
                                       bool h, uint32_t al, uint32_t be, const int32_t* lut) {
  const int32_t snn = rshift_round(nn_acc, a.nn_shift);
  const int32_t ssym = rshift_round(sym, a.sym_shift);
  const uint32_t u_acc = al * (uint32_t)snn + be * (uint32_t)ssym;
  const int32_t off = (int32_t)((uint32_t)rshift_round(u_acc, a.fusion_frac) - (uint32_t)a.u_min_q);
  int32_t idx = a.lut_shift >= 0 ? off >> a.lut_shift : (int32_t)((uint32_t)off << -a.lut_shift);
  idx = min(max(idx, 0), a.n_lut - 1);
  a.s_nn_q[row] = snn;
  a.s_sym_q[row] = ssym;
  a.hard_out[row] = h ? 1 : 0;
  a.trust_q[row] = h ? a.one_q : lut[idx];
}

// W: the compiled layout's 24 signature words, or 8 (a narrower marker alphabet)
template <int W>
__global__ void __launch_bounds__(kThreads) int_flow_score_fast_kernel(Args a, bool stage_lut) {
  __shared__ __align__(16) int32_t lut_s[kLutSmem];
  const int lane = threadIdx.x & 31;
  const int want = blockIdx.x * kLanesPerBlock + (threadIdx.x >> 5);
  const bool valid = want < a.B;
  const int row = valid ? want : a.B - 1;  // every warp reaches the barrier below
  constexpr int kIt = kDMax / 32;

  // the LUT into shared memory, 16 bytes a copy, while the loads below are in flight
  if (stage_lut) {
    for (int j = 4 * threadIdx.x; j < a.n_lut; j += 4 * kThreads) cp_async4(lut_s + j, a.lut + j);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // every load before the first use
  const int32_t* x = a.hidden_sum + (size_t)row * a.d;
  const int4* sg4 = reinterpret_cast<const int4*>(a.sig + (size_t)row * W);
  const int r = min(lane, a.M - 1);  // the lane's first rule (a repeat of M - 1 counts nothing)
  const int32_t cnt = a.count[row];
  const bool st = a.sticky[row] != 0;
  const uint32_t al = (uint32_t)a.alpha[0], be = (uint32_t)a.beta[0];
  const uint32_t ab = a.anom_b != nullptr ? (uint32_t)a.anom_b[0] : 0u;
  const uint32_t cb = a.cls_b != nullptr && lane < kKG ? (uint32_t)a.cls_b[lane] : 0u;
  const uint32_t wr = (uint32_t)a.rule_w[r];
  const bool hr = a.hard[r] != 0;
  int4 sg[W / 4];
#pragma unroll
  for (int j = 0; j < W / 4; ++j) sg[j] = sg4[j];
  int32_t xv[kIt], av[kIt];
  int4 w0[kIt], w1[kIt];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int i = lane + 32 * it;
    const bool in = i < a.d;  // warp-uniform: d is a multiple of 32
    xv[it] = in ? x[i] : 0;
    av[it] = in ? a.anom_w[i] : 0;
    w0[it] = in ? reinterpret_cast<const int4*>(a.cls_w)[2 * i] : make_int4(0, 0, 0, 0);
    w1[it] = in ? reinterpret_cast<const int4*>(a.cls_w)[2 * i + 1] : make_int4(0, 0, 0, 0);
  }
  const int32_t miss0 = rule_miss<W>(sg, a.values, a.masks, r);

  const Divider div((uint32_t)max(cnt, 1));
  uint32_t s[kKG + 2] = {};
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const uint32_t p = (uint32_t)div.floor_div(xv[it]);
    s[0] += p * (uint32_t)w0[it].x; s[1] += p * (uint32_t)w0[it].y;
    s[2] += p * (uint32_t)w0[it].z; s[3] += p * (uint32_t)w0[it].w;
    s[4] += p * (uint32_t)w1[it].x; s[5] += p * (uint32_t)w1[it].y;
    s[6] += p * (uint32_t)w1[it].z; s[7] += p * (uint32_t)w1[it].w;
    s[kKG] += p * (uint32_t)av[it];
  }
  const bool hit0 = lane < a.M && miss0 == 0;
  uint32_t sym = hit0 ? wr : 0u;
  bool any_hard = hit0 && hr;
  for (int q = lane + 32; q < a.M; q += 32) {  // rules past the first 32
    const uint32_t wq = (uint32_t)a.rule_w[q];
    const bool hq = a.hard[q] != 0;
    const bool hit = rule_miss<W>(sg, a.values, a.masks, q) == 0;
    sym += hit ? wq : 0u;
    any_hard |= hit && hq;
  }
  s[kKG + 1] = sym;
  warp_sum_n<kKG + 2>(s);
  any_hard = __any_sync(0xffffffffu, any_hard);
  if (valid && lane < kKG) {
    uint32_t y = s[0];
#pragma unroll
    for (int c = 1; c < kKG; ++c) y = lane == c ? s[c] : y;
    a.logits[(size_t)row * kKG + lane] = (int32_t)(y + cb);
  }
  if (stage_lut) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
  if (valid && lane == 0)
    finish(a, row, s[kKG] + ab, s[kKG + 1], any_hard || st, al, be, stage_lut ? lut_s : a.lut);
}

// any widths: groups of kKG logits per pass over d, the anomaly head with
// the first (which runs for K = 0 too), the rules through tcam.cuh
__global__ void __launch_bounds__(kThreads) int_flow_score_generic_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLanesPerBlock + (threadIdx.x >> 5);
  if (row >= a.B) return;  // warp-uniform
  const int32_t* x = a.hidden_sum + (size_t)row * a.d;
  const int32_t* sg = a.sig + (size_t)row * a.W;
  int32_t* lg = a.logits + (size_t)row * a.K;
  const Divider div((uint32_t)max(a.count[row], 1));

  uint32_t sym = 0;
  bool any_hard = false;
  match_rules(sg, a.values, a.masks, a.rule_w, a.hard, a.W, a.M, lane, sym, any_hard);

  uint32_t nn = 0;  // the anomaly head's MACs
  for (int k0 = 0; k0 == 0 || k0 < a.K; k0 += kKG) {
    uint32_t s[kKG + 1] = {};
    for (int i = lane; i < a.d; i += 32) {
      const uint32_t p = (uint32_t)div.floor_div(x[i]);
#pragma unroll
      for (int j = 0; j < kKG; ++j)
        if (k0 + j < a.K) s[j] += p * (uint32_t)a.cls_w[(size_t)i * a.K + k0 + j];
      if (k0 == 0) s[kKG] += p * (uint32_t)a.anom_w[i];
    }
    warp_sum_n<kKG + 1>(s);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kKG; ++j)
        if (k0 + j < a.K) lg[k0 + j] = (int32_t)(a.cls_b ? s[j] + (uint32_t)a.cls_b[k0 + j] : s[j]);
    }
    if (k0 == 0) nn = s[kKG];
  }
  warp_sum_n<1>(&sym);
  any_hard = __any_sync(0xffffffffu, any_hard);

  if (lane == 0) {
    const uint32_t ab = a.anom_b ? (uint32_t)a.anom_b[0] : 0u;
    finish(a, row, nn + ab, sym, any_hard || a.sticky[row] != 0, (uint32_t)a.alpha[0],
           (uint32_t)a.beta[0], a.lut);
  }
}

}  // namespace

// 1 if the launcher takes the fast path for these widths and pointers, 0
// if it takes the generic one
extern "C" int int_flow_score_fast_path(const int32_t* cls_w, const int32_t* sig,
                                        const int32_t* values, const int32_t* masks, int d, int K,
                                        int W, int M) {
  return K == kKG && (W == 8 || W == 24) && d % 32 == 0 && d <= kDMax && M >= 1 &&
         (((uintptr_t)cls_w | (uintptr_t)sig | (uintptr_t)values | (uintptr_t)masks) & 15) == 0;
}

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
  const Args a{hidden_sum, count, sig, sticky, cls_w, cls_b, anom_w, anom_b, values, masks,
               rule_w, hard, alpha, beta, lut, logits, s_nn_q, s_sym_q, trust_q, hard_out,
               B, d, K, W, M, nn_shift, sym_shift, fusion_frac, u_min_q, lut_shift, n_lut,
               one_q};
  if (int_flow_score_fast_path(cls_w, sig, values, masks, d, K, W, M)) {
    const bool stage_lut = n_lut <= kLutSmem && n_lut % 4 == 0 && ((uintptr_t)lut & 15) == 0;
    auto kernel = W == 24 ? int_flow_score_fast_kernel<24> : int_flow_score_fast_kernel<8>;
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a, stage_lut);
  } else {
    int_flow_score_generic_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
