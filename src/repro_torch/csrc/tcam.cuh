// TCAM ternary match over packed 32-bit signature words, shared by the
// float (flow_score.cu) and integer (int_flow_score.cu) score stages.
//
// A rule hits when (sig & mask) == (value & mask) on every word, i.e. when
// OR_w((sig[w] ^ value[w]) & mask[w]) is zero.  Lane t of a warp takes
// rules r, r + 32, ... < M (r = t for the whole loop); each hit adds the
// rule's weight to `acc` (float for the float stage; uint32 for the integer
// stage, whose sums wrap as two's-complement int32 does) and a hard rule
// sets `any_hard`.  The caller reduces both over the warp.

#pragma once

#include <stdint.h>

namespace {

template <typename Acc, typename Wt>
__device__ __forceinline__ void match_rules(const int32_t* sg, const int32_t* __restrict__ values,
                                            const int32_t* __restrict__ masks,
                                            const Wt* __restrict__ weights,
                                            const uint8_t* __restrict__ hard, int W, int M, int r,
                                            Acc& acc, bool& any_hard) {
  for (; r < M; r += 32) {
    const Wt wr = weights[r];
    const bool hr = hard[r] != 0;
    int32_t miss = 0;
#pragma unroll 8
    for (int w = 0; w < W; ++w)
      miss |= (sg[w] ^ values[(size_t)r * W + w]) & masks[(size_t)r * W + w];
    acc += miss == 0 ? (Acc)wr : (Acc)0;
    any_hard |= miss == 0 && hr;
  }
}

}  // namespace
