// Fused streaming decode step for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_step/kernel.py::decode_step_pallas
// (pallas_call at :145, body _kernel at :30).  One thread block per
// (flow, kv-head) runs the paper's per-packet program (Alg. 1 lines 12-16):
//   1. write the arriving (k, v) into the SRAM ring at slot count,
//   2. exact exp-kernel readout over ring slots <= count (local layer),
//   3. phi_q^T S and phi_q^T Z against the compressed stream (Eq. 6),
//   4. add the optional static-global partials (Eq. 14) and merge,
//   5. fold-on-full: when count + 1 >= L, S += phi(ring)^T v, Z += sum phi(ring),
//      clear the ring, count <- 0 (Eqs. 9-10).
// S, Z and the ring are updated in place; only what changes is written: the
// ring slot on a plain step, S, Z and the cleared ring on a fold.  The new
// fill levels go to count_out (count_in is read by every head of a flow, so
// it cannot be overwritten while other heads' blocks may still read it).
//
// Bound on this card: bytes.  A plain step reads S (m*dv floats), Z, phi_q,
// q and the valid ring rows, and does ~2*m*dv flops on them: far below the
// fp32 rate's break-even intensity.  The design keeps every input read once
// per block: the valid ring values are staged in shared memory for the
// local readout and the fold, S is read with consecutive threads on
// consecutive columns, and phi_buf is read only by the blocks that fold.
//
// Contract (all float32, contiguous; BH = flows * heads):
//   q (BH,Gq,d) k_t (BH,d) v_t (BH,dv) phi_q (BH,Gq,m) phi_buf (BH,L,m)
//   k_buf (BH,L,d) v_buf (BH,L,dv) S (BH,m,dv) Z (BH,m)
//   count_in, count_out (BH/heads,) int32, 0 <= count < L
//   gnum (BH,Gq,dv) and gden (BH,Gq), or both null
//   out (BH,Gq,dv)
// Requires 256 % dv == 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) decode_step_kernel(
    const float* __restrict__ q, const float* __restrict__ k_t,
    const float* __restrict__ v_t, const float* __restrict__ phi_q,
    const float* __restrict__ phi_buf, float* __restrict__ k_buf,
    float* __restrict__ v_buf, float* __restrict__ S, float* __restrict__ Z,
    const int32_t* __restrict__ count_in, int32_t* __restrict__ count_out,
    const float* __restrict__ gnum, const float* __restrict__ gden,
    float* __restrict__ out, int heads, int Gq, int d, int dv, int m, int L,
    float gamma) {
  extern __shared__ float smem[];
  float* vs = smem;              // (L, dv) ring values, arriving token at slot c
  float* sc = vs + L * dv;       // (L,) local scores of one query
  float* red = sc + L;           // (kThreads,) partial numerators
  float* den_s = red + kThreads; // (1,) denominator of one query

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  const int parts = blockDim.x / dv;
  const int e = t % dv, part = t / dv;

  int c = count_in[b];
  c = c < 0 ? 0 : (c >= L ? L - 1 : c);  // memory safety only; callers keep 0 <= c < L
  const bool full = c + 1 >= L;
  const float inv_sqrt_d = rsqrtf((float)d);

  const float* kt = k_t + (size_t)bh * d;
  const float* vt = v_t + (size_t)bh * dv;
  float* kb = k_buf + (size_t)bh * L * d;
  float* vb = v_buf + (size_t)bh * L * dv;
  float* Sb = S + (size_t)bh * m * dv;
  float* Zb = Z + (size_t)bh * m;

  // 1. the valid ring values, with the arriving token written at slot c
  for (int idx = t; idx < (c + 1) * dv; idx += blockDim.x) {
    const int j = idx / dv;
    vs[idx] = (j == c) ? vt[idx - j * dv] : vb[idx];
  }
  __syncthreads();

  for (int g = 0; g < Gq; ++g) {
    const float* qg = q + ((size_t)bh * Gq + g) * d;
    const float* pq = phi_q + ((size_t)bh * Gq + g) * m;

    // 2. local scores exp(q.k_j / sqrt(d)), one warp per ring slot
    for (int j = warp; j <= c; j += nwarps) {
      const float* kj = (j == c) ? kt : kb + (size_t)j * d;
      float acc = 0.f;
      for (int x = lane; x < d; x += 32) acc += qg[x] * kj[x];
      acc = warp_sum(acc);
      if (lane == 0) sc[j] = expf(acc * inv_sqrt_d);
    }
    __syncthreads();

    // 3. numerator column e: local slots and stream rows split over parts
    float acc = 0.f;
    for (int j = part; j <= c; j += parts) acc += sc[j] * vs[j * dv + e];
    for (int i = part; i < m; i += parts) acc += pq[i] * Sb[(size_t)i * dv + e];
    red[t] = acc;
    if (warp == 0) {
      float dn = 0.f;
      for (int j = lane; j <= c; j += 32) dn += sc[j];
      for (int i = lane; i < m; i += 32) dn += pq[i] * Zb[i];
      dn = warp_sum(dn);
      if (lane == 0) den_s[0] = dn;
    }
    __syncthreads();

    // 4. merge the partials (+ static globals) and normalize
    if (t < dv) {
      float num = 0.f;
      for (int p = 0; p < parts; ++p) num += red[p * dv + t];
      float den = den_s[0];
      if (gnum != nullptr) {
        num += gnum[((size_t)bh * Gq + g) * dv + t];
        den += gden[(size_t)bh * Gq + g];
      }
      out[((size_t)bh * Gq + g) * dv + t] = num / (den + gamma);
    }
    __syncthreads();  // sc, red and den_s are reused; S and the ring are read no more
  }

  if (full) {
    // 5. fold the full ring into (S, Z) and clear it
    const float* pb = phi_buf + (size_t)bh * L * m;
    for (int i = part; i < m; i += parts) {
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc += pb[(size_t)j * m + i] * vs[j * dv + e];
      Sb[(size_t)i * dv + e] += acc;
    }
    for (int i = t; i < m; i += blockDim.x) {
      float z = 0.f;
      for (int j = 0; j < L; ++j) z += pb[(size_t)j * m + i];
      Zb[i] += z;
    }
    for (int idx = t; idx < L * d; idx += blockDim.x) kb[idx] = 0.f;
    for (int idx = t; idx < L * dv; idx += blockDim.x) vb[idx] = 0.f;
  } else {
    for (int x = t; x < d; x += blockDim.x) kb[(size_t)c * d + x] = kt[x];
    for (int x = t; x < dv; x += blockDim.x) vb[(size_t)c * dv + x] = vt[x];
  }
  if (t == 0 && bh % heads == 0) count_out[b] = full ? 0 : c + 1;
}

}  // namespace

extern "C" int decode_step_launch(
    const float* q, const float* k_t, const float* v_t, const float* phi_q,
    const float* phi_buf, float* k_buf, float* v_buf, float* S, float* Z,
    const int32_t* count_in, int32_t* count_out, const float* gnum,
    const float* gden, float* out, int BH, int heads, int Gq, int d, int dv,
    int m, int L, float gamma, void* stream) {
  if (dv <= 0 || kThreads % dv != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)L * dv + L + kThreads + 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_step_kernel<<<BH, kThreads, smem, (cudaStream_t)stream>>>(
      q, k_t, v_t, phi_q, phi_buf, k_buf, v_buf, S, Z, count_in, count_out,
      gnum, gden, out, heads, Gq, d, dv, m, L, gamma);
  return (int)cudaGetLastError();
}
