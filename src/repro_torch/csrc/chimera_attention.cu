// Chunked Chimera attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/chimera_attention/kernel.py::chimera_attention_pallas
// (pallas_call at :146, body _kernel at :36).  For one (batch x kv-head) row
// the chunks of L tokens run in order, with the stream state (S (m, dv),
// Z (m)) carried across them (Eqs. 9-10).  Per chunk:
//   1. exact causal exp attention inside the chunk: exp(q.k / sqrt(d)) for
//      j <= i, summed into num and den (the SRAM local layer),
//   2. the stream readout phi_q.S and phi_q.Z against the state before the
//      chunk (Eq. 6), skipped for chunk 0 whose state is zero,
//   3. the fold S += phi_k^T v, Z += sum_j phi_k, skipped after the last
//      chunk, whose state nobody reads.
// It returns the unnormalized num and den; the static-global partials and
// the division are the caller's.
//
// Design.  The TPU grid walks (row, chunk) in order with (S, Z) in VMEM
// scratch; here one thread block owns one row and one 32-column slice of
// dv and walks the chunks itself, so the sequential axis becomes a loop
// inside the block and nothing carries across blocks.  The block keeps its
// S slice (m x 32) and Z in shared memory for the whole row; q, k, the v
// slice and the local scores of one chunk are staged in shared memory, and
// the feature-map rows (phi_q and phi_k, m wide) are streamed through one
// L x 64 tile, so the shared memory of a block is
//   4 * (33 m + 2 L (d + 1) + 32 L + L (L + 1) + 65 L) bytes
// (108,544 B at the paper's m 256, L 64, d 64: two blocks per SM).  Every
// product is computed by 16 x 16 threads, each holding a small register
// tile; rows of k, q, the scores and the feature tile are padded by one
// float so the threads of a warp hit distinct banks.  The slices of a row
// are neighbouring blocks, so the k, q and phi reads they repeat come from
// L2.  Only slice 0 computes and writes den (and keeps Z).
//
// Bound on an H100 at the paper's training shapes: operations and bytes
// are of one size (~0.23 ms of fp32 FLOPs against ~0.20 ms of HBM traffic
// for BH 1024, T 256), so the design reads every input once from device
// memory and keeps every product on CUDA cores out of shared memory.  Its
// inner loops issue about six 4-byte shared-memory loads per eight FMAs,
// the likely limit (1.52 ms measured on an H100 at 700 W).  Tensor cores
// (TF32 would change the numbers), TMA and a pipelined tile ring are later
// work.
//
// Contract (all float32, contiguous; BH = batch * kv-heads):
//   q (BH,Gq,T,d) k (BH,T,d) v (BH,T,dv) phi_q (BH,Gq,T,m) phi_k (BH,T,m)
//   num (BH,Gq,T,dv) den (BH,Gq,T), written in full
// Requires L in {16, 32, 64, 128}, T % L == 0, dv % 32 == 0, m % 64 == 0,
// and the shared memory above within the 227 KB a block may use.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kDvs = 32;       // dv columns per block
constexpr int kMt = 64;        // feature-map columns per streamed tile

template <int L>
__global__ void __launch_bounds__(kThreads) chimera_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ phi_q,
    const float* __restrict__ phi_k, float* __restrict__ num,
    float* __restrict__ den, int Gq, int T, int d, int dv, int m,
    float scale, int use_local, int use_stream) {
  constexpr int TM = L / 16;  // rows of an L-row product per thread
  constexpr int FP = kMt + 1;
  constexpr int PP = L + 1;
  extern __shared__ float smem[];
  const int n_slices = dv / kDvs;
  const int bh = blockIdx.x / n_slices;
  const int slice = blockIdx.x % n_slices;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int dp = d + 1;
  const bool lead = slice == 0;  // writes den, keeps Z

  float* S_s = smem;            // (m, kDvs) stream state, this slice
  float* Z_s = S_s + m * kDvs;  // (m,)
  float* k_s = Z_s + m;         // (L, d+1)
  float* q_s = k_s + L * dp;    // (L, d+1) one query group
  float* v_s = q_s + L * dp;    // (L, kDvs)
  float* p_s = v_s + L * kDvs;  // (L, L+1) local scores
  float* f_s = p_s + L * PP;    // (L, kMt+1) feature-map tile

  for (int x = t; x < m * kDvs; x += kThreads) S_s[x] = 0.f;
  for (int x = t; x < m; x += kThreads) Z_s[x] = 0.f;

  const float* kb = k + (size_t)bh * T * d;
  const float* vb = v + (size_t)bh * T * dv + slice * kDvs;
  const float* pkb = phi_k + (size_t)bh * T * m;
  const int n_chunks = T / L;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    // the previous chunk's readers of k_s and v_s passed a barrier at the
    // end of the group loop or of the fold
    if (use_local) {
      for (int x = t; x < L * d; x += kThreads) {
        const int i = x / d, e = x - i * d;
        k_s[i * dp + e] = kb[(size_t)(t0 + i) * d + e];
      }
    }
    for (int x = t; x < L * kDvs; x += kThreads) {
      const int j = x / kDvs, e = x - j * kDvs;
      v_s[x] = vb[(size_t)(t0 + j) * dv + e];
    }
    __syncthreads();
    const bool readout = use_stream && c > 0;

    for (int g = 0; g < Gq; ++g) {
      const size_t row0 = ((size_t)bh * Gq + g) * T + t0;  // first query row
      float acc[TM][2];
#pragma unroll
      for (int u = 0; u < TM; ++u) acc[u][0] = acc[u][1] = 0.f;
      float dn = 0.f;

      if (use_local) {
        for (int x = t; x < L * d; x += kThreads) {
          const int i = x / d, e = x - i * d;
          q_s[i * dp + e] = q[(row0 + i) * d + e];
        }
        __syncthreads();
        // 1a. scores of rows ty+16u against keys tx+16w
        float sc[TM][TM];
#pragma unroll
        for (int u = 0; u < TM; ++u)
#pragma unroll
          for (int w = 0; w < TM; ++w) sc[u][w] = 0.f;
        for (int x = 0; x < d; ++x) {
          float a[TM], b[TM];
#pragma unroll
          for (int u = 0; u < TM; ++u) {
            a[u] = q_s[(ty + 16 * u) * dp + x];
            b[u] = k_s[(tx + 16 * u) * dp + x];
          }
#pragma unroll
          for (int u = 0; u < TM; ++u)
#pragma unroll
            for (int w = 0; w < TM; ++w) sc[u][w] = fmaf(a[u], b[w], sc[u][w]);
        }
#pragma unroll
        for (int u = 0; u < TM; ++u)
#pragma unroll
          for (int w = 0; w < TM; ++w) {
            const int i = ty + 16 * u, j = tx + 16 * w;
            p_s[i * PP + j] = j <= i ? expf(sc[u][w] * scale) : 0.f;
          }
        __syncthreads();
        // 1b. num += P v over this slice's columns tx and tx+16
        for (int j = 0; j < L; ++j) {
          const float b0 = v_s[j * kDvs + tx], b1 = v_s[j * kDvs + tx + 16];
#pragma unroll
          for (int u = 0; u < TM; ++u) {
            const float a = p_s[(ty + 16 * u) * PP + j];
            acc[u][0] = fmaf(a, b0, acc[u][0]);
            acc[u][1] = fmaf(a, b1, acc[u][1]);
          }
        }
        if (lead && t < L)
          for (int j = 0; j < L; ++j) dn += p_s[t * PP + j];
      }

      if (readout) {
        // 2. num += phi_q S, den += phi_q Z, one feature tile at a time
        const float* pq = phi_q + row0 * m;
        for (int r0 = 0; r0 < m; r0 += kMt) {
          __syncthreads();  // the previous tile's readers are done
          for (int x = t; x < L * kMt; x += kThreads) {
            const int i = x / kMt, r = x - i * kMt;
            f_s[i * FP + r] = pq[(size_t)i * m + r0 + r];
          }
          __syncthreads();
          for (int r = 0; r < kMt; ++r) {
            const float b0 = S_s[(r0 + r) * kDvs + tx];
            const float b1 = S_s[(r0 + r) * kDvs + tx + 16];
#pragma unroll
            for (int u = 0; u < TM; ++u) {
              const float a = f_s[(ty + 16 * u) * FP + r];
              acc[u][0] = fmaf(a, b0, acc[u][0]);
              acc[u][1] = fmaf(a, b1, acc[u][1]);
            }
          }
          if (lead && t < L)
            for (int r = 0; r < kMt; ++r) dn += f_s[t * FP + r] * Z_s[r0 + r];
        }
      }

      float* nb = num + row0 * dv + slice * kDvs;
#pragma unroll
      for (int u = 0; u < TM; ++u) {
        nb[(size_t)(ty + 16 * u) * dv + tx] = acc[u][0];
        nb[(size_t)(ty + 16 * u) * dv + tx + 16] = acc[u][1];
      }
      if (lead && t < L) den[row0 + t] = dn;
      __syncthreads();  // q_s, p_s and f_s are rewritten next
    }

    if (use_stream && c + 1 < n_chunks) {
      // 3. fold this chunk into (S, Z), one feature tile at a time
      const float* pk = pkb + (size_t)t0 * m;
      for (int r0 = 0; r0 < m; r0 += kMt) {
        for (int x = t; x < L * kMt; x += kThreads) {
          const int j = x / kMt, r = x - j * kMt;
          f_s[j * FP + r] = pk[(size_t)j * m + r0 + r];
        }
        __syncthreads();
        float sa[kMt / 16][2];
#pragma unroll
        for (int u = 0; u < kMt / 16; ++u) sa[u][0] = sa[u][1] = 0.f;
        for (int j = 0; j < L; ++j) {
          const float b0 = v_s[j * kDvs + tx], b1 = v_s[j * kDvs + tx + 16];
#pragma unroll
          for (int u = 0; u < kMt / 16; ++u) {
            const float a = f_s[j * FP + ty + 16 * u];
            sa[u][0] = fmaf(a, b0, sa[u][0]);
            sa[u][1] = fmaf(a, b1, sa[u][1]);
          }
        }
#pragma unroll
        for (int u = 0; u < kMt / 16; ++u) {
          S_s[(r0 + ty + 16 * u) * kDvs + tx] += sa[u][0];
          S_s[(r0 + ty + 16 * u) * kDvs + tx + 16] += sa[u][1];
        }
        if (lead && t < kMt) {
          float z = 0.f;
          for (int j = 0; j < L; ++j) z += f_s[j * FP + t];
          Z_s[r0 + t] += z;
        }
        __syncthreads();  // f_s is rewritten next; S and Z are read next chunk
      }
    }
  }
}

template <int L>
int launch(const float* q, const float* k, const float* v, const float* phi_q,
           const float* phi_k, float* num, float* den, int BH, int Gq, int T,
           int d, int dv, int m, float scale, int use_local, int use_stream,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)m * (kDvs + 1) + 2 * (size_t)L * (d + 1) +
                                       (size_t)L * kDvs + (size_t)L * (L + 1) +
                                       (size_t)L * (kMt + 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        chimera_attention_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  chimera_attention_kernel<L><<<BH * (dv / kDvs), kThreads, smem, stream>>>(
      q, k, v, phi_q, phi_k, num, den, Gq, T, d, dv, m, scale, use_local, use_stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int chimera_attention_launch(
    const float* q, const float* k, const float* v, const float* phi_q,
    const float* phi_k, float* num, float* den, int BH, int Gq, int T, int d,
    int dv, int m, int L, float scale, int use_local, int use_stream, void* stream) {
  if (BH <= 0 || Gq <= 0 || d <= 0 || T <= 0 || T % L != 0 || dv <= 0 ||
      dv % kDvs != 0 || m <= 0 || m % kMt != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 16: return launch<16>(q, k, v, phi_q, phi_k, num, den, BH, Gq, T, d, dv, m, scale, use_local, use_stream, s);
    case 32: return launch<32>(q, k, v, phi_q, phi_k, num, den, BH, Gq, T, d, dv, m, scale, use_local, use_stream, s);
    case 64: return launch<64>(q, k, v, phi_q, phi_k, num, den, BH, Gq, T, d, dv, m, scale, use_local, use_stream, s);
    case 128: return launch<128>(q, k, v, phi_q, phi_k, num, den, BH, Gq, T, d, dv, m, scale, use_local, use_stream, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
