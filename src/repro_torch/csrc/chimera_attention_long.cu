// Chunked Chimera attention forward for Hopper (sm_90a) at chunks too long
// for chimera_attention.cu's one-block-per-row design: L 256, the chunk of
// the model zoo's default Chimera configuration (d = dv = m = 128).
//
// Replaces, with chimera_attention.cu, the TPU kernel
// repro/kernels/chimera_attention/kernel.py::chimera_attention_pallas
// (pallas_call at :146, body _kernel at :36): the same partials, num and den,
// of exact causal exp attention inside each chunk of L tokens plus the
// stream readout phi_q.S, phi_q.Z against the chunks before it (Eqs. 6,
// 9-10).  chimera_attention.cu keeps a row's whole chunk (q, k, v and the
// phi tiles) and S in one block's shared memory; at L 256 and d 128 its
// staging would need ~475 KB, twice what a block may use.
//
// Design: two kernels, one launch call.
//   1. chimera_prefix_kernel: S_c = sum over chunks c' < c of phi_k^T v and
//      Z_c = sum of phi_k, for every chunk c, written to a scratch of
//      (BH, T/L, m, dv + 1) floats.  Block (row, group of S rows); each
//      thread owns one float4 of S and walks the chunks in order, adding
//      each chunk's sum (a fresh partial) to the running state it writes.
//   2. chimera_chunk_kernel: one block per (row, query group, chunk, tile of
//      kQT query rows), so that the chunks run in parallel.  The local term
//      walks the key tiles (kKT keys) up to the diagonal: scores Q K^T from
//      shared memory, exp with the causal mask on the diagonal tile, P
//      through shared memory into P V.  The exp kernel is unnormalized
//      (inputs are normalized, so no running max), so each key tile's
//      partials simply add.  The stream term reads S_c and Z_c in tiles of
//      kMT feature rows against the query rows' phi_q.
// Everything is fp32 on the CUDA cores.  Bound on an H100 at the Mixtral
// prefill shape (BH 32, Gq 4, T 8192, d = dv = m 128): ~1.9 GB of inputs
// and outputs, 0.57 ms at 3.35 TB/s; 112 GFLOP, 0.68 ms as 3xTF32 on the
// tensor cores and 1.7 ms on the fp32 cores.  This design is the simple
// one, right first: the fp32 cores, no tensor cores, no asynchronous
// copies; a faster one is later work.
//
// Contract (all float32, contiguous, 16-byte aligned; BH = batch * kv-heads):
//   q (BH,Gq,T,d) k (BH,T,d) v (BH,T,dv) phi_q (BH,Gq,T,m) phi_k (BH,T,m)
//   num (BH,Gq,T,dv) den (BH,Gq,T), written in full
//   state (BH,T/L,m,dv+1) scratch (unused when use_stream is 0 or T == L)
// Takes L 256, T % L == 0, dv in {16, 32, 64, 128}, d % 8 == 0,
// m % 16 == 0 and the shared memory below within the 227 KB a block may
// use; anything else is cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 64;  // query rows of a chunk block
constexpr int kKT = 32;  // keys of a local tile
constexpr int kMT = 16;  // feature rows of a stream tile
constexpr int kTX = 16;  // threads across the columns of a tile

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// Shared memory of the chunk kernel, in floats: q rows, then the local
// tiles (k, v, P), which the stream tiles (phi_q, S, Z) reuse.
struct Layout {
  int sq, sp, sf, Q, K, V, P, F, S, Zs, total;
  __host__ __device__ Layout(int d, int dv) {
    sq = d + 4;    // row stride of q and k (= 4 mod 8: float4 reads of 8 rows hit 32 banks)
    sp = kKT + 1;  // row stride of P
    sf = kMT + 1;  // row stride of the phi_q tile
    Q = 0;
    K = Q + kQT * sq;
    V = K + kKT * sq;
    P = V + kKT * dv;
    const int local = P + kQT * sp;
    F = K;
    S = F + kQT * sf;
    Zs = S + kMT * dv;
    const int stream = Zs + kMT;
    total = local > stream ? local : stream;
  }
};

// S_c and Z_c (the state before chunk c) for every chunk; thread (r, cg)
// owns S[r, 4 cg .. 4 cg + 3] and, at cg 0, Z[r].
template <int DV>
__global__ void __launch_bounds__(kThreads) chimera_prefix_kernel(
    const float* __restrict__ phi_k, const float* __restrict__ v, float* __restrict__ state,
    int T, int m, int L) {
  constexpr int CG = DV / 4;
  constexpr int RB = kThreads / CG;  // rows of S per block
  const int bh = blockIdx.x;
  const int r = blockIdx.y * RB + threadIdx.x / CG, cg = threadIdx.x % CG;
  if (r >= m) return;  // no barrier in this kernel
  const int n = T / L;
  const float* pk = phi_k + (size_t)bh * T * m + r;
  const float* vb = v + (size_t)bh * T * DV + 4 * cg;
  float* st = state + ((size_t)bh * n * m + r) * (DV + 1);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  float z = 0.f;
  for (int c = 0; c < n; ++c) {
    float* out = st + (size_t)c * m * (DV + 1);
    out[4 * cg] = s.x; out[4 * cg + 1] = s.y; out[4 * cg + 2] = s.z; out[4 * cg + 3] = s.w;
    if (cg == 0) out[DV] = z;
    if (c + 1 == n) break;
    float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);
    float cz = 0.f;
#pragma unroll 8
    for (int j = c * L; j < (c + 1) * L; ++j) {
      const float p = __ldg(pk + (size_t)j * m);
      const float4 x = __ldg(reinterpret_cast<const float4*>(vb + (size_t)j * DV));
      cs.x = fmaf(p, x.x, cs.x); cs.y = fmaf(p, x.y, cs.y);
      cs.z = fmaf(p, x.z, cs.z); cs.w = fmaf(p, x.w, cs.w);
      cz += p;
    }
    s.x += cs.x; s.y += cs.y; s.z += cs.z; s.w += cs.w;
    z += cz;
  }
}

// Block (row bh, group g, chunk c, query tile qt): thread (ty, tx) owns
// query rows 4 ty .. 4 ty + 3 of the tile and columns tx, tx + 16, ... of
// dv (NC = dv / 16 of them); for the scores, keys tx and tx + 16 of a tile.
template <int DV>
__global__ void __launch_bounds__(kThreads, 2) chimera_chunk_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ phi_q, const float* __restrict__ state,
    float* __restrict__ num, float* __restrict__ den, int Gq, int T, int d, int m, int L,
    float scale, int use_local, int use_stream) {
  constexpr int NC = DV / kTX;
  extern __shared__ __align__(16) float smem[];
  const Layout lay(d, DV);
  float* Q_s = smem + lay.Q;
  float* K_s = smem + lay.K;
  float* V_s = smem + lay.V;
  float* P_s = smem + lay.P;
  float* F_s = smem + lay.F;
  float* S_s = smem + lay.S;
  float* Z_s = smem + lay.Zs;
  const int SQ = lay.sq, SP = lay.sp, SF = lay.sf;

  const int bh = blockIdx.x / Gq, g = blockIdx.x % Gq;
  const int c = blockIdx.y, qt = blockIdx.z, n = T / L;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int row0 = c * L + qt * kQT;  // the tile's first query, in the sequence
  const int d4 = d / 4;

  float acc[4][NC];
  float dn[4] = {0.f, 0.f, 0.f, 0.f};  // this thread's share of each row's den
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[i][cc] = 0.f;

  if (use_local) {
    const float* qg = q + (((size_t)bh * Gq + g) * T + row0) * d;
    for (int x = tid; x < kQT * d4; x += kThreads) {
      const int r = x / d4, e = 4 * (x - r * d4);
      st4(Q_s + r * SQ + e, ld4(qg + (size_t)r * d + e));
    }
    const int nkt = (qt + 1) * kQT / kKT;  // key tiles up to the diagonal
    for (int kt = 0; kt < nkt; ++kt) {
      const int key0 = c * L + kt * kKT;
      const float* kb = k + ((size_t)bh * T + key0) * d;
      const float* vb = v + ((size_t)bh * T + key0) * DV;
      for (int x = tid; x < kKT * d4; x += kThreads) {
        const int r = x / d4, e = 4 * (x - r * d4);
        st4(K_s + r * SQ + e, ld4(kb + (size_t)r * d + e));
      }
      for (int x = tid; x < kKT * DV / 4; x += kThreads) st4(V_s + 4 * x, ld4(vb + 4 * x));
      __syncthreads();
      // scores of rows 4 ty + i against keys tx and tx + 16
      float s[4][2] = {};
      for (int e = 0; e < d; e += 4) {
        const float4 k0 = ld4(K_s + tx * SQ + e), k1 = ld4(K_s + (tx + kTX) * SQ + e);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a = ld4(Q_s + (4 * ty + i) * SQ + e);
          s[i][0] = fmaf(a.x, k0.x, fmaf(a.y, k0.y, fmaf(a.z, k0.z, fmaf(a.w, k0.w, s[i][0]))));
          s[i][1] = fmaf(a.x, k1.x, fmaf(a.y, k1.y, fmaf(a.z, k1.z, fmaf(a.w, k1.w, s[i][1]))));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = qt * kQT + 4 * ty + i;  // query and keys, within the chunk
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int kj = kt * kKT + tx + u * kTX;
          const float p = kj <= qi ? expf(s[i][u] * scale) : 0.f;
          dn[i] += p;
          P_s[(4 * ty + i) * SP + tx + u * kTX] = p;
        }
      }
      __syncthreads();
      for (int j = 0; j < kKT; ++j) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = P_s[(4 * ty + i) * SP + j];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const float x = V_s[j * DV + tx + kTX * cc];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(p[i], x, acc[i][cc]);
        }
      }
      __syncthreads();  // K, V and P are refilled next
    }
  }

  if (use_stream && c > 0) {
    const float* fq = phi_q + (((size_t)bh * Gq + g) * T + row0) * m;
    const float* st = state + ((size_t)bh * n + c) * m * (DV + 1);
    for (int f0 = 0; f0 < m; f0 += kMT) {
      for (int x = tid; x < kQT * (kMT / 4); x += kThreads) {
        const int r = x / (kMT / 4), e = 4 * (x - r * (kMT / 4));
        const float4 y = ld4(fq + (size_t)r * m + f0 + e);
        float* dst = F_s + r * SF + e;
        dst[0] = y.x; dst[1] = y.y; dst[2] = y.z; dst[3] = y.w;
      }
      for (int x = tid; x < kMT * (DV + 1); x += kThreads) {
        const int r = x / (DV + 1), e = x - r * (DV + 1);
        const float y = st[(size_t)(f0 + r) * (DV + 1) + e];
        if (e < DV) S_s[r * DV + e] = y;
        else Z_s[r] = y;
      }
      __syncthreads();
      for (int f = 0; f < kMT; ++f) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = F_s[(4 * ty + i) * SF + f];
        if (f == tx) {
#pragma unroll
          for (int i = 0; i < 4; ++i) dn[i] = fmaf(p[i], Z_s[f], dn[i]);
        }
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const float x = S_s[f * DV + tx + kTX * cc];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(p[i], x, acc[i][cc]);
        }
      }
      __syncthreads();  // the tiles are refilled next
    }
  }

  // den: the 16 column threads of a row hold its shares
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 1; o < kTX; o <<= 1) dn[i] += __shfl_xor_sync(0xffffffffu, dn[i], o);
  const size_t r0 = ((size_t)bh * Gq + g) * T + row0 + 4 * ty;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* o = num + (r0 + i) * DV;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) o[tx + kTX * cc] = acc[i][cc];
    if (tx == 0) den[r0 + i] = dn[i];
  }
}

template <int DV>
int launch(const float* q, const float* k, const float* v, const float* phi_q,
           const float* phi_k, float* num, float* den, float* state, int BH, int Gq, int T,
           int d, int m, int L, float scale, int use_local, int use_stream,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)Layout(d, DV).total;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int n = T / L;
  if (use_stream && n > 1) {
    if (state == nullptr) return (int)cudaErrorInvalidValue;
    constexpr int RB = kThreads / (DV / 4);
    chimera_prefix_kernel<DV><<<dim3(BH, (m + RB - 1) / RB), kThreads, 0, stream>>>(
        phi_k, v, state, T, m, L);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      chimera_chunk_kernel<DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  chimera_chunk_kernel<DV><<<dim3(BH * Gq, n, L / kQT), kThreads, smem, stream>>>(
      q, k, v, phi_q, state, num, den, Gq, T, d, m, L, scale, use_local, use_stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int chimera_attention_long_launch(
    const float* q, const float* k, const float* v, const float* phi_q,
    const float* phi_k, float* num, float* den, float* state, int BH, int Gq, int T, int d,
    int dv, int m, int L, float scale, int use_local, int use_stream, void* stream) {
  if (BH <= 0 || Gq <= 0 || d <= 0 || d % 8 || L != 256 || T <= 0 || T % L || m <= 0 ||
      m % kMT || (size_t)BH * Gq > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, phi_q, phi_k, num, den, state};
  for (const void* p : ptrs)
    if ((uintptr_t)p & 15) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dv) {
    case 16: return launch<16>(q, k, v, phi_q, phi_k, num, den, state, BH, Gq, T, d, m, L, scale, use_local, use_stream, s);
    case 32: return launch<32>(q, k, v, phi_q, phi_k, num, den, state, BH, Gq, T, d, m, L, scale, use_local, use_stream, s);
    case 64: return launch<64>(q, k, v, phi_q, phi_k, num, den, state, BH, Gq, T, d, m, L, scale, use_local, use_stream, s);
    case 128: return launch<128>(q, k, v, phi_q, phi_k, num, den, state, BH, Gq, T, d, m, L, scale, use_local, use_stream, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
