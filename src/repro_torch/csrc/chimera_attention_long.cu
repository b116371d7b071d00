// Chunked Chimera attention forward for Hopper (sm_90a) at chunks too long
// for chimera_attention.cu's one-block-per-row design: L 256, the chunk of
// the model zoo's default Chimera configuration (d = dv = m = 128).
//
// Replaces, with chimera_attention.cu, the TPU kernel
// repro/kernels/chimera_attention/kernel.py::chimera_attention_pallas
// (pallas_call at :146, body _kernel at :36): the same partials, num and den,
// of exact causal exp attention inside each chunk of L tokens plus the
// stream readout phi_q.S, phi_q.Z against the chunks before it (Eqs. 6,
// 9-10).  The TPU kernel walks the chunks of a row in order and carries
// (S, Z) in VMEM; here the chunks run in parallel and the state before
// each chunk is built by a scan over per-chunk partials.
//
// Bound on an H100 at the Mixtral prefill shape (BH 32, Gq 4, T 8192,
// d = dv = m 128): 1.996 GB of inputs and outputs, 0.60 ms at 3.35 TB/s;
// 111.2 GFLOP, 0.67 ms as 3xTF32 on the tensor cores (0.42 ms of it the
// local term, 0.25 ms the stream readout and the fold).  Operations bound
// it, bytes nearly so.
//
// Design: three kernels, one launch call.
//   1. chimera_fold_kernel: one block per (row, chunk c < n - 1, slice of
//      128 features of m) computes that slice of the chunk's partial
//      phi_k^T [v | 1] (m x (dv + 1) over its L keys) as split-fp32
//      mma.sync (3xTF32, split_fp32.cuh), Z's column on the fp32 cores from
//      the same operands, and writes it to state slot c + 1.  Each warp
//      owns a pair of 16-row m-tiles and up to 8 n-tiles; 64-key tiles of
//      phi_k's slice and of v are staged by cp.async one tile ahead.
//   2. chimera_prefix_kernel: the exclusive prefix over the chunks, in
//      place: slot c += slot c - 1 for c = 2 .. n - 1, in that order, in
//      fp32, one thread per float4 of a row's (m, dv + 8) state.  Slot c
//      then holds S_c and Z_c, the state before chunk c.  The tensor cores
//      sum with truncation, so a long running sum stays on the fp32 cores.
//   3. chimera_chunk_kernel: one block of 4 warps per (row, chunk, query
//      group, tile of 64 query rows); warp w owns 16 query rows and all of
//      dv.  The Gq x 4 blocks of one (row, chunk) are adjacent in the grid,
//      so they share its k, v and S_c in L2, and the causally heavier query
//      tiles start first.
//      * Stream readout: 64-feature slices of phi_q's tile and of S_c
//        (with Z_c in its column dv) in two buffers filled by cp.async one
//        slice ahead; num += phi_q S_c on the tensor cores into a fresh
//        accumulator per slice, den += phi_q Z_c on the fp32 cores from
//        the same operands.  Chunk 0 reads a zero state and skips it.
//      * Local term: 32-key tiles of k and v up to the diagonal, in two
//        buffers filled by cp.async one tile ahead.  Scores Q K^T (each
//        k-step's operands read one k-step ahead; the small products in an
//        accumulator apart from the large), exp with the causal mask, and
//        P V, all split fp32 on the tensor cores.  The scores' accumulator
//        tile is P V's A operand as it stands (its k dimension permuted:
//        column t -> key 2t, t + 4 -> 2t + 1, v's rows read the same way),
//        so P never leaves registers; den sums P on the fp32 cores.  Each
//        tile's P V goes to a fresh accumulator added to num with fp32
//        adds.  The exp kernel is unnormalized (inputs are normalized, so
//        no running max), so the tiles' partials simply add.  d = dv, the
//        zoo's heads, is a compile-time width.
//      Padded row strides keep every fragment load free of bank conflicts:
//      q, k, phi_q at width + 4 (= 4 mod 8), v at dv + 4 read as key pairs
//      (2t, 2t + 1), S_c at dv + 8 (= 8 mod 16).  The local and stream
//      tiles share one region (~102 KB at the prefill shape), so two blocks
//      fit an SM.  Neither kernel's shared memory grows with m.
//   Every product splits its operands by split_rn (hi and lo rounded to
//   nearest).  The fold's and the readout's are of running sums, up to
//   ~700 where a partial is ~1 at T = 4L, m 16.  The local term's too:
//   with the truncating split its num/den erred 3.3-7.4x the fp32 plain
//   version's from float64 on a MoE prefill's inputs, enough to flip a
//   top-6 expert choice at a router gap of 1.8e-3; rounded, 1.2-2.6x, and
//   no flip wider than the plain versions' (chip_smoke.route_gaps and
//   route_flip_cause on an H100 80GB HBM3 at 700 W), for 0.62-0.65 ms at
//   the prefill shape (compare_builds, 3.32-3.36 ms against 2.70-2.71).
// What holds it back (an H100 at the prefill shape, removing one part at
// a time in variants of this source, with the local term's truncating
// split): 2.69 ms in all, 1.75 ms the local term alone, 1.01 ms the stream
// term alone, of which 0.26 ms the fold and the prefix.  With one TF32
// pass instead of three, the local term takes 1.11 ms and the stream term
// 0.69 ms; with the split instructions removed (three passes kept) 1.56
// and 0.86 ms.  So mma.sync issue and the splits take most of the time, at
// 8 warps an SM (~240 registers a thread), and the readout and the local
// term of a block run one after the other; the rounding split adds 0.50
// ms to the local term (2.24-2.26 ms alone).
//
// Contract (all float32, contiguous, 16-byte aligned; BH = batch * kv-heads):
//   q (BH,Gq,T,d) k (BH,T,d) v (BH,T,dv) phi_q (BH,Gq,T,m) phi_k (BH,T,m)
//   num (BH,Gq,T,dv) den (BH,Gq,T), written in full
//   state (BH,T/L,m,dv+8) scratch (unused when use_stream is 0 or T == L):
//     slot c, row f holds S_c[f, 0..dv-1] and Z_c[f] at column dv
// Takes L 256, T % L == 0, dv in {16, 32, 64, 128}, d % 8 == 0, m % 16 == 0,
// use_local and use_stream in every combination, any Gq, and the shared
// memory of both kernels below within the 227 KB a block may use (it grows
// with d only: d up to 384 at dv 128); anything else is
// cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "split_fp32.cuh"

namespace {

using namespace split_fp32;

constexpr int kL = 256;         // the chunk
constexpr int kQT = 64;         // query rows of a chunk block
constexpr int kKT = 32;         // keys of a staged k, v tile of the chunk kernel (two buffers)
constexpr int kFT = 64;         // keys of a staged phi_k, v tile of the fold (two buffers)
constexpr int kFM = 128;        // features of a fold block's slice of m
constexpr int kSM = 64;         // features of a staged phi_q, S_c slice of the readout
constexpr int kChunkThreads = 128;  // 4 warps of 16 query rows
constexpr int kFoldWarps = 8;
constexpr int kFoldThreads = 32 * kFoldWarps;
constexpr int kPrefixThreads = 256;
constexpr size_t kSmemLimit = 227 * 1024;

// ---- asynchronous copies ----------------------------------------------------
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// rows x cols floats (cols % 4 == 0) from global rows of stride gs into
// shared rows of stride ss, as 16-byte cp.async shared by the block's NT
// threads; the caller commits the group
template <int NT>
__device__ __forceinline__ void stage(float* dst, int ss, const float* src, size_t gs, int rows,
                                      int cols, int tid) {
  const int c4 = cols / 4;
  for (int x = tid; x < rows * c4; x += NT) {
    const int r = x / c4, e = 4 * (x - r * c4);
    cp16(dst + r * ss + e, src + (size_t)r * gs + e);
  }
}

// c[j] += a b_j in split fp32 for the NT n-tiles of b, four at a time:
// b_j's fragment is (b[8j], b[8j + koff]); RN: b split by split_rn
template <int NT, bool RN = false>
__device__ __forceinline__ void mma_b(float (*c)[4], const uint32_t ahi[4], const uint32_t alo[4],
                                     const float* b, int koff) {
  constexpr int G = NT < 4 ? NT : 4;
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += G) {
    float bv[G][2];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      bv[j][0] = b[8 * (j0 + j)];
      bv[j][1] = b[8 * (j0 + j) + koff];
    }
    mma3_n<G, RN>(c + j0, ahi, alo, bv);
  }
}

// ---- 1. the fold: per-chunk partials phi_k^T [v | 1] --------------------------
// Block (chunk c, row bh, z) takes features [kFM z, kFM z + w) of m; warp
// u takes unit u of (pair of its m-tiles mp, group of GN n-tiles ng), at
// most 4 x 2 = 8 units; units past the last idle.
template <int DV>
__global__ void __launch_bounds__(kFoldThreads, 1) chimera_fold_kernel(
    const float* __restrict__ phi_k, const float* __restrict__ v, float* __restrict__ state,
    int T, int m) {
  constexpr int NT = DV / 8;
  constexpr int GN = NT < 8 ? NT : 8;  // n-tiles of a unit
  constexpr int NG = NT / GN;
  constexpr int G = GN < 4 ? GN : 4;   // n-tiles of one pass of products
  constexpr int SV = DV + 8;  // = 8 mod 16: B fragments (t, g) hit 32 banks
  constexpr int SW = DV + 8;  // the state's row
  extern __shared__ __align__(16) float smem[];
  const int SF = (m < kFM ? m : kFM) + 8;  // = 8 mod 16: A fragments (t, g) hit 32 banks
  // buffer b of phi_k at smem + b kFT SF, of v at smem + 2 kFT SF + b kFT SV
  auto fbuf = [&](int b) { return smem + b * kFT * SF; };
  auto vbuf = [&](int b) { return smem + 2 * kFT * SF + b * kFT * SV; };

  const int c = blockIdx.x, bh = blockIdx.y, n = T / kL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int f0 = blockIdx.z * kFM, w = m - f0 < kFM ? m - f0 : kFM;
  const int mtiles = w / 16, u = warp;
  const bool active = u < (mtiles + 1) / 2 * NG;  // uniform across the warp
  const int mp = u / NG, ng = u % NG;
  const int nm = mtiles - 2 * mp < 2 ? 1 : 2;  // m-tiles of this pair
  const float* pk = phi_k + ((size_t)bh * T + (size_t)c * kL) * m + f0;
  const float* pv = v + ((size_t)bh * T + (size_t)c * kL) * DV;
  auto issue = [&](int kt) {
    stage<kFoldThreads>(fbuf(kt & 1), SF, pk + (size_t)kt * kFT * m, m, kFT, w, tid);
    stage<kFoldThreads>(vbuf(kt & 1), SV, pv + (size_t)kt * kFT * DV, DV, kFT, DV, tid);
    cp_commit();
  };

  float acc[2][GN][4], zf[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    zf[i][0] = zf[i][1] = 0.f;
#pragma unroll
    for (int j = 0; j < GN; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  }
  constexpr int NKT = kL / kFT;
  issue(0);
  for (int kt = 0; kt < NKT; ++kt) {
    if (kt + 1 < NKT) {
      issue(kt + 1);  // into the buffer every warp left at the last barrier
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (active) {
      // A = phi_k^T (feature rows, key columns): a0 (g, t) = F[t][g], a1
      // (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B = v (key rows)
      const float* F = fbuf(kt & 1) + t4 * SF + 32 * mp + g8;
      const float* V = vbuf(kt & 1) + t4 * SV + 8 * GN * ng + g8;
      float cf[2][GN][4];  // this tile's products, added to acc with fp32 adds
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < GN; ++j) cf[i][j][0] = cf[i][j][1] = cf[i][j][2] = cf[i][j][3] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < kFT / 8; ++ks) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i < nm) {
            const float* fa = F + 8 * ks * SF + 16 * i;
            const float a[4] = {fa[0], fa[8], fa[4 * SF], fa[4 * SF + 8]};
            zf[i][0] += a[0] + a[2];
            zf[i][1] += a[1] + a[3];
            split4<true>(a, ahi[i], alo[i]);
          }
        }
        const float* vb = V + 8 * ks * SV;
#pragma unroll
        for (int j0 = 0; j0 < GN; j0 += G) {
          float bv[G][2];
#pragma unroll
          for (int j = 0; j < G; ++j) {
            bv[j][0] = vb[8 * (j0 + j)];
            bv[j][1] = vb[4 * SV + 8 * (j0 + j)];
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (i < nm) mma3_n<G, true>(&cf[i][j0], ahi[i], alo[i], bv);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < GN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += cf[i][j][e];
    }
    __syncthreads();  // the buffer is refilled next
  }
  if (!active) return;
  float* const srow = state + (((size_t)bh * n + c + 1) * m + f0 + 32 * mp + g8) * SW;  // row g
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i < nm) {
      float* o = srow + 16 * i * SW + 8 * GN * ng + 2 * t4;
#pragma unroll
      for (int j = 0; j < GN; ++j) {
        *reinterpret_cast<float2*>(o + 8 * j) = make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(o + 8 * SW + 8 * j) = make_float2(acc[i][j][2], acc[i][j][3]);
      }
    }
  }
  if (ng == 0) {  // Z: the quad's key columns, summed
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        zf[i][h] += __shfl_xor_sync(0xffffffffu, zf[i][h], 1);
        zf[i][h] += __shfl_xor_sync(0xffffffffu, zf[i][h], 2);
      }
      if (i < nm && t4 == 0) {
        srow[16 * i * SW + DV] = zf[i][0];
        srow[(16 * i + 8) * SW + DV] = zf[i][1];
      }
    }
  }
}

// ---- 2. the exclusive prefix over the chunks --------------------------------
// Thread x owns float4 e of every slot of row bh (row4 float4s a slot):
// slot c += slot c - 1 for c = 2 .. n - 1, in order, eight slots' loads
// issued ahead of their adds.
__global__ void __launch_bounds__(kPrefixThreads) chimera_prefix_kernel(float* __restrict__ state,
                                                                       int BH, int n, int row4) {
  const size_t x = (size_t)blockIdx.x * kPrefixThreads + threadIdx.x;
  if (x >= (size_t)BH * row4) return;
  float4* p = reinterpret_cast<float4*>(state) + (x / row4) * n * row4 + x % row4;
  float4 s = p[row4];
  for (int c0 = 2; c0 < n; c0 += 8) {
    float4 y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c0 + i < n) y[i] = p[(size_t)(c0 + i) * row4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c0 + i < n) {
        s.x += y[i].x; s.y += y[i].y; s.z += y[i].z; s.w += y[i].w;
        p[(size_t)(c0 + i) * row4] = s;
      }
    }
  }
}

// ---- 3. the chunk kernel ------------------------------------------------------
// Shared memory, in floats: the local tiles (q and two buffers each of k
// and v), which the stream tiles (two buffers each of a slice of mf
// features of phi_q and of S_c with Z_c) reuse.  Neither grows with m.
struct Layout {
  int sq, sv, mf, sf, ss, Q, K, V, F, S, total;
  __host__ __device__ Layout(int d, int dv, int m) {
    sq = d + 4;   // = 4 mod 8: A and B fragments (g, t) hit 32 banks
    sv = dv + 4;  // = 4 mod 8: key pairs (2t, 2t + 1) hit 32 banks
    mf = m < kSM ? m : kSM;
    sf = mf + 4;
    ss = dv + 8;  // the state's row: = 8 mod 16, B fragments (t, g) hit 32 banks
    Q = 0;
    K = Q + kQT * sq;
    V = K + 2 * kKT * sq;
    const int local = V + 2 * kKT * sv;
    F = 0;
    S = F + 2 * kQT * sf;
    const int stream = S + 2 * mf * ss;
    total = local > stream ? local : stream;
  }
};

// D: d where it is known at compile time (d = dv, the zoo's heads), else 0
template <int DV, int D>
__global__ void __launch_bounds__(kChunkThreads, 2) chimera_chunk_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ phi_q, const float* __restrict__ state, float* __restrict__ num,
    float* __restrict__ den, int Gq, int T, int d_, int m, float scale, int use_local,
    int use_stream) {
  constexpr int NT = DV / 8;
  constexpr int SW = DV + 8;
  constexpr int QT = kL / kQT;
  extern __shared__ __align__(16) float smem[];
  const int d = D > 0 ? D : d_;
  const Layout lay(d, DV, m);

  // block (bh, c) outer, (g, query tile) inner; heavy query tiles first
  const int n = T / kL;
  int x = blockIdx.x;
  const int qt = QT - 1 - x % QT;
  x /= QT;
  const int g = x % Gq;
  x /= Gq;
  const int c = x % n, bh = x / n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const size_t qrow = ((size_t)bh * Gq + g) * T + (size_t)c * kL + qt * kQT;  // the tile's first row

  float acc[NT][4], tacc[NT][4];
  float dn[2] = {0.f, 0.f};  // den of rows g and g + 8, on the fp32 cores
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  auto clear = [&]() {
#pragma unroll
    for (int j = 0; j < NT; ++j) tacc[j][0] = tacc[j][1] = tacc[j][2] = tacc[j][3] = 0.f;
  };
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += tacc[j][e];
  };

  if (use_stream && c > 0) {
    // num += phi_q S_c (tensor cores), den += phi_q Z_c (fp32 cores), one
    // slice of mf features at a time, the next slice's copy in flight
    const int SF = lay.sf, MF = lay.mf, ns = (m + MF - 1) / MF;
    auto fbuf = [&](int b) { return smem + lay.F + b * kQT * SF; };
    auto sbuf = [&](int b) { return smem + lay.S + b * MF * SW; };
    const float* pq = phi_q + qrow * m;
    const float* ps = state + ((size_t)bh * n + c) * m * SW;
    auto issue = [&](int sl) {  // slice sl into buffer sl % 2, one group
      const int f0 = sl * MF, w = m - f0 < MF ? m - f0 : MF;
      stage<kChunkThreads>(fbuf(sl & 1), SF, pq + f0, m, kQT, w, tid);
      stage<kChunkThreads>(sbuf(sl & 1), SW, ps + (size_t)f0 * SW, SW, w, SW, tid);
      cp_commit();
    };
    issue(0);
    if (ns > 1) issue(1);
    for (int sl = 0; sl < ns; ++sl) {
      if (sl + 1 < ns) {
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();  // slice sl landed
      const int w = m - sl * MF < MF ? m - sl * MF : MF;
      const float* S = sbuf(sl & 1);
      const float* fa = fbuf(sl & 1) + (16 * warp + g8) * SF + t4;
      const float* sb = S + t4 * SW + g8;
      clear();
#pragma unroll 2
      for (int kk = 0; kk < kSM / 8; ++kk) {
        const int f = 8 * kk;
        if (f < w) {
          const float a[4] = {fa[f], fa[f + 8 * SF], fa[f + 4], fa[f + 8 * SF + 4]};
          const float z0 = S[(f + t4) * SW + DV], z1 = S[(f + t4 + 4) * SW + DV];
          dn[0] = fmaf(a[0], z0, fmaf(a[2], z1, dn[0]));
          dn[1] = fmaf(a[1], z0, fmaf(a[3], z1, dn[1]));
          uint32_t ahi[4], alo[4];
          split4<true>(a, ahi, alo);
          mma_b<NT, true>(tacc, ahi, alo, sb + f * SW, 4 * SW);
        }
      }
      flush();
      __syncthreads();  // every warp is done with buffer sl % 2 (the region is restaged next)
      if (sl + 2 < ns) issue(sl + 2);
    }
  }

  if (use_local) {
    const int SQ = lay.sq, SV = lay.sv;
    auto kbuf = [&](int b) { return smem + lay.K + b * kKT * SQ; };
    auto vbuf = [&](int b) { return smem + lay.V + b * kKT * SV; };
    const float* kb = k + ((size_t)bh * T + (size_t)c * kL) * d;
    const float* vb = v + ((size_t)bh * T + (size_t)c * kL) * DV;
    auto issue = [&](int kt) {  // key tile kt into buffer kt % 2, one group
      stage<kChunkThreads>(kbuf(kt & 1), SQ, kb + (size_t)kt * kKT * d, d, kKT, d, tid);
      stage<kChunkThreads>(vbuf(kt & 1), SV, vb + (size_t)kt * kKT * DV, DV, kKT, DV, tid);
      cp_commit();
    };
    const int nkt = (qt + 1) * (kQT / kKT);  // key tiles up to the diagonal
    stage<kChunkThreads>(smem + lay.Q, SQ, q + qrow * d, d, kQT, d, tid);
    issue(0);  // with q
    if (nkt > 1) issue(1);
    const float* qa = smem + lay.Q + (16 * warp + g8) * SQ + t4;
    const int row = qt * kQT + 16 * warp + g8;  // the thread's rows in the chunk: row, row + 8
    for (int kt = 0; kt < nkt; ++kt) {
      if (kt + 1 < nkt) {
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();  // tile kt landed
      // key blocks of 8 up to the warp's last row (all 4 below the diagonal)
      const int span = qt * kQT + 16 * warp + 15 - kt * kKT;
      const int nb = span < 0 ? 0 : (span / 8 + 1 < kKT / 8 ? span / 8 + 1 : kKT / 8);
      if (nb > 0) {
        // scores q k^T, each k-step's operands loaded one k-step ahead; the
        // small products (lo hi, hi lo) in their own accumulator: two
        // independent chains, and the small terms summed apart from the large
        const float* kr = kbuf(kt & 1) + g8 * SQ + t4;
        float s[4][4], sl[4][4], a[2][4], b[2][4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
          sl[j][0] = sl[j][1] = sl[j][2] = sl[j][3] = 0.f;
        }
        auto load = [&](float* au, float (*bu)[2], int e) {
          au[0] = qa[e];
          au[1] = qa[e + 8 * SQ];
          au[2] = qa[e + 4];
          au[3] = qa[e + 8 * SQ + 4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < nb) {
              bu[j][0] = kr[8 * j * SQ + e];
              bu[j][1] = kr[8 * j * SQ + e + 4];
            }
        };
        auto product = [&](const float* au, const float (*bu)[2]) {
          uint32_t ahi[4], alo[4];
          split4<true>(au, ahi, alo);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < nb) {
              const Split b0 = split_rn(bu[j][0]), b1 = split_rn(bu[j][1]);
              mma(sl[j], alo, b0.hi, b1.hi);
              mma(sl[j], ahi, b0.lo, b1.lo);
              mma(s[j], ahi, b0.hi, b1.hi);
            }
          }
        };
        load(a[0], b[0], 0);
#pragma unroll
        for (int e = 0; e < d; e += 16) {
          if (e + 8 < d) load(a[1], b[1], e + 8);
          product(a[0], b[0]);
          if (e + 16 < d) load(a[0], b[0], e + 16);
          if (e + 8 < d) product(a[1], b[1]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] += sl[j][e];
            const int key = kt * kKT + 8 * j + 2 * t4;
            s[j][0] = key <= row ? expf(s[j][0] * scale) : 0.f;
            s[j][1] = key + 1 <= row ? expf(s[j][1] * scale) : 0.f;
            s[j][2] = key <= row + 8 ? expf(s[j][2] * scale) : 0.f;
            s[j][3] = key + 1 <= row + 8 ? expf(s[j][3] * scale) : 0.f;
            dn[0] += s[j][0] + s[j][1];
            dn[1] += s[j][2] + s[j][3];
          }
        }
        // P v into a fresh accumulator
        const float* vr = vbuf(kt & 1) + 2 * t4 * SV + g8;
        clear();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < nb) {
            // P as the A operand with keys permuted: column t -> key 2t, t + 4 -> 2t + 1
            const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
            uint32_t ahi[4], alo[4];
            split4<true>(pa, ahi, alo);
            mma_b<NT, true>(tacc, ahi, alo, vr + 8 * j * SV, SV);
          }
        }
        flush();
      }
      __syncthreads();  // every warp is done with buffer kt % 2
      if (kt + 2 < nkt) issue(kt + 2);
    }
  }

  // den over the quad's columns
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dn[i] += __shfl_xor_sync(0xffffffffu, dn[i], 1);
    dn[i] += __shfl_xor_sync(0xffffffffu, dn[i], 2);
  }
  const size_t r0 = qrow + 16 * warp + g8;
  float* o = num + r0 * DV + 2 * t4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *reinterpret_cast<float2*>(o + 8 * j) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(o + 8 * DV + 8 * j) = make_float2(acc[j][2], acc[j][3]);
  }
  if (t4 == 0) {
    den[r0] = dn[0];
    den[r0 + 8] = dn[1];
  }
}

template <int DV>
size_t fold_smem(int m) {
  return sizeof(float) * 2 * kFT * (size_t)((m < kFM ? m : kFM) + 8 + DV + 8);
}

// passes 1 and 2: state slot c = (S_c, Z_c) for c = 1 .. n - 1
template <int DV>
int launch_state(const float* phi_k, const float* v, float* state, int BH, int T, int m,
                 cudaStream_t stream) {
  const int n = T / kL;
  if (n < 2) return (int)cudaSuccess;
  const size_t smem = fold_smem<DV>(m);
  if (state == nullptr || smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      chimera_fold_kernel<DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  chimera_fold_kernel<DV><<<dim3(n - 1, BH, (m + kFM - 1) / kFM), kFoldThreads, smem, stream>>>(
      phi_k, v, state, T, m);
  err = cudaGetLastError();
  if (err != cudaSuccess || n < 3) return (int)err;
  const int row4 = m * (DV + 8) / 4;
  const size_t threads = (size_t)BH * row4;
  chimera_prefix_kernel<<<(unsigned)((threads + kPrefixThreads - 1) / kPrefixThreads),
                          kPrefixThreads, 0, stream>>>(state, BH, n, row4);
  return (int)cudaGetLastError();
}

template <int DV>
int launch(const float* q, const float* k, const float* v, const float* phi_q,
           const float* phi_k, float* num, float* den, float* state, int BH, int Gq, int T,
           int d, int m, float scale, int use_local, int use_stream, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)Layout(d, DV, m).total;
  if (smem > kSmemLimit || fold_smem<DV>(m) > kSmemLimit) return (int)cudaErrorInvalidValue;
  const int n = T / kL;
  const size_t blocks = (size_t)BH * n * Gq * (kL / kQT);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (use_stream) {
    const int err = launch_state<DV>(phi_k, v, state, BH, T, m, stream);
    if (err != (int)cudaSuccess) return err;
  }
  auto kernel = d == DV ? chimera_chunk_kernel<DV, DV> : chimera_chunk_kernel<DV, 0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kChunkThreads, smem, stream>>>(q, k, v, phi_q, state, num, den, Gq,
                                                             T, d, m, scale, use_local,
                                                             use_stream);
  return (int)cudaGetLastError();
}

bool widths_taken(int d, int m, int L, int T) {
  return d > 0 && d % 8 == 0 && L == kL && T > 0 && T % kL == 0 && m > 0 && m % 16 == 0;
}

bool aligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if ((uintptr_t)p & 15) return false;
  return true;
}

}  // namespace

extern "C" int chimera_attention_long_launch(
    const float* q, const float* k, const float* v, const float* phi_q,
    const float* phi_k, float* num, float* den, float* state, int BH, int Gq, int T, int d,
    int dv, int m, int L, float scale, int use_local, int use_stream, void* stream) {
  if (BH <= 0 || Gq <= 0 || !widths_taken(d, m, L, T) || (size_t)BH * Gq > 0x7fffffff ||
      !aligned({q, k, v, phi_q, phi_k, num, den, state}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dv) {
    case 16: return launch<16>(q, k, v, phi_q, phi_k, num, den, state, BH, Gq, T, d, m, scale, use_local, use_stream, s);
    case 32: return launch<32>(q, k, v, phi_q, phi_k, num, den, state, BH, Gq, T, d, m, scale, use_local, use_stream, s);
    case 64: return launch<64>(q, k, v, phi_q, phi_k, num, den, state, BH, Gq, T, d, m, scale, use_local, use_stream, s);
    case 128: return launch<128>(q, k, v, phi_q, phi_k, num, den, state, BH, Gq, T, d, m, scale, use_local, use_stream, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
