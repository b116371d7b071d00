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
// Bound on an H100 at the paper's training shapes (BH 1024, T 256, d = dv
// 64, m 256, L 64): 672 MB, 0.20 ms at 3.35 TB/s; 15.2 GFLOP, 0.23 ms on
// the fp32 CUDA cores.  A first design ran every product on CUDA cores out
// of shared memory (six 4-byte loads per eight FMAs) and measured 1.52 ms.
//
// Design.  One block of 8 warps owns a row and all of dv, and walks the
// chunks with S and Z in shared memory.  The four products of a chunk (q k^T,
// P v, phi_q S, phi_k^T v) run on the tensor cores as mma.sync.m16n8k8 in
// split fp32 (3xTF32, split_fp32.cuh): each operand is split as a = a_hi +
// a_lo, both TF32, and a_lo b_hi + a_hi b_lo + a_hi b_hi is summed in fp32,
// which keeps the error well inside the 1e-4 tolerance (one TF32 pass keeps
// about three digits and does not).  That is 46 GFLOP of TF32 work, 0.09 ms at 495
// TFLOP/s, so bytes bound the kernel; den (the row sums of P, phi_q Z) and Z
// are summed on the fp32 cores from the same operands.
//   * The scores' accumulator tile is the A operand of P v as it stands:
//     the k dimension of P v is permuted (A column t -> key 2t, t + 4 ->
//     key 2t + 1, rows of v read the same way), so P never leaves registers;
//     the fold phi_k^T v permutes its keys the same way.
//   * Warp w takes query rows 16 rt .. + 15; the 8 / (L/16) warps of a row
//     tile split the keys and the feature columns between them and sum their
//     partials in a fixed order, so the scores are computed once.  Warps w
//     and w + 4, which share a sub-partition of the SM, take row tiles rt
//     and L/16 - 1 - rt, so the causal work is even across sub-partitions.
//   * Each tile's products go to a fresh accumulator that is added to the
//     running sums with fp32 adds: the tensor cores sum with truncation,
//     which biases a long running sum beyond the tolerance.
//   * Staging is asynchronous: 16-byte cp.async into padded tiles (strides
//     chosen so that every fragment load is free of bank conflicts), each
//     buffer with its own mbarrier.  q, k and v of the next chunk and the
//     phi tiles (a ring of 2-3 tiles of L x 64 floats) load while the
//     current ones are in use; each k-step's operands are read from shared
//     memory one k-step ahead of their products.
// What holds it back (seen on an H100 by removing one part at a time): with
// 8 warps on an SM and ~200 registers each, the instructions around the
// products (fragment loads, the splits, the fp32 flushes) issue at a low
// rate, the tensor cores stay well below their mma.sync rate, and the
// local, readout and fold phases add up rather than overlap the loads.  A
// producer warp with full/empty barriers in place of the block barriers,
// and v split once per chunk instead of by every warp, measured no faster.
//
// Contract (all float32, contiguous, 16-byte aligned; BH = batch * kv-heads):
//   q (BH,Gq,T,d) k (BH,T,d) v (BH,T,dv) phi_q (BH,Gq,T,m) phi_k (BH,T,m)
//   num (BH,Gq,T,dv) den (BH,Gq,T), written in full
// Takes L in {16, 32, 64, 128} (L 256, the model zoo's default chunk, is
// chimera_attention_long.cu's: its chunk does not fit one block's shared
// memory in this layout), T % L == 0, dv in {16, 32, 64, 128},
// d % 8 == 0, m % 16 == 0, and the shared memory of the layout below within
// the 227 KB a block may use; anything else is cudaErrorInvalidValue.
// use_local, use_stream and any Gq are kept.  The phi tile is 64 columns
// (32 at L 128) where m is a multiple of it, the paper's shapes among them;
// any other m (16 and 32 in the smoke configs) takes 16-column tiles, where
// fewer k-steps than warps share a tile's readout and the rest add zeros.

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_fp32.cuh"

namespace {

using namespace split_fp32;
using split_fp32::mma3_n;  // overloaded below for operands in shared memory

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 3;

// ---- mbarriers and asynchronous copies --------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}
// Copies ROWS rows of cols floats (global row stride gstride) into shared
// memory rows of stride sstride as 16-byte cp.async, every thread of the
// block taking its share; the mbarrier (one arrival per thread) completes
// when all of them have landed.  Called by every thread, after a barrier
// that retired every reader of dst.  COLS, where the caller knows it, makes
// cols a constant and the loop's divisions shifts.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(float* dst, int sstride, const float* src, size_t gstride,
                                          uint64_t* bar, int tid, int cols = COLS) {
  const int c4 = (COLS ? COLS : cols) / 4;
#pragma unroll
  for (int x = tid; x < ROWS * c4; x += kThreads) {
    const int r = x / c4, e = 4 * (x - r * c4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(smem_u32(dst + r * sstride + e)), "l"(src + (size_t)r * gstride + e)
                 : "memory");
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// ---- operands of the split-fp32 products (split_fp32.cuh) -------------------
// mma3_n with b_j's fragment read from shared memory: (b[8j], b[8j + koff])
template <int N>
__device__ __forceinline__ void mma3_n(float (*c)[4], const uint32_t ahi[4], const uint32_t alo[4],
                                       const float* b, int koff, int n = N) {
  float bv[N][2];
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) {
      bv[j][0] = b[8 * j];
      bv[j][1] = b[8 * j + koff];
    }
  mma3_n<N>(c, ahi, alo, bv, n);
}

// The operands of one k-step: a's four values and b's two per n-tile, as
// loaded from shared memory; loaded one k-step ahead of their products so
// that the loads' latency hides behind the previous k-step's mma.sync.
template <int N>
struct Operands {
  float a[4], b[N][2];
  __device__ __forceinline__ void load(const float* pa, int a_row8, int a_col4,
                                       const float* pb, int koff, int n = N) {
    a[0] = pa[0];
    a[1] = pa[a_row8];
    a[2] = pa[a_col4];
    a[3] = pa[a_row8 + a_col4];
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < n) {
        b[j][0] = pb[8 * j];
        b[j][1] = pb[8 * j + koff];
      }
  }
};

// ---- layout ----------------------------------------------------------------
template <int L>
struct Tile {
  static constexpr int MT = L == 128 ? 32 : 64;  // phi columns per ring tile
  static constexpr int kGeneric = 16;            // the tile for any other m % 16 == 0
};

// Shared-memory layout, in floats (every region a multiple of 4 floats).
struct Layout {
  int S, Z, Q, K, V, ring, red, total;
  int ss, sq, sv, sf;  // row strides of S, q and k, v, phi tiles
  __host__ __device__ Layout(int L, int d, int dv, int m, int mt, int stages, int vbufs) {
    const int rt = L / 16, ks = kWarps / rt;
    ss = dv + 8;   // = 8 mod 16: B fragments of S hit 32 banks
    sq = d + 4;    // = 4 mod 8: A and B fragments of q, k hit 32 banks
    sv = dv + 4;   // = 4 mod 8: row pairs (2t, 2t+1) hit 32 banks
    sf = mt + 4;   // = 4 mod 8
    S = 0;
    Z = S + m * ss;
    Q = Z + m;
    K = Q + L * sq;
    V = K + L * sq;
    ring = V + vbufs * L * sv;
    red = ring + stages * L * sf;
    total = red + (ks - 1) * L * ss;
  }
};

template <int L, int DV, int MT>
__global__ void __launch_bounds__(kThreads, 1) chimera_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ phi_q,
    const float* __restrict__ phi_k, float* __restrict__ num,
    float* __restrict__ den, int Gq, int T, int d, int m, float scale,
    int use_local, int use_stream, int stages, int vbufs) {
  constexpr int RT = L / 16;          // row tiles of a chunk
  constexpr int KS = kWarps / RT;     // warps sharing a row tile
  constexpr int NT = DV / 8;          // n-tiles of num
  constexpr int FM = MT / 16;         // m-tiles of a fold tile
  constexpr int FN = kWarps / FM;     // warps sharing an m-tile in the fold
  constexpr int FNT = (NT + FN - 1) / FN;
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bars[4 + kMaxStages];  // q, k, v0, v1, ring

  const Layout lay(L, d, DV, m, MT, stages, vbufs);
  float* S_s = smem + lay.S;
  float* Z_s = smem + lay.Z;
  float* Q_s = smem + lay.Q;
  float* K_s = smem + lay.K;
  float* red = smem + lay.red;
  const int SS = lay.ss, SQ = lay.sq, SV = lay.sv, SF = lay.sf;
  uint64_t* bar_q = bars;
  uint64_t* bar_k = bars + 1;
  uint64_t* bar_v = bars + 2;
  uint64_t* bar_r = bars + 4;

  const int bh = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  // row tile rt of warp w and its place h among the KS warps of that tile:
  // warps w and w + 4 share a sub-partition of the SM, so they take row
  // tiles whose causal work adds up evenly (rt and RT - 1 - rt)
  int rt, h;
  if (RT == 1) {
    rt = 0, h = warp;
  } else if (RT == 2) {
    rt = (warp + warp / 4) % 2, h = warp / 2;
  } else {
    rt = warp < 4 ? warp : RT + 3 - warp, h = warp / RT;
  }
  const int n = T / L, nmt = m / MT;

  for (int x = tid; x < m * SS + m; x += kThreads) S_s[x] = 0.f;  // S and Z
  if (tid == 0) {
    for (int i = 0; i < 4 + stages; ++i) mbar_init(bars + i, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto readout = [&](int c) { return use_stream && c > 0; };
  auto fold = [&](int c) { return use_stream && c + 1 < n; };
  auto need_v = [&](int c) { return use_local || fold(c); };
  auto vbuf = [&](int c) { return smem + lay.V + (c % vbufs) * L * SV; };
  // the phi tiles in the order they are used: phi_k of chunk 0, then per
  // chunk Gq * nmt tiles of phi_q and nmt of phi_k (none after the last)
  const int n_phi = (use_stream && n > 1) ? nmt + (n - 2) * (Gq + 1) * nmt + Gq * nmt : 0;
  int ic = 0, ig = 0, imt = 0, islot = 0;  // the next tile to issue: chunk, group, column tile
  bool iq = false;                         // phi_q (else phi_k)
  auto issue_phi = [&]() {
    const float* src = iq ? phi_q + (((size_t)bh * Gq + ig) * T + (size_t)ic * L) * m + imt * MT
                          : phi_k + ((size_t)bh * T + (size_t)ic * L) * m + imt * MT;
    load_tile<L, MT>(smem + lay.ring + islot * L * SF, SF, src, m, bar_r + islot, tid);
    islot = islot + 1 == stages ? 0 : islot + 1;
    if (++imt < nmt) return;
    imt = 0;
    if (!iq) {
      ++ic;
      iq = true;
    } else if (++ig == Gq) {
      ig = 0;
      iq = false;
      if (ic + 1 >= n) ++ic;  // the last chunk folds nothing
    }
  };
  auto issue_q = [&](int c, int g) {
    load_tile<L, 0>(Q_s, SQ, q + (((size_t)bh * Gq + g) * T + (size_t)c * L) * d, d, bar_q, tid, d);
  };
  auto issue_k = [&](int c) {
    load_tile<L, 0>(K_s, SQ, k + ((size_t)bh * T + (size_t)c * L) * d, d, bar_k, tid, d);
  };
  auto issue_v = [&](int c) {
    load_tile<L, DV>(vbuf(c), SV, v + ((size_t)bh * T + (size_t)c * L) * DV, DV,
                     bar_v + (c % vbufs), tid);
  };

  if (use_local) {
    issue_k(0);
    issue_q(0, 0);
  }
  if (need_v(0)) issue_v(0);
  int n_issued = 0;
  for (; n_issued < stages && n_issued < n_phi; ++n_issued) issue_phi();
  uint32_t uses_q = 0, uses_k = 0, uses_v[2] = {0, 0};
  int cslot = 0;         // the ring slot of the next phi tile to use
  uint32_t cphase = 0;   // and the parity of its fill

  for (int c = 0; c < n; ++c) {
    const int t0 = c * L;
    const float* V_s = vbuf(c);
    if (use_local) mbar_wait(bar_k, uses_k++ & 1);
    if (need_v(c)) mbar_wait(bar_v + c % vbufs, uses_v[c % vbufs]++ & 1);

    for (int g = 0; g < Gq; ++g) {
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      float dn[2] = {0.f, 0.f};  // den of rows g and g + 8, on the fp32 cores

      // each product of a tile goes to a fresh accumulator, added to acc with
      // fp32 adds: the tensor cores sum with truncation, which would bias a
      // long running sum
      float tacc[NT][4];
      auto clear = [&]() {
#pragma unroll
        for (int j = 0; j < NT; ++j) tacc[j][0] = tacc[j][1] = tacc[j][2] = tacc[j][3] = 0.f;
      };
      auto flush = [&]() {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += tacc[j][i];
      };
      if (use_local) {
        mbar_wait(bar_q, uses_q++ & 1);
        clear();
        // 1. key blocks of 8 up to the diagonal, shared round-robin by the
        // KS warps of this row tile
        const float* qa = Q_s + (16 * rt + g8) * SQ + t4;
        // two key blocks at a time when there are two: six independent chains
        for (int kb = h; kb <= 2 * rt + 1; kb += 2 * KS) {
          const int nb = kb + KS <= 2 * rt + 1 ? 2 : 1;
          // the three products of each block in their own accumulators:
          // independent chains, and the small ones summed apart from the large
          float s[2][3][4] = {};
          const float* kr = K_s + (8 * kb + g8) * SQ + t4;
          for (int x = 0; x < d; x += 8) {
            const float a[4] = {qa[x], qa[x + 8 * SQ], qa[x + 4], qa[x + 8 * SQ + 4]};
            uint32_t ahi[4], alo[4];
            split4(a, ahi, alo);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              if (u < nb) {
                const float* kru = kr + u * 8 * KS * SQ;
                const Split b0 = split(kru[x]), b1 = split(kru[x + 4]);
                mma(s[u][1], alo, b0.hi, b1.hi);
                mma(s[u][2], ahi, b0.lo, b1.lo);
                mma(s[u][0], ahi, b0.hi, b1.hi);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (u < nb) {
              float* su = s[u][0];
#pragma unroll
              for (int i = 0; i < 4; ++i) su[i] += s[u][1][i] + s[u][2][i];
              const int row = 16 * rt + g8, key = 8 * (kb + u * KS) + 2 * t4;
              const float p[4] = {key <= row ? expf(su[0] * scale) : 0.f,
                                  key + 1 <= row ? expf(su[1] * scale) : 0.f,
                                  key <= row + 8 ? expf(su[2] * scale) : 0.f,
                                  key + 1 <= row + 8 ? expf(su[3] * scale) : 0.f};
              dn[0] += p[0] + p[1];
              dn[1] += p[2] + p[3];
              // P as the A operand with keys permuted: column t -> key 2t, t+4 -> 2t+1
              const float a[4] = {p[0], p[2], p[1], p[3]};
              uint32_t ahi[4], alo[4];
              split4(a, ahi, alo);
              const float* vr = V_s + (8 * (kb + u * KS) + 2 * t4) * SV + g8;
              mma3_n<NT>(tacc, ahi, alo, vr, SV);
            }
          }
        }
        flush();
      }
      __syncthreads();  // q (and k, after the last group) are read
      if (use_local) {
        if (g + 1 < Gq) issue_q(c, g + 1);
        else if (c + 1 < n) issue_q(c + 1, 0);
      }
      if (g + 1 == Gq && c + 1 < n) {
        if (use_local) issue_k(c + 1);
        if (need_v(c + 1) && (vbufs == 2 || !fold(c))) issue_v(c + 1);
      }

      if (readout(c)) {
        // 2. num += phi_q S on the tensor cores, den += phi_q Z on the fp32
        // cores from the same operands; k-steps of each tile shared
        // round-robin by the KS warps of this row tile
        for (int mt = 0; mt < nmt; ++mt) {
          const int slot = cslot;
          mbar_wait(bar_r + slot, cphase);
          if (++cslot == stages) cslot = 0, cphase ^= 1;
          const float* F = smem + lay.ring + slot * L * SF + (16 * rt + g8) * SF + t4;
          clear();
          constexpr int NKS = MT / 8;                // k-steps of a tile
          constexpr int NI = (NKS + KS - 1) / KS;    // k-steps of a warp, at most
          // this warp's k-steps h, h + KS, ... < NKS: all NI of them when KS
          // divides NKS (every 64- and 32-column tile), else fewer
          const int ni = NKS % KS == 0 ? NI : (NKS - h + KS - 1) / KS;
          Operands<NT> op[2];
          float z[2][2];
          auto load_k = [&](int u, int i) {
            const int kk = h + i * KS;
            op[u].load(F + 8 * kk, 8 * SF, 4, S_s + (mt * MT + 8 * kk + t4) * SS + g8, 4 * SS);
            z[u][0] = Z_s[mt * MT + 8 * kk + t4];
            z[u][1] = Z_s[mt * MT + 8 * kk + t4 + 4];
          };
          if (ni > 0) load_k(0, 0);
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            if (i < ni) {
              if (i + 1 < ni) load_k((i + 1) & 1, i + 1);
              const Operands<NT>& o = op[i & 1];
              const float* zz = z[i & 1];
              dn[0] = fmaf(o.a[0], zz[0], fmaf(o.a[2], zz[1], dn[0]));
              dn[1] = fmaf(o.a[1], zz[0], fmaf(o.a[3], zz[1], dn[1]));
              uint32_t ahi[4], alo[4];
              split4(o.a, ahi, alo);
              mma3_n<NT>(tacc, ahi, alo, o.b);
            }
          }
          flush();
          __syncthreads();  // the slot is refilled next
          if (n_issued < n_phi) {
          issue_phi();
          ++n_issued;
        }
        }
      }

      // den over the quad's columns, then the KS partials of a row tile,
      // summed in a fixed order (den in the partials' column dv)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dn[i] += __shfl_xor_sync(0xffffffffu, dn[i], 1);
        dn[i] += __shfl_xor_sync(0xffffffffu, dn[i], 2);
      }
      const int row = 16 * rt + g8;
      if (KS > 1) {
        if (h > 0) {
          float* rp = red + ((h - 1) * L + row) * SS + 2 * t4;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            *reinterpret_cast<float2*>(rp + 8 * j) = make_float2(acc[j][0], acc[j][1]);
            *reinterpret_cast<float2*>(rp + 8 * SS + 8 * j) = make_float2(acc[j][2], acc[j][3]);
          }
          if (t4 == 0) {
            rp[DV] = dn[0];
            rp[8 * SS + DV] = dn[1];
          }
        }
        __syncthreads();
        if (h == 0) {
          for (int hh = 1; hh < KS; ++hh) {
            const float* rp = red + ((hh - 1) * L + row) * SS + 2 * t4;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const float2 u = *reinterpret_cast<const float2*>(rp + 8 * j);
              const float2 w = *reinterpret_cast<const float2*>(rp + 8 * SS + 8 * j);
              acc[j][0] += u.x; acc[j][1] += u.y; acc[j][2] += w.x; acc[j][3] += w.y;
            }
            dn[0] += rp[DV - 2 * t4];
            dn[1] += rp[8 * SS + DV - 2 * t4];
          }
        }
      }
      if (h == 0) {
        const size_t r0 = ((size_t)bh * Gq + g) * T + t0 + row;
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
    }

    if (fold(c)) {
      // 3. S += phi_k^T v on the tensor cores, Z += sum phi_k on the fp32
      // cores: warp w owns m-tile w % FM of each phi tile and a run of FNT
      // n-tiles; the warps of the first run also sum Z
      const int mi = warp % FM, j0 = (warp / FM) * FNT;  // n-tiles j0 .. j0 + nn - 1
      const int nn = NT - j0 < FNT ? (NT - j0 > 0 ? NT - j0 : 0) : FNT;
      for (int mt = 0; mt < nmt; ++mt) {
        const int slot = cslot;
        mbar_wait(bar_r + slot, cphase);
        if (++cslot == stages) cslot = 0, cphase ^= 1;
        const float* F = smem + lay.ring + slot * L * SF + 16 * mi + g8;
        float* sr = S_s + (mt * MT + 16 * mi + g8) * SS + 2 * t4;
        float cf[FNT][4];  // this tile's phi_k^T v, added to S with fp32 adds
#pragma unroll
        for (int u = 0; u < FNT; ++u) cf[u][0] = cf[u][1] = cf[u][2] = cf[u][3] = 0.f;
        // A = phi_k^T with keys permuted as for P v
        Operands<FNT> op[2];
        auto load_k = [&](Operands<FNT>& o, int kk) {
          o.load(F + (8 * kk + 2 * t4) * SF, 8, SF, V_s + (8 * kk + 2 * t4) * SV + g8 + 8 * j0,
                 SV, nn);
        };
        float zf[2] = {0.f, 0.f};  // Z of rows g and g + 8 of the m-tile
        load_k(op[0], 0);
#pragma unroll
        for (int kk = 0; kk < L / 8; ++kk) {
          if (kk + 1 < L / 8) load_k(op[(kk + 1) & 1], kk + 1);
          const float* a = op[kk & 1].a;
          zf[0] += a[0] + a[2];
          zf[1] += a[1] + a[3];
          uint32_t ahi[4], alo[4];
          split4(a, ahi, alo);
          mma3_n<FNT>(cf, ahi, alo, op[kk & 1].b, nn);
        }
        if (j0 == 0) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            zf[i] += __shfl_xor_sync(0xffffffffu, zf[i], 1);
            zf[i] += __shfl_xor_sync(0xffffffffu, zf[i], 2);
          }
          if (t4 == 0) {
            Z_s[mt * MT + 16 * mi + g8] += zf[0];
            Z_s[mt * MT + 16 * mi + g8 + 8] += zf[1];
          }
        }
#pragma unroll
        for (int u = 0; u < FNT; ++u) {
          const int j = j0 + u;
          if (u < nn) {
            float2* x0 = reinterpret_cast<float2*>(sr + 8 * j);
            float2* x1 = reinterpret_cast<float2*>(sr + 8 * SS + 8 * j);
            *x0 = make_float2(x0->x + cf[u][0], x0->y + cf[u][1]);
            *x1 = make_float2(x1->x + cf[u][2], x1->y + cf[u][3]);
          }
        }
        __syncthreads();  // the slot is refilled next; S is read next chunk
        if (n_issued < n_phi) {
          issue_phi();
          ++n_issued;
        }
      }
      if (vbufs == 1 && need_v(c + 1)) issue_v(c + 1);
    }
  }
}

template <int L, int DV, int MT>
int launch(const float* q, const float* k, const float* v, const float* phi_q,
           const float* phi_k, float* num, float* den, int BH, int Gq, int T, int d,
           int m, float scale, int use_local, int use_stream, cudaStream_t stream) {
  if (m % MT) return (int)cudaErrorInvalidValue;
  // the deepest staging that fits: 3 phi tiles and 2 v buffers, then fewer
  const int plans[3][2] = {{3, 2}, {2, 2}, {2, 1}};
  for (const auto& plan : plans) {
    const size_t smem = sizeof(float) * (size_t)Layout(L, d, DV, m, MT, plan[0], plan[1]).total;
    if (smem > 227 * 1024) continue;
    cudaError_t err = cudaFuncSetAttribute(
        chimera_attention_kernel<L, DV, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    chimera_attention_kernel<L, DV, MT><<<BH, kThreads, smem, stream>>>(
        q, k, v, phi_q, phi_k, num, den, Gq, T, d, m, scale, use_local, use_stream, plan[0],
        plan[1]);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// the paper's phi tile where m is a multiple of it, else the 16-column one
template <int L, int DV>
int launch_m(const float* q, const float* k, const float* v, const float* phi_q,
             const float* phi_k, float* num, float* den, int BH, int Gq, int T, int d,
             int m, float scale, int use_local, int use_stream, cudaStream_t s) {
  if (m % Tile<L>::MT == 0)
    return launch<L, DV, Tile<L>::MT>(q, k, v, phi_q, phi_k, num, den, BH, Gq, T, d, m, scale,
                                      use_local, use_stream, s);
  return launch<L, DV, Tile<L>::kGeneric>(q, k, v, phi_q, phi_k, num, den, BH, Gq, T, d, m,
                                          scale, use_local, use_stream, s);
}

template <int L>
int launch_dv(const float* q, const float* k, const float* v, const float* phi_q,
              const float* phi_k, float* num, float* den, int BH, int Gq, int T, int d,
              int dv, int m, float scale, int use_local, int use_stream, cudaStream_t s) {
  switch (dv) {
    case 16: return launch_m<L, 16>(q, k, v, phi_q, phi_k, num, den, BH, Gq, T, d, m, scale, use_local, use_stream, s);
    case 32: return launch_m<L, 32>(q, k, v, phi_q, phi_k, num, den, BH, Gq, T, d, m, scale, use_local, use_stream, s);
    case 64: return launch_m<L, 64>(q, k, v, phi_q, phi_k, num, den, BH, Gq, T, d, m, scale, use_local, use_stream, s);
    case 128: return launch_m<L, 128>(q, k, v, phi_q, phi_k, num, den, BH, Gq, T, d, m, scale, use_local, use_stream, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int chimera_attention_launch(
    const float* q, const float* k, const float* v, const float* phi_q,
    const float* phi_k, float* num, float* den, int BH, int Gq, int T, int d,
    int dv, int m, int L, float scale, int use_local, int use_stream, void* stream) {
  if (BH <= 0 || Gq <= 0 || d <= 0 || d % 8 || T <= 0 || L <= 0 || T % L || m <= 0)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, phi_q, phi_k, num, den};
  for (const void* p : ptrs)
    if ((uintptr_t)p & 15) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 16: return launch_dv<16>(q, k, v, phi_q, phi_k, num, den, BH, Gq, T, d, dv, m, scale, use_local, use_stream, s);
    case 32: return launch_dv<32>(q, k, v, phi_q, phi_k, num, den, BH, Gq, T, d, dv, m, scale, use_local, use_stream, s);
    case 64: return launch_dv<64>(q, k, v, phi_q, phi_k, num, den, BH, Gq, T, d, dv, m, scale, use_local, use_stream, s);
    case 128: return launch_dv<128>(q, k, v, phi_q, phi_k, num, den, BH, Gq, T, d, dv, m, scale, use_local, use_stream, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
