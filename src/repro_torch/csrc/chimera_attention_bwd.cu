// Backward of the chunked Chimera attention partials for Hopper (sm_90a).
//
// Replaces the backward of the JAX package's chunked Chimera op:
// repro/kernels/chimera_attention/ops.py::_bwd (:52-62), which takes
// jax.vjp of chimera_attention_partials_ref (jnp, no Pallas) inside the op's
// jax.custom_vjp and so forms dense (T, T) scores and masks for each tier.
// For the forward's partials (num, den) and their gradients g_num, g_den it
// computes, per (batch x kv-head) row and without a (T, T) tensor:
//   local tier, keys j <= i of query i's chunk of L tokens:
//     s_ij = exp(q_i.k_j / sqrt(d)),  dP_ij = g_num_i.v_j + g_den_i,
//     dS_ij = s_ij dP_ij / sqrt(d)    (unnormalized exp: no lse, no rowsum)
//     dq_i = sum_j dS_ij k_j,  dk_j = sum_{i, Gq} dS_ij q_i,
//     dv_j = sum_{i, Gq} s_ij g_num_i
//   stream tier, every key of an earlier chunk:
//     S_c, Z_c = sum over the chunks before c of phi_k^T v and phi_k (the
//       forward's carried state),  dphi_q_i = S_c g_num_i + Z_c g_den_i
//     G_c = sum over chunk c's queries (all Gq heads) of phi_q [g_num | g_den]^T,
//     R_c = sum of G over the chunks after c,
//     dphi_k_j = R_c [v_j | 1],  dv_j += R_c[:, :dv]^T phi_k_j
// with use_local / use_stream dropping a tier as the forward does.
//
// Launches, no atomics, so two runs on the same inputs give the same bits:
//   (a+b) chimera_bwd_fold_kernel: one block per (64 features of m, 64
//       columns of dv, chunk, row, which): which 0 folds chunk c < n - 1
//       into slot c + 1 of the state scratch (phi_k^T [v | 1] over its L
//       keys), which 1 folds chunk c > 0 into slot c - 1 of the reverse
//       scratch (phi_q^T [g_num | g_den] over its Gq x L queries).
//   (c) chimera_bwd_prefix_kernel (only with more than two chunks): the
//       running sums over the chunks in place, forward for the state (slot
//       c += slot c - 1) and backward for R (slot c += slot c + 1), in fp32
//       on the CUDA cores, one thread per float4 of a row's slot, as the
//       forward's chimera_prefix_kernel keeps its long running sum.
//   (d) chimera_bwd_dkdv_kernel: one block per (row, chunk, 64-key tile).
//       The stream terms first (dphi_k and the first term of dv, R_c from
//       the scratch; zero in the last chunk), then for each of the kv-head's
//       Gq query heads and each 64-query tile of the chunk at or after the
//       key tile: S^T = K Q^T and dP^T = V g_num^T, P^T and dS^T formed in
//       registers and parked in shared memory, dV += P^T g_num and dK +=
//       dS^T Q.
//   (e) chimera_bwd_dq_kernel: one block per (row, query head, chunk,
//       64-query tile), heavy tiles first: dphi_q from the state slot (zero
//       in chunk 0), then over the key tiles up to the diagonal: S, dP, dS
//       and dQ += dS K.
// Every product runs on the tensor cores in split fp32 (3xTF32, split_rn
// on both operands, split_fp32.cuh), as the forward's do: 8 warps own a 64
// x 64 output tile as 4 x 2 warp tiles of 16 x 32 (four m16n8 accumulator
// tiles a warp); each product adds into a fresh accumulator that is added to
// the running sum with fp32 adds (the tensor cores truncate when they sum).
// The reduction is staged through shared memory by 16-byte cp.async in
// slices of 32 (or, where it runs over a tile's 64 rows, 64-column blocks
// of the right operand against the parked P^T / dS^T tile), two buffers
// deep: the next step's copy is in flight during each product.  Rows sit at
// a stride of 4 mod 32 words where fragments are read along them and 8 mod
// 32 where they are read down the columns, so every fragment load hits 32
// banks.  d, dv and m are walked in slices and 64-column blocks, ragged
// ends zero-filled, so shared memory does not grow with any width or with
// T: 70.5 KB a dK/dV block, 53.5 KB a dQ block, 37.3 KB a fold block.
// Output tiles wider than the registers (d or dv above 64) are summed in
// the output rows, which the block alone owns, from the first term on: a
// read and a write of its own rows per query (or key) tile, in one fixed
// order.
//
// Bound on an H100 at Mixtral-8x7B's Chimera training shape (BH 8, Gq 4, T
// 8192, d = dv = m = 128, L 256): 66.2 GFLOP, 43.1 of them the local tier,
// 0.40 ms as 3xTF32 on the tensor cores (1.0 ms on the fp32 CUDA cores at
// 67 TFLOP/s); 0.87 GB read and written once, 0.26 ms at 3.35 TB/s.
// MiniCPM3-4B's MLA shape (BH 40, Gq 1, d 96, dv 64, m 128, L 256): 61.3
// GFLOP, 0.37 ms as 3xTF32; 1.43 GB, 0.43 ms: bytes bound it there.  This
// design issues more than that: the diagonal tiles compute their masked
// half, the dQ kernel recomputes S and dP, and the 64-wide blocks of d = 96
// compute a zero-filled half block.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py's
// check_chimera_bwd; scripts/chimera_bwd_variants.py times variants of this
// source in turns in one call): 3.88-3.95 ms at Mixtral's shape (fold 0.36,
// prefix 0.02, dK/dV 2.21, dQ 1.26 in a profiler trace), 3.16-3.20 at
// MiniCPM3-4B's, 9.7x and 7.5x the bound; the first design, every product
// fp32 on the CUDA cores (4 x 4 entries a thread, operands staged through
// registers behind block barriers), 7.34-7.42 and 5.99-6.07 in the same
// calls.  Step by step, in turns with the step before: the dK/dV and dQ
// products on the tensor cores 7.38-7.42 -> 6.06-6.10 ms, their cp.async
// pipeline -> 4.51-4.56, the folds on the tensor cores and pipelined too ->
// 3.88-3.95.  A three-buffer pipeline, and one pipeline for each query
// tile's four products, measured slower (4.41-4.67 ms), with 207-222
// registers a dK/dV thread.  Registers: dK/dV 182 at dv 128 (one block an
// SM), 126-128 below; dQ 128 (4 B spilled); fold 80-95; prefix 32.
//
// Contract (all float32, contiguous; BH = batch * kv-heads):
//   q (BH,Gq,T,d) k (BH,T,d) v (BH,T,dv) phi_q (BH,Gq,T,m) phi_k (BH,T,m)
//   g_num (BH,Gq,T,dv) g_den (BH,Gq,T) -> dq, dk, dv, dphi_q, dphi_k of the
//   inputs' shapes, written in full
//   state, rstate (BH,T/L,m,dv+8) scratch, 16-byte aligned (unused unless
//     use_stream and T > L): slot c row f holds S_c[f, :dv] and Z_c[f] at
//     column dv (state), R_c likewise (rstate)
// Takes what the forward takes: L in {16, 32, 64, 128, 256}, T % L == 0,
// dv in {16, 32, 64, 128}, d % 8 == 0, m % 16 == 0, any Gq, use_local and
// use_stream in every combination; anything else is cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_fp32.cuh"

namespace {

using namespace split_fp32;

constexpr int kThreads = 256;  // 8 warps: a 64 x 64 output tile as 4 x 2 warp tiles of 16 x 32
constexpr int kTile = 64;      // rows of a query or key tile, columns of an output tile
constexpr int kSlice = 32;     // reduction width of a staged slice
constexpr int kSS = kSlice + 4;  // row stride of a staged slice (4 mod 32: read along its rows)
constexpr int kST = kTile + 4;   // row stride of the parked P^T, dS^T (or dS) tiles (4 mod 32)
constexpr int kSB = kTile + 8;   // row stride of a staged 64-column block (8 mod 32: read along its columns)
constexpr int kFoldRows = 32;    // rows a fold block stages at a time
constexpr int kPrefixThreads = 256;
constexpr size_t kSmemLimit = 227 * 1024;

// The thread's entries of a 64 x 64 output tile: warp w owns rows 16 (w %
// 4) .. + 15 and columns 32 (w / 4) .. + 31 as four m16n8 accumulator tiles
// (split_fp32.cuh's layout); entry [a][b] is n-tile a's c_b, at row g (+ 8
// for b >= 2) and column 8 a + 2 t (+ 1 for odd b), g = lane / 4, t = lane % 4.
struct Lane {
  int rb, cb, g, t;
  __device__ explicit Lane(int tid)
      : rb(16 * ((tid >> 5) & 3)), cb(32 * (tid >> 7)), g((tid & 31) >> 2), t(tid & 3) {}
  __device__ int row(int, int b) const { return rb + g + 8 * (b >> 1); }
  __device__ int col(int a, int b) const { return cb + 8 * a + 2 * t + (b & 1); }
};

// acc[a][b] += sum_{x < K} A(row, x) B(col, x) for the thread's entries,
// A(r, x) = A[r ar + x ak] and B(c, x) = B[c bc + x bk], as split fp32
// (3xTF32, split_rn on both operands) on the tensor cores, into a fresh
// accumulator that is then added to acc with fp32 adds (the tensor cores
// truncate when they sum).  Fragment loads hit 32 banks where a row-major
// operand's row stride is 4 mod 32 (ak or bk 1) and a transposed one's 8
// mod 32 (ak or bk the stride).
template <int K>
__device__ __forceinline__ void tile_mma(float (&acc)[4][4], const float* A, int ar, int ak,
                                         const float* B, int bc, int bk, const Lane& ln) {
  const float* pa = A + (ln.rb + ln.g) * ar + ln.t * ak;
  const float* pb = B + (ln.cb + ln.g) * bc + ln.t * bk;
  float c[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll 2
  for (int x = 0; x < K; x += 8) {
    const float a[4] = {pa[x * ak], pa[8 * ar + x * ak], pa[(x + 4) * ak],
                        pa[8 * ar + (x + 4) * ak]};
    uint32_t ahi[4], alo[4];
    split4<true>(a, ahi, alo);
    float bv[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j][0] = pb[8 * j * bc + x * bk];
      bv[j][1] = pb[8 * j * bc + (x + 4) * bk];
    }
    mma3_n<4, true>(c, ahi, alo, bv);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += c[j][e];
}

template <int NA, int NB>
__device__ __forceinline__ void zero(float (&acc)[NA][NB]) {
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x COLS floats into shared rows of stride ss from global rows of
// stride gs (src points at the first row's first column), by 16-byte
// cp.async (rows of src and dst 16-byte aligned, nc a multiple of 4); rows
// >= nr and columns >= nc are zero-filled by plain stores; the caller
// commits the group
template <int COLS>
__device__ __forceinline__ void stage_async(float* dst, int ss, const float* src, size_t gs,
                                            int rows, int nr, int nc) {
  constexpr int C4 = COLS / 4;
  for (int x = threadIdx.x; x < rows * C4; x += kThreads) {
    const int r = x / C4, c = 4 * (x % C4);
    float* d = dst + r * ss + c;
    if (r < nr && c < nc)
      cp16(d, src + (size_t)r * gs + c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ns steps of staged products, step s's operands staged into buffer s % 2
// by issue(s, buffer) while step s - 1's product(buffer, s) runs: the copy
// of the next step is in flight during each product, and every buffer is
// refilled only after the barrier that ends its last product
template <class Issue, class Product>
__device__ __forceinline__ void pipelined(int ns, Issue issue, Product product) {
  issue(0, 0);
  cp_commit();
  for (int st = 0; st < ns; ++st) {
    if (st + 1 < ns) {
      issue(st + 1, (st + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // step st landed
    product(st & 1, st);
    __syncthreads();  // every warp is done with buffer st % 2
  }
}

// ---- (a+b) the per-chunk folds ------------------------------------------------
// Block (features [f0, f0 + 64) of m, columns [e0, e0 + 64) of dv, fold
// chunk cc, row bh, which): out[f][e] = sum_r A[r][f] B[r][e] over the fold's
// rows, 32 at a time through the two-buffer pipeline, on the tensor cores
// (tile_mma, both operands read down their columns); the e0 = 0 blocks
// also sum the Z (or g_den) column on the fp32 cores, each thread a feature
// over a quarter of the rows.  L is a power of two: fold row rr is head
// rr >> lg, token rr & (L - 1).
template <int DV>
__global__ void __launch_bounds__(kThreads) chimera_bwd_fold_kernel(
    const float* __restrict__ phi_k, const float* __restrict__ v, const float* __restrict__ phi_q,
    const float* __restrict__ gnum, const float* __restrict__ gden, float* __restrict__ state,
    float* __restrict__ rstate, int Gq, int T, int m, int L, int lg) {
  constexpr int SW = DV + 8;
  constexpr int TILE = kFoldRows * kSB;  // one staged 32-row operand
  __shared__ __align__(16) float fs[2 * 2 * TILE];  // buffer b: A at 2 b TILE, B after it
  __shared__ float xs[2][kFoldRows];
  __shared__ float zpart[kThreads];
  const int n = T / L, nfb = (m + kTile - 1) / kTile, neb = (DV + kTile - 1) / kTile;
  int x = blockIdx.x;
  const int fb = x % nfb;
  x /= nfb;
  const int e0 = (x % neb) * kTile, cc = x / neb, bh = blockIdx.y;
  const bool rev = blockIdx.z == 1, zcol = e0 == 0;
  const int tid = threadIdx.x;
  const Lane ln(tid);
  const int f0 = fb * kTile;
  const int groups = rev ? Gq : 1, c = rev ? cc + 1 : cc;
  const float* A = rev ? phi_q : phi_k;
  const float* Bm = (rev ? gnum : v) + e0;
  float* out = (rev ? rstate : state) + ((size_t)bh * n + (rev ? c - 1 : c + 1)) * m * SW;
  const int R = groups << lg;
  auto grow = [&](int rr) {  // the global row of fold row rr
    return ((size_t)bh * groups + (rr >> lg)) * T + (size_t)c * L + (rr & (L - 1));
  };

  float acc[4][4], z = 0.f;
  zero(acc);
  const int zf = tid & (kTile - 1), zq = tid >> 6;  // Z: feature zf over rows zq, zq + 4, ...
  pipelined(
      (R + kFoldRows - 1) / kFoldRows,
      [&](int st, int b) {
        const int r0 = st * kFoldRows;
        float* As = fs + 2 * b * TILE;
        for (int i = tid; i < kFoldRows * (kTile / 4); i += kThreads) {
          const int r = i / (kTile / 4), col = 4 * (i % (kTile / 4));
          const bool in = r0 + r < R;
          const size_t row = in ? grow(r0 + r) : 0;
          float* da = As + r * kSB + col;
          float* db = As + TILE + r * kSB + col;
          if (in && f0 + col < m)
            cp16(da, A + row * m + f0 + col);
          else
            *reinterpret_cast<float4*>(da) = make_float4(0.f, 0.f, 0.f, 0.f);
          if (in && e0 + col < DV)
            cp16(db, Bm + row * DV + col);
          else
            *reinterpret_cast<float4*>(db) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        if (tid < kFoldRows)
          xs[b][tid] = r0 + tid < R ? (rev ? gden[grow(r0 + tid)] : 1.f) : 0.f;
      },
      [&](int b, int) {
        const float* As = fs + 2 * b * TILE;
        tile_mma<kFoldRows>(acc, As, 1, kSB, As + TILE, 1, kSB, ln);
        if (zcol) {
#pragma unroll
          for (int r = zq; r < kFoldRows; r += 4) z = fmaf(As[r * kSB + zf], xs[b][r], z);
        }
      });
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int f = f0 + ln.row(a, b), e = e0 + ln.col(a, b);
      if (f < m && e < DV) out[(size_t)f * SW + e] = acc[a][b];
    }
  }
  if (zcol) {
    zpart[tid] = z;
    __syncthreads();
    if (tid < kTile && f0 + tid < m)
      out[(size_t)(f0 + tid) * SW + DV] =
          (zpart[tid] + zpart[tid + kTile]) + (zpart[tid + 2 * kTile] + zpart[tid + 3 * kTile]);
  }
}

// ---- (c) the running sums over the chunks ---------------------------------------
// Thread x owns float4 e of every slot of one row of one scratch (row4
// float4s a slot): state slot c += slot c - 1 for c = 2 .. n - 1, rstate
// slot c += slot c + 1 for c = n - 3 .. 0, in that order.
__global__ void __launch_bounds__(kPrefixThreads) chimera_bwd_prefix_kernel(
    float* __restrict__ state, float* __restrict__ rstate, int BH, int n, int row4) {
  const size_t per = (size_t)BH * row4;
  size_t x = (size_t)blockIdx.x * kPrefixThreads + threadIdx.x;
  if (x >= 2 * per) return;
  const bool rev = x >= per;
  if (rev) x -= per;
  float4* p = reinterpret_cast<float4*>(rev ? rstate : state) + (x / row4) * n * row4 + x % row4;
  if (!rev) {
    float4 s = p[row4];
    for (int c = 2; c < n; ++c) {
      const float4 y = p[(size_t)c * row4];
      s.x += y.x; s.y += y.y; s.z += y.z; s.w += y.w;
      p[(size_t)c * row4] = s;
    }
  } else {
    float4 s = p[(size_t)(n - 2) * row4];
    for (int c = n - 3; c >= 0; --c) {
      const float4 y = p[(size_t)c * row4];
      s.x += y.x; s.y += y.y; s.z += y.z; s.w += y.w;
      p[(size_t)c * row4] = s;
    }
  }
}

// shared memory of the dK/dV and dQ kernels, in floats: two staged slices
// X and Y (or one 64-column block spanning them), the parked tiles, and 2 x
// 64 per-row values
constexpr int kBuf = 2 * kTile * kSS;  // one staging buffer: slices X, Y or one 64-column block
constexpr int kSlices = 2 * kBuf;       // two buffers
constexpr int kDkdvSmem = kSlices + 2 * kTile * kST + 2 * kTile;
constexpr int kDqSmem = kSlices + kTile * kST + 2 * kTile;
static_assert(kBuf >= kTile * kSB, "a 64-column block fits a buffer");

// ---- (d) dK, dV and dphi_k ---------------------------------------------------------
template <int DV>
__global__ void __launch_bounds__(kThreads) chimera_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ phi_k, const float* __restrict__ gnum, const float* __restrict__ gden,
    const float* __restrict__ rstate, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dphik, int Gq, int T, int d, int m, int L, float scale, int use_local,
    int use_stream) {
  constexpr int SW = DV + 8;
  extern __shared__ __align__(16) float smem[];
  // staging buffer b: slices X(b), Y(b), or a 64-column block at X(b)
  auto X = [&](int b) { return smem + b * kBuf; };
  auto Y = [&](int b) { return smem + b * kBuf + kTile * kSS; };
  float* PT = smem + kSlices;  // P^T (keys x queries)
  float* DT = PT + kTile * kST;  // dS^T
  float* rowv = DT + kTile * kST;  // 64 per-row values: R_c's Z column, or g_den of the query tile

  const int n = T / L, nt = (L + kTile - 1) / kTile;
  int x = blockIdx.x;
  const int kt = x % nt;
  x /= nt;
  const int c = x % n, bh = x / n;
  const int tid = threadIdx.x;
  const Lane ln(tid);
  const int j0 = kt * kTile, nj = imin(kTile, L - j0);
  const size_t krow = (size_t)bh * T + (size_t)c * L + j0;  // the tile's first key
  const bool stream = use_stream && c + 1 < n;
  const float* Rc = rstate + ((size_t)bh * n + c) * m * SW;
  float acc[4][4];
  auto slices = [&](int width) { return (width + kSlice - 1) / kSlice; };
  auto blocks = [&](int width) { return (width + kTile - 1) / kTile; };

  // dphi_k = R_c [v | 1], 64 features at a time
  for (int f0 = 0; f0 < m; f0 += kTile) {
    zero(acc);
    if (stream) {
      if (tid < kTile) rowv[tid] = f0 + tid < m ? Rc[(size_t)(f0 + tid) * SW + DV] : 0.f;
      pipelined(
          slices(DV),
          [&](int st, int b) {
            const int e0 = st * kSlice;
            stage_async<kSlice>(X(b), kSS, v + krow * DV + e0, DV, kTile, nj, DV - e0);
            stage_async<kSlice>(Y(b), kSS, Rc + (size_t)f0 * SW + e0, SW, kTile, m - f0, DV - e0);
          },
          [&](int b, int) { tile_mma<kSlice>(acc, X(b), kSS, 1, Y(b), kSS, 1, ln); });
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = ln.row(a, b), f = f0 + ln.col(a, b);
        if (j < nj && f < m)
          dphik[(krow + j) * m + f] = stream ? acc[a][b] + rowv[ln.col(a, b)] : 0.f;
      }
    }
    __syncthreads();  // rowv is rewritten next
  }

  // dv = R_c[:, :dv]^T phi_k, the first term of dv, 64 columns at a time
  for (int e0 = 0; e0 < DV; e0 += kTile) {
    zero(acc);
    if (stream) {
      pipelined(
          slices(m),
          [&](int st, int b) {
            const int f0 = st * kSlice;
            stage_async<kSlice>(X(b), kSS, phi_k + krow * m + f0, m, kTile, nj, m - f0);
            stage_async<kTile>(Y(b), kSB, Rc + (size_t)f0 * SW + e0, SW, kSlice, m - f0,
                               DV - e0);
          },
          [&](int b, int) { tile_mma<kSlice>(acc, X(b), kSS, 1, Y(b), 1, kSB, ln); });
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = ln.row(a, b), e = e0 + ln.col(a, b);
        if (j < nj && e < DV) dv[(krow + j) * DV + e] = acc[a][b];
      }
    }
  }

  if (!use_local) {
    for (int i = tid; i < nj * d; i += kThreads) dk[krow * d + i] = 0.f;
    return;
  }
  // the local tier: every query head, every query tile at or after the key tile
  bool first = true;
  for (int g = 0; g < Gq; ++g) {
    for (int qt = kt; qt < nt; ++qt) {
      const int i0 = qt * kTile, ni = imin(kTile, L - i0);
      const size_t qrow = ((size_t)bh * Gq + g) * T + (size_t)c * L + i0;
      float s[4][4], p[4][4];
      zero(s);
      zero(p);
      if (tid < kTile) rowv[tid] = tid < ni ? gden[qrow + tid] : 0.f;
      // S^T = K Q^T over d, then dP^T = V g_num^T over dv, one pipeline
      const int ns = slices(d);
      pipelined(
          ns + slices(DV),
          [&](int st, int b) {
            if (st < ns) {
              const int e0 = st * kSlice;
              stage_async<kSlice>(X(b), kSS, k + krow * d + e0, d, kTile, nj, d - e0);
              stage_async<kSlice>(Y(b), kSS, q + qrow * d + e0, d, kTile, ni, d - e0);
            } else {
              const int e0 = (st - ns) * kSlice;
              stage_async<kSlice>(X(b), kSS, v + krow * DV + e0, DV, kTile, nj, DV - e0);
              stage_async<kSlice>(Y(b), kSS, gnum + qrow * DV + e0, DV, kTile, ni, DV - e0);
            }
          },
          [&](int b, int st) {
            if (st < ns)
              tile_mma<kSlice>(s, X(b), kSS, 1, Y(b), kSS, 1, ln);
            else
              tile_mma<kSlice>(p, X(b), kSS, 1, Y(b), kSS, 1, ln);
          });
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = j0 + ln.row(a, b), i = i0 + ln.col(a, b);
          const float e = (i < L && j <= i) ? expf(s[a][b] * scale) : 0.f;
          PT[ln.row(a, b) * kST + ln.col(a, b)] = e;
          DT[ln.row(a, b) * kST + ln.col(a, b)] = e * (p[a][b] + rowv[ln.col(a, b)]) * scale;
        }
      }
      // the tiles P^T and dS^T are read after the pipeline's first barrier
      // dV += P^T g_num over dv's 64-column blocks, then dK += dS^T Q over d's
      const int nb = blocks(DV);
      pipelined(
          nb + blocks(d),
          [&](int st, int b) {
            if (st < nb)
              stage_async<kTile>(X(b), kSB, gnum + qrow * DV + st * kTile, DV, kTile, ni,
                                 DV - st * kTile);
            else
              stage_async<kTile>(X(b), kSB, q + qrow * d + (st - nb) * kTile, d, kTile, ni,
                                 d - (st - nb) * kTile);
          },
          [&](int b, int st) {
            zero(acc);
            tile_mma<kTile>(acc, st < nb ? PT : DT, kST, 1, X(b), 1, kSB, ln);
            const bool to_dv = st < nb;
            const int e0 = (to_dv ? st : st - nb) * kTile, width = to_dv ? DV : d;
            float* out = to_dv ? dv + krow * DV : dk + krow * d;
#pragma unroll
            for (int a = 0; a < 4; ++a) {
#pragma unroll
              for (int bb = 0; bb < 4; ++bb) {
                const int j = ln.row(a, bb), e = e0 + ln.col(a, bb);
                if (j < nj && e < width) {
                  float* o = out + (size_t)j * width + e;
                  *o = (first && !to_dv) ? acc[a][bb] : *o + acc[a][bb];
                }
              }
            }
          });
      first = false;
    }
  }
}

// ---- (e) dQ and dphi_q --------------------------------------------------------------
template <int DV>
__global__ void __launch_bounds__(kThreads) chimera_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ gnum, const float* __restrict__ gden,
    const float* __restrict__ state, float* __restrict__ dq, float* __restrict__ dphiq, int Gq,
    int T, int d, int m, int L, float scale, int use_local, int use_stream) {
  constexpr int SW = DV + 8;
  extern __shared__ __align__(16) float smem[];
  auto X = [&](int b) { return smem + b * kBuf; };
  auto Y = [&](int b) { return smem + b * kBuf + kTile * kSS; };
  float* DS = smem + kSlices;  // dS (queries x keys)
  float* gd = DS + kTile * kST;  // g_den of the query tile
  float* zc = gd + kTile;  // Z_c of a 64-feature block

  const int n = T / L, nt = (L + kTile - 1) / kTile;
  int x = blockIdx.x;
  const int qt = nt - 1 - x % nt;  // the causally heavier tiles first
  x /= nt;
  const int g = x % Gq;
  x /= Gq;
  const int c = x % n, bh = x / n;
  const int tid = threadIdx.x;
  const Lane ln(tid);
  const int i0 = qt * kTile, ni = imin(kTile, L - i0);
  const size_t qrow = ((size_t)bh * Gq + g) * T + (size_t)c * L + i0;  // the tile's first query
  const bool stream = use_stream && c > 0;
  const float* Sc = state + ((size_t)bh * n + c) * m * SW;
  if (tid < kTile) gd[tid] = tid < ni ? gden[qrow + tid] : 0.f;
  float acc[4][4];
  auto slices = [&](int width) { return (width + kSlice - 1) / kSlice; };

  // dphi_q = g_num S_c^T + g_den Z_c, 64 features at a time
  for (int f0 = 0; f0 < m; f0 += kTile) {
    zero(acc);
    if (stream) {
      if (tid < kTile) zc[tid] = f0 + tid < m ? Sc[(size_t)(f0 + tid) * SW + DV] : 0.f;
      pipelined(
          slices(DV),
          [&](int st, int b) {
            const int e0 = st * kSlice;
            stage_async<kSlice>(X(b), kSS, gnum + qrow * DV + e0, DV, kTile, ni, DV - e0);
            stage_async<kSlice>(Y(b), kSS, Sc + (size_t)f0 * SW + e0, SW, kTile, m - f0, DV - e0);
          },
          [&](int b, int) { tile_mma<kSlice>(acc, X(b), kSS, 1, Y(b), kSS, 1, ln); });
    } else {
      __syncthreads();  // gd landed
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = ln.row(a, b), f = f0 + ln.col(a, b);
        if (i < ni && f < m)
          dphiq[(qrow + i) * m + f] = stream ? fmaf(gd[i], zc[ln.col(a, b)], acc[a][b]) : 0.f;
      }
    }
    __syncthreads();  // zc is rewritten next
  }

  if (!use_local) {
    for (int i = tid; i < ni * d; i += kThreads) dq[qrow * d + i] = 0.f;
    return;
  }
  // the local tier: the key tiles up to the diagonal
  for (int kt = 0; kt <= qt; ++kt) {
    const int j0 = kt * kTile, nj = imin(kTile, L - j0);
    const size_t krow = (size_t)bh * T + (size_t)c * L + j0;
    float s[4][4], p[4][4];
    zero(s);
    zero(p);
    // S = Q K^T over d, then dP = g_num V^T over dv, one pipeline
    const int ns = slices(d);
    pipelined(
        ns + slices(DV),
        [&](int st, int b) {
          if (st < ns) {
            const int e0 = st * kSlice;
            stage_async<kSlice>(X(b), kSS, q + qrow * d + e0, d, kTile, ni, d - e0);
            stage_async<kSlice>(Y(b), kSS, k + krow * d + e0, d, kTile, nj, d - e0);
          } else {
            const int e0 = (st - ns) * kSlice;
            stage_async<kSlice>(X(b), kSS, gnum + qrow * DV + e0, DV, kTile, ni, DV - e0);
            stage_async<kSlice>(Y(b), kSS, v + krow * DV + e0, DV, kTile, nj, DV - e0);
          }
        },
        [&](int b, int st) {
          if (st < ns)
            tile_mma<kSlice>(s, X(b), kSS, 1, Y(b), kSS, 1, ln);
          else
            tile_mma<kSlice>(p, X(b), kSS, 1, Y(b), kSS, 1, ln);
        });
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = i0 + ln.row(a, b), j = j0 + ln.col(a, b);
        const float e = (i < L && j <= i) ? expf(s[a][b] * scale) : 0.f;
        DS[ln.row(a, b) * kST + ln.col(a, b)] = e * (p[a][b] + gd[ln.row(a, b)]) * scale;
      }
    }
    // dQ += dS K over d's 64-column blocks (dS is read after the pipeline's first barrier)
    pipelined(
        (d + kTile - 1) / kTile,
        [&](int st, int b) {
          stage_async<kTile>(X(b), kSB, k + krow * d + st * kTile, d, kTile, nj, d - st * kTile);
        },
        [&](int b, int st) {
          zero(acc);
          tile_mma<kTile>(acc, DS, kST, 1, X(b), 1, kSB, ln);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) {
              const int i = ln.row(a, bb), e = st * kTile + ln.col(a, bb);
              if (i < ni && e < d) {
                float* o = dq + (qrow + i) * d + e;
                *o = kt == 0 ? acc[a][bb] : *o + acc[a][bb];
              }
            }
          }
        });
  }
}

template <int DV>
int launch(const float* q, const float* k, const float* v, const float* phi_q, const float* phi_k,
           const float* gnum, const float* gden, float* dq, float* dk, float* dv, float* dphiq,
           float* dphik, float* state, float* rstate, int BH, int Gq, int T, int d, int m, int L,
           float scale, int use_local, int use_stream, cudaStream_t stream) {
  const int n = T / L, nt = (L + kTile - 1) / kTile;
  const size_t dkdv_blocks = (size_t)BH * n * nt, dq_blocks = dkdv_blocks * Gq;
  if (dq_blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const bool carried = use_stream && n > 1;
  if (carried) {
    if (state == nullptr || rstate == nullptr || ((uintptr_t)state & 15) ||
        ((uintptr_t)rstate & 15) || BH > 65535)
      return (int)cudaErrorInvalidValue;
    const int nfb = (m + kTile - 1) / kTile, neb = (DV + kTile - 1) / kTile;
    const size_t fold_blocks = (size_t)nfb * neb * (n - 1);
    if (fold_blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    int lg = 0;
    while ((1 << lg) < L) ++lg;
    chimera_bwd_fold_kernel<DV><<<dim3((unsigned)fold_blocks, BH, 2), kThreads, 0, stream>>>(
        phi_k, v, phi_q, gnum, gden, state, rstate, Gq, T, m, L, lg);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (n > 2) {
      const int row4 = m * (DV + 8) / 4;
      const size_t threads = 2 * (size_t)BH * row4;
      chimera_bwd_prefix_kernel<<<(unsigned)((threads + kPrefixThreads - 1) / kPrefixThreads),
                                  kPrefixThreads, 0, stream>>>(state, rstate, BH, n, row4);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  const size_t dkdv_smem = sizeof(float) * kDkdvSmem, dq_smem = sizeof(float) * kDqSmem;
  static_assert(sizeof(float) * kDkdvSmem <= kSmemLimit, "dK/dV shared memory");
  cudaError_t err = cudaFuncSetAttribute(chimera_bwd_dkdv_kernel<DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dkdv_smem);
  if (err != cudaSuccess) return (int)err;
  chimera_bwd_dkdv_kernel<DV><<<(unsigned)dkdv_blocks, kThreads, dkdv_smem, stream>>>(
      q, k, v, phi_k, gnum, gden, rstate, dk, dv, dphik, Gq, T, d, m, L, scale, use_local,
      carried ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(chimera_bwd_dq_kernel<DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return (int)err;
  chimera_bwd_dq_kernel<DV><<<(unsigned)dq_blocks, kThreads, dq_smem, stream>>>(
      q, k, v, gnum, gden, state, dq, dphiq, Gq, T, d, m, L, scale, use_local, carried ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int chimera_attention_bwd_launch(
    const float* q, const float* k, const float* v, const float* phi_q, const float* phi_k,
    const float* g_num, const float* g_den, float* dq, float* dk, float* dv, float* dphi_q,
    float* dphi_k, float* state, float* rstate, int BH, int Gq, int T, int d, int dvw, int m,
    int L, float scale, int use_local, int use_stream, void* stream) {
  const bool chunk_ok = L == 16 || L == 32 || L == 64 || L == 128 || L == 256;
  if (BH <= 0 || Gq <= 0 || T <= 0 || !chunk_ok || T % L != 0 || d <= 0 || d % 8 != 0 ||
      m <= 0 || m % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const void* ins[] = {q, k, v, phi_q, phi_k, g_num, g_den};  // read by 16-byte cp.async
  for (const void* p : ins)
    if (p == nullptr || ((uintptr_t)p & 15)) return (int)cudaErrorInvalidValue;
  const void* outs[] = {dq, dk, dv, dphi_q, dphi_k};
  for (const void* p : outs)
    if (p == nullptr || ((uintptr_t)p & 3)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dvw) {
    case 16: return launch<16>(q, k, v, phi_q, phi_k, g_num, g_den, dq, dk, dv, dphi_q, dphi_k, state, rstate, BH, Gq, T, d, m, L, scale, use_local, use_stream, s);
    case 32: return launch<32>(q, k, v, phi_q, phi_k, g_num, g_den, dq, dk, dv, dphi_q, dphi_k, state, rstate, BH, Gq, T, d, m, L, scale, use_local, use_stream, s);
    case 64: return launch<64>(q, k, v, phi_q, phi_k, g_num, g_den, dq, dk, dv, dphi_q, dphi_k, state, rstate, BH, Gq, T, d, m, L, scale, use_local, use_stream, s);
    case 128: return launch<128>(q, k, v, phi_q, phi_k, g_num, g_den, dq, dk, dv, dphi_q, dphi_k, state, rstate, BH, Gq, T, d, m, L, scale, use_local, use_stream, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
