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
// with use_local / use_stream dropping a tier as the forward does.  No
// atomics anywhere: two runs on the same inputs give the same bits.
//
// Two routes, by the inputs' types:
//
// The bf16 route (chimera_attention_bwd_bf16_launch; namespace wg): q, k, v,
// phi_q, phi_k and g_num bf16, g_den fp32, as a bf16 model's training step
// passes them (all seven in bf16; the wrapper widens g_den).  Every product
// of the local and stream tiers and of the folds runs as bf16
// wgmma.mma_async m64nNk16 with fp32 accumulators, operands copied by TMA
// (128-byte swizzled tiles, hopper.cuh) and completed on mbarriers:
//   * an input enters as one term; a value formed in fp32 (P and dS in
//     registers, the state S_c and R_c) as two bf16 terms, hi = bf16(x) and
//     lo = bf16(x - hi), about 16 bits of x.  One term alone errs by 2^-9 of
//     each entry, 115-197x the tolerance chip_smoke.py holds the backward to
//     (1e-5 x max|ref| + 1e-4 x |ref| against float64); the two terms stay
//     within 0.18-0.28 of it in tests/test_torch_chimera_training.py's model
//     of this split (bf16 terms, float64 products), and a third term would
//     buy nothing that tolerance asks for.
//   * Where a state is carried: (a) chimera_bwd_wgmma_fold_kernel, per (pair
//     of 64-feature blocks, chunk, row, which) of two warpgroups, the folds
//     S = phi_k^T [v | 1] and R = phi_q^T [g_num | g_den] on wgmma, phi^T
//     and v or g_num by TMA, phi^T as the MN-major (transposed) A;
//     chimera_bwd_wgmma_prefix_kernel, the running sums as the fp32 route's
//     prefix, writing every slot the stream tier reads as bf16 hi and lo and
//     its Z column apart.
//   * (b) chimera_bwd_wgmma_stream_kernel: one warpgroup per 64-row tile of
//     keys (dphi_k, and dv's stream term into dv, phi_k as register A) or of
//     queries (dphi_q), the tile's operand resident, the state's 64-feature
//     blocks by TMA one at a time.
//   * (c) chimera_bwd_wgmma_dkdv_kernel: one block per (row, chunk, pair of
//     64-key tiles, 128-column slice of d), three warpgroups: two consumers
//     each own a key tile, its K and V resident in shared memory (loaded
//     once) and its dK and dV in registers for the whole walk; a producer
//     warp streams Q, g_num and g_den of every query head's tiles through a
//     ring of TMA stages (as many as fit, up to 4) behind full/empty
//     mbarriers, setmaxnreg moving registers from it to the consumers (24
//     and 240 a thread).  Per query tile: S^T = K Q^T and dP^T = V g^T from
//     shared memory, P^T and dS^T masked and split in registers, then dV +=
//     P^T g and dK += dS^T Q with P^T and dS^T as wgmma's register A and g
//     and Q read MN-major (transposed) from the same tiles, one product's
//     fragments live at a time.
//   * (d) chimera_bwd_wgmma_dq_kernel: the same shape over (row, query head,
//     chunk, pair of 64-query tiles, slice of d): Q, g_num and g_den
//     resident, K and V streamed up to the diagonal, S and dP recomputed,
//     dQ += dS K in registers, written once.
//   Below L 64 a tile is the chunk's L rows (S^T and S as n16 wgmma), and
//   one consumer works; d above 128 is taken in slices of 128 columns, each
//   a block that recomputes S and dP.
//
// The fp32 route (chimera_attention_bwd_launch; namespace fp), the first
// tensor-core design, unchanged: fp32 inputs, every input widened to fp32
// where one of the first six is not bf16 (the classifier, lm_100m, the fp32
// checks),
// every product split fp32 (3xTF32, split_rn on both operands,
// split_fp32.cuh) through mma.sync:
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
// 8 warps own a 64 x 64 output tile as 4 x 2 warp tiles of 16 x 32 (four
// m16n8 accumulator tiles a warp); each product adds into a fresh
// accumulator that is added to the running sum with fp32 adds (the tensor
// cores truncate when they sum).  The reduction is staged through shared
// memory by 16-byte cp.async in slices of 32 (or, where it runs over a
// tile's 64 rows, 64-column blocks of the right operand against the parked
// P^T / dS^T tile), two buffers deep: the next step's copy is in flight
// during each product.  Rows sit at a stride of 4 mod 32 words where
// fragments are read along them and 8 mod 32 where they are read down the
// columns, so every fragment load hits 32 banks.  d, dv and m are walked in
// slices and 64-column blocks, ragged ends zero-filled, so shared memory
// does not grow with any width or with T: 70.5 KB a dK/dV block, 53.5 KB a
// dQ block, 37.3 KB a fold block.  Output tiles wider than the registers (d
// or dv above 64) are summed in the output rows, which the block alone
// owns, from the first term on: a read and a write of its own rows per
// query (or key) tile, in one fixed order.  Measured on an H100 80GB HBM3
// at 700 W: 3.88-3.95 ms at Mixtral-8x7B's Chimera training shape (fold
// 0.36, prefix 0.02, dK/dV 2.21, dQ 1.26 in a profiler trace), 3.16-3.20 at
// MiniCPM3-4B's.  Registers: dK/dV 182 at dv 128 (one block an SM), 126-128
// below; dQ 128 (4 B spilled); fold 80-95; prefix 32.
//
// Bound on an H100 at Mixtral-8x7B's Chimera training shape (BH 8, Gq 4, T
// 8192, d = dv = m = 128, L 256), the training step's types (all seven
// inputs bf16, the gradients fp32): 621,281,280 B read and written once,
// 0.1855 ms at 3.35 TB/s; 66.16 GFLOP, 0.0669 ms as one bf16 pass at 989
// TFLOP/s: bytes bound it.  MiniCPM3-4B's MLA shape (BH 40, Gq 1, d 96, dv
// 64, m 128, L 256): 1,049,231,360 B, 0.3132 ms; 61.36 GFLOP, 0.0620 ms.
// The bf16 route issues more than one pass: the split values' two terms,
// the masked half of the diagonal tiles, S and dP recomputed by the dQ
// kernel.
//
// Contract (contiguous, 16-byte aligned; BH = batch * kv-heads):
//   q (BH,Gq,T,d) k (BH,T,d) v (BH,T,dv) phi_q (BH,Gq,T,m) phi_k (BH,T,m)
//   g_num (BH,Gq,T,dv): fp32 (fp32 route) or bf16 (bf16 route); g_den
//   (BH,Gq,T) fp32 -> dq, dk, dv, dphi_q, dphi_k fp32 of the inputs' shapes
//   fp32 route: state, rstate (BH,T/L,m,dv+8) scratch (unused unless
//     use_stream and T > L): slot c row f holds S_c[f, :dv] and Z_c[f] at
//     column dv (state), R_c likewise (rstate)
//   bf16 route: one scratch of chimera_attention_bwd_bf16_scratch bytes
//     (wg::Scratch); dq and dk zeros from the caller without use_local
// Takes what the forward takes: L in {16, 32, 64, 128, 256}, T % L == 0,
// dv in {16, 32, 64, 128}, d % 8 == 0, m % 16 == 0, any Gq, use_local and
// use_stream in every combination; anything else is cudaErrorInvalidValue.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"
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

// ============================================================================
// The fp32 route (the first tensor-core design, unchanged)
// ============================================================================
namespace fp {

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

}  // namespace fp

// ============================================================================
// The bf16 route: bf16 inputs, on wgmma and TMA
// ============================================================================
namespace wg {

using namespace hopper;

constexpr int kWG = 128;                   // threads of a warpgroup
constexpr int kConsumers = 2;              // warpgroups that compute (64 rows each)
constexpr int kThreads = kWG * (kConsumers + 1);  // and one producer warpgroup
constexpr int kUp = 240, kDown = 24;       // registers a thread after setmaxnreg
constexpr int kMaxStages = 4;
constexpr uint32_t kSmemLimit = 227 * 1024;

// the widths and the walk, fixed by the launcher for all of a call's kernels
struct Dims {
  int BH, Gq, T, d, dv, m, L, n;
  int TR;   // rows of a tile: 64, or L below that (one tile a chunk)
  int nt;   // tiles a chunk, L / TR
  int NW;   // consumer warpgroups at work: 2 where a chunk has two tiles or more
  int nDB, nVB, nFB;  // 64-column blocks of d, dv and m
  int ns;   // 128-column slices of d (dK and dQ accumulators)
  int stages;
  int carried;
  float scale;
};

__host__ __device__ inline uint32_t blocks_bytes(int nblocks, int rows) {
  return (uint32_t)nblocks * rows * kRow;
}
// an A tile of TR rows and the (64 - TR) rows past it that wgmma reads
__host__ __device__ inline uint32_t a_tile(int nblocks, int TR) {
  return blocks_bytes(nblocks, TR) + (64 - TR) * kRow;
}

// ---- products ------------------------------------------------------------------------
// s (64 x TR, fp32) (+)= A B^T over ks 16-wide steps, A and B K-major tiles
// (A's blocks of TR rows at a, B's at b): one n64 wgmma a step where TR is
// 64, else TR / 16 of n16 (s's entries 8 p .. 8 p + 7 are columns 16 p ..)
__device__ __forceinline__ void mma_nt(float (&s)[32], int TR, int ks, const uint8_t* a,
                                       const uint8_t* b, bool first) {
  if (TR == 64) {
    for (int k = 0; k < ks; ++k)
      Wgmma<64>::ss<0, 0>(s, desc_k(a, 64, k), desc_k(b, 64, k), !(first && k == 0));
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (p < TR / 16) {
        for (int k = 0; k < ks; ++k)
          Wgmma<16>::ss<0, 0>(s + 8 * p, desc_k(a, TR, k), desc_k(b + p * 16 * kRow, TR, k),
                              !(first && k == 0));
      }
    }
  }
}

// the A fragments of a 64 x TR fp32 tile x (entries as in hopper.cuh), as
// bf16 hi and lo, one set of 4 registers per 16-column step
__device__ __forceinline__ void frags(const float (&x)[32], uint32_t (&hi)[4][4],
                                      uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) split2(x[8 * k + 2 * r], x[8 * k + 2 * r + 1], hi[k][r], lo[k][r]);
}

// the thread's place in its warpgroup's accumulators
struct Lane {
  int rb, g, t;  // rows rb + g (+ 8), columns 8 j + 2 t (+ 1)
  __device__ explicit Lane(int tid) : rb(16 * ((tid >> 5) & 3)), g((tid & 31) >> 2), t(tid & 3) {}
  __device__ int row(int h) const { return rb + g + 8 * h; }
  __device__ int col(int j) const { return 8 * j + 2 * t; }
};

// rows x cols of out (row stride ld) from the accumulator d of N columns, at
// column offset c0 of out; only rows < nr and columns < nc stored
template <int N>
__device__ __forceinline__ void store_acc(float* out, size_t ld, const float* d, const Lane& ln,
                                          int nr, int c0, int nc) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ln.row(h), c = c0 + ln.col(j);
      if (r < nr && c < nc)
        *reinterpret_cast<float2*>(out + (size_t)r * ld + c) =
            make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
}

// ---- (a) the per-chunk folds and their running sums -------------------------------------
// Block (pair of 64-feature blocks, chunk, row, which) of two warpgroups,
// one 64-feature block each: which 0 folds chunk c < n - 1 into slot c + 1
// of the fp32 state scratch, S = phi_k^T v and Z = phi_k^T 1 over its L
// keys; which 1 folds chunk c > 0 into slot c - 1 of the reverse scratch, R
// = phi_q^T g_num and R_z = phi_q^T g_den over its Gq x L queries.  The
// tokens are the reduction: B, v or g_num, and the A operand phi^T come by
// TMA, two stages deep, each one term: B as an MN-major tile and phi as
// wgmma's MN-major (transposed) shared-memory A.  Z and R_z are summed on
// the CUDA cores from the same values.
struct FoldLayout {
  uint32_t tb, stage, total;  // a B tile, a stage (B and the pair's phi tile)
  __host__ __device__ explicit FoldLayout(const Dims& D) {
    tb = blocks_bytes(D.nVB, D.TR);
    stage = tb + blocks_bytes(2, D.TR);
    total = 2 * stage + 16;
  }
};

template <int DV>
__global__ void __launch_bounds__(2 * kWG) chimera_bwd_wgmma_fold_kernel(
    const __grid_constant__ CUtensorMap tV, const __grid_constant__ CUtensorMap tG,
    const __grid_constant__ CUtensorMap tPK, const __grid_constant__ CUtensorMap tPQ,
    const float* __restrict__ gden, float* __restrict__ state, float* __restrict__ rstate,
    Dims D) {
  extern __shared__ uint8_t raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(((uintptr_t)raw + 1023) & ~(uintptr_t)1023);
  const FoldLayout lay(D);
  const int npairs = (D.nFB + 1) / 2;
  const int fp = blockIdx.x % npairs, cc = blockIdx.x / npairs, bh = blockIdx.y;
  const bool rev = blockIdx.z == 1;
  const int c = rev ? cc + 1 : cc;  // the chunk folded
  const int per_head = D.L / D.TR, nsteps = (rev ? D.Gq : 1) * per_head;
  const int wg = threadIdx.x / kWG;
  const Lane ln(threadIdx.x % kWG);
  const int f0 = (2 * fp + wg) * 64, fa = f0 + ln.rb + ln.g;  // the thread's features fa, fa + 8
  const bool active = f0 < D.m, in0 = fa < D.m, in1 = fa + 8 < D.m;
  const int nblk = D.nFB - 2 * fp < 2 ? 1 : 2;  // the pair's 64-feature blocks
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + 2 * lay.stage);
  auto row_of = [&](int st) {  // the first global row of step st
    const int g = st / per_head, r = (st % per_head) * D.TR;
    return rev ? (bh * D.Gq + g) * D.T + c * D.L + r : bh * D.T + c * D.L + r;
  };
  auto issue = [&](int st) {
    uint8_t* b = sm + (st & 1) * lay.stage;
    const int row = row_of(st);
    bar_expect(&full[st & 1], lay.tb + nblk * blocks_bytes(1, D.TR));
    for (int e = 0; e < D.nVB; ++e)
      tma_load(b + e * D.TR * kRow, rev ? &tG : &tV, 64 * e, row, &full[st & 1]);
    for (int j = 0; j < nblk; ++j)
      tma_load(b + lay.tb + j * D.TR * kRow, rev ? &tPQ : &tPK, 64 * (2 * fp + j), row,
               &full[st & 1]);
  };
  if (threadIdx.x == 0) {
    bar_init(&full[0], 1);
    bar_init(&full[1], 1);
    bar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    issue(0);
    if (nsteps > 1) issue(1);
  }
  const int kq = D.TR / 16;
  float acc[DV / 2], z0 = 0.f, z1 = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  for (int st = 0; st < nsteps; ++st) {
    const int row = row_of(st);
    const uint8_t* b = sm + (st & 1) * lay.stage;
    const uint8_t* pt = b + lay.tb + wg * D.TR * kRow;  // this warpgroup's phi block
    bar_wait(&full[st & 1], (st >> 1) & 1);
    if (active) {
      // Z's terms from phi^T's values: features fa (+ 8), tokens 2t, 2t + 1
      // (+ 8) of each 16; x[k] holds (token, feature) (0,0) (1,0) (0,8)
      // (1,8) (8,0) (9,0) (8,8) (9,8)
      float x[4][8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < kq) {
          const int t0 = 16 * k + 2 * ln.t, c0 = ln.rb + ln.g;  // in the step's tile
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int t = t0 + (i & 1) + 8 * (i >> 2), cf = c0 + 8 * ((i >> 1) & 1);
            const bool in = (i >> 1) & 1 ? in1 : in0;
            x[k][i] = in ? tile_bf16(pt, D.TR, t, cf) : 0.f;
          }
          float w[4] = {1.f, 1.f, 1.f, 1.f};
          if (rev) {
            const int r0 = row + t0;
            w[0] = gden[r0];
            w[1] = gden[r0 + 1];
            w[2] = gden[r0 + 8];
            w[3] = gden[r0 + 9];
          }
          z0 += x[k][0] * w[0] + x[k][1] * w[1] + x[k][4] * w[2] + x[k][5] * w[3];
          z1 += x[k][2] * w[0] + x[k][3] * w[1] + x[k][6] * w[2] + x[k][7] * w[3];
        }
      }
      wg_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < kq)
          Wgmma<DV>::template ss<1, 1>(acc, desc_mn(pt, D.TR, k), desc_mn(b, D.TR, k), 1);
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
    }
    __syncthreads();  // both warpgroups are done with stage st % 2
    if (threadIdx.x == 0 && st + 2 < nsteps) issue(st + 2);
  }
  // Z (R_z): the four lanes of a row hold a quarter of the tokens each
  z0 += __shfl_xor_sync(0xffffffffu, z0, 1);
  z0 += __shfl_xor_sync(0xffffffffu, z0, 2);
  z1 += __shfl_xor_sync(0xffffffffu, z1, 1);
  z1 += __shfl_xor_sync(0xffffffffu, z1, 2);
  if (!active) return;
  const int SW = D.dv + 8;
  float* out = (rev ? rstate : state) + ((size_t)bh * D.n + (rev ? c - 1 : c + 1)) * D.m * SW;
  store_acc<DV>(out + (size_t)f0 * SW, SW, acc, ln, D.m - f0, 0, D.dv);
  if (ln.t == 0) {
    if (in0) out[(size_t)fa * SW + D.dv] = z0;
    if (in1) out[(size_t)(fa + 8) * SW + D.dv] = z1;
  }
}

// The running sums over the chunks in place (state slot c += slot c - 1,
// R slot c += slot c + 1), as chimera_bwd_prefix_kernel, and every slot that
// the stream tier reads (state 1 .. n - 1, R 0 .. n - 2) into bf16 hi + lo,
// (BH, n, m, dv) each, its Z (R_z) column into z (rz), (BH, n, m).  Thread x
// owns float4 e of every slot of one row of one scratch (row4 float4s a slot).
__global__ void __launch_bounds__(256) chimera_bwd_wgmma_prefix_kernel(
    float* __restrict__ state, float* __restrict__ rstate, __nv_bfloat16* __restrict__ shi,
    __nv_bfloat16* __restrict__ slo, __nv_bfloat16* __restrict__ rhi,
    __nv_bfloat16* __restrict__ rlo, float* __restrict__ z, float* __restrict__ rz, int BH,
    int n, int m, int dv) {
  const int SW = dv + 8, row4 = m * SW / 4;
  const size_t per = (size_t)BH * row4;
  size_t x = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (x >= 2 * per) return;
  const bool rev = x >= per;
  if (rev) x -= per;
  const size_t bh = x / row4;
  const int e = (int)(x % row4), f = 4 * e / SW, col = 4 * e % SW;
  float4* p = reinterpret_cast<float4*>(rev ? rstate : state) + bh * n * row4 + e;
  __nv_bfloat16* hi = (rev ? rhi : shi) + bh * n * m * dv + (size_t)f * dv + col;
  __nv_bfloat16* lo = (rev ? rlo : slo) + bh * n * m * dv + (size_t)f * dv + col;
  float* zs = (rev ? rz : z) + bh * n * m + f;
  auto put = [&](int slot, const float4& v) {  // the slot's bf16 terms, or its Z
    if (col == dv) zs[(size_t)slot * m] = v.x;
    if (col >= dv) return;
    uint2 h, l;
    split2(v.x, v.y, h.x, l.x);
    split2(v.z, v.w, h.y, l.y);
    *reinterpret_cast<uint2*>(hi + (size_t)slot * m * dv) = h;
    *reinterpret_cast<uint2*>(lo + (size_t)slot * m * dv) = l;
  };
  // the slots in the order summed, 1 .. n - 1 (state) or n - 2 .. 0 (R),
  // each slot's value loaded before the stores of the one before it
  const int first = rev ? n - 2 : 1, step = rev ? -1 : 1;
  float4 s = p[(size_t)first * row4];
  put(first, s);
  float4 y = n > 2 ? p[(size_t)(first + step) * row4] : s;
  for (int i = 2; i < n; ++i) {
    const int c = first + (i - 1) * step;
    const float4 next = i + 1 < n ? p[(size_t)(c + step) * row4] : y;
    s.x += y.x; s.y += y.y; s.z += y.z; s.w += y.w;
    p[(size_t)c * row4] = s;
    put(c, s);
    y = next;
  }
}

// ---- (b) the stream tier's products ---------------------------------------------------
// Shared memory of a stream block: the resident A tile (key side: v; query
// side: g_num), then one 64-feature block's B tiles (R's or the state's hi
// and lo), 48 KB at Mixtral-8x7B's shape; the blocks that share an SM take
// turns at the copies.
struct StreamLayout {
  uint32_t buf, per, total;
  __host__ __device__ explicit StreamLayout(const Dims& D) {
    buf = a_tile(D.nVB, D.TR);
    per = 2 * blocks_bytes(D.nVB, 64);
    total = buf + per + 64;  // + the barriers
  }
};

// Blocks [0, BH n nt) take a key tile of chunk c: dphi_k = [v | 1] R_c^T
// and dv's stream term phi_k R_c[:, :dv], written to dv (the dK/dV kernel
// adds the local tier to it; phi_k, the wgmma's A, read from global memory
// into its fragments, a bf16 pair a fragment register); the rest a query
// tile: dphi_q = [g_num | g_den] [S_c | Z_c]^T.
// Where no state is carried (chunk n - 1 for keys, chunk 0 for queries, or
// none at all) the rows are written as zeros.
// One warpgroup; thread 0 issues the copies, one 64-feature block at a time.
template <int DV>
__global__ void __launch_bounds__(kWG) chimera_bwd_wgmma_stream_kernel(
    const __grid_constant__ CUtensorMap tV, const __grid_constant__ CUtensorMap tG,
    const __grid_constant__ CUtensorMap tRhi, const __grid_constant__ CUtensorMap tRlo,
    const __grid_constant__ CUtensorMap tShi, const __grid_constant__ CUtensorMap tSlo,
    const __nv_bfloat16* __restrict__ phi_k, const float* __restrict__ gden,
    const float* __restrict__ z, const float* __restrict__ rz, float* __restrict__ dv,
    float* __restrict__ dphiq, float* __restrict__ dphik, Dims D) {
  extern __shared__ uint8_t raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(((uintptr_t)raw + 1023) & ~(uintptr_t)1023);
  const int tid = threadIdx.x;
  const Lane ln(tid);
  int x = blockIdx.x;
  const int nkey = D.BH * D.n * D.nt;
  const bool key = x < nkey;
  if (!key) x -= nkey;
  const int tile = x % D.nt;
  x /= D.nt;
  const int c = x % D.n;
  x /= D.n;
  const int g = key ? 0 : x % D.Gq, bh = key ? x : x / D.Gq;
  const size_t row0 = key ? (size_t)bh * D.T + (size_t)c * D.L + tile * D.TR
                          : ((size_t)bh * D.Gq + g) * D.T + (size_t)c * D.L + tile * D.TR;
  const bool live = D.carried && (key ? c + 1 < D.n : c > 0);
  const StreamLayout lay(D);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + lay.total - 64);  // resident, buffer
  if (!live) {
    float* out = key ? dphik : dphiq;
    for (int i = tid; i < D.TR * D.m; i += kWG) out[row0 * D.m + i] = 0.f;
    if (key)
      for (int i = tid; i < D.TR * D.dv; i += kWG) dv[row0 * D.dv + i] = 0.f;
    return;
  }
  const int slot = bh * D.n + c;  // the slot of the state (query side) or of R (key side)
  const float* zs = (key ? rz : z) + (size_t)slot * D.m;  // Z_c, or R_c's last column
  uint8_t* A0 = sm;  // v, or g_num
  uint8_t* b = sm + lay.buf;
  const uint32_t rb = blocks_bytes(D.nVB, 64);
  auto issue = [&](int fb) {
    uint64_t* bar = &bars[1];
    bar_expect(bar, 2 * rb);
    const CUtensorMap* hi = key ? &tRhi : &tShi;
    const CUtensorMap* lo = key ? &tRlo : &tSlo;
    for (int e = 0; e < D.nVB; ++e) {
      tma_load3(b + e * 64 * kRow, hi, 64 * e, 64 * fb, slot, bar);
      tma_load3(b + rb + e * 64 * kRow, lo, 64 * e, 64 * fb, slot, bar);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) bar_init(&bars[i], 1);
    bar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    bar_expect(&bars[0], blocks_bytes(D.nVB, D.TR));
    for (int e = 0; e < D.nVB; ++e)
      tma_load(A0 + e * D.TR * kRow, key ? &tV : &tG, 64 * e, (int)row0, &bars[0]);
    issue(0);
  }
  const int kv = D.dv / 16;
  float acc[32], dvs[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dvs[i] = 0.f;
  bar_wait(&bars[0], 0);
  for (int fb = 0; fb < D.nFB; ++fb) {
    // phi_k's fragments for the key side: keys rb + g (+ 8), features 64 fb
    // + 16 k + 2 t (+ 1, + 8, + 9); keys past the tile and features past m read as 0
    uint32_t ph[4][4];
    if (key) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = ln.row(r & 1), f = 64 * fb + 16 * k + 2 * ln.t + 8 * (r >> 1);
          ph[k][r] = j < D.TR && f < D.m
                         ? *reinterpret_cast<const uint32_t*>(phi_k + (row0 + j) * D.m + f)
                         : 0u;
        }
      }
    }
    bar_wait(&bars[1], fb & 1);
    wg_fence();
    if (key) {
      // dphi_k block = v (Rhi + Rlo)^T over dv
      for (int k = 0; k < kv; ++k) Wgmma<64>::ss<0, 0>(acc, desc_k(A0, D.TR, k), desc_k(b, 64, k), k > 0);
      for (int k = 0; k < kv; ++k) Wgmma<64>::ss<0, 0>(acc, desc_k(A0, D.TR, k), desc_k(b + rb, 64, k), 1);
      // dv += phi_k (Rhi + Rlo) over the block's 64 features
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        Wgmma<DV>::template rs<1>(dvs, ph[k], desc_mn(b, 64, k), 1);
        Wgmma<DV>::template rs<1>(dvs, ph[k], desc_mn(b + rb, 64, k), 1);
      }
    } else {
      // dphi_q block = g_num (Shi + Slo)^T over dv
      for (int k = 0; k < kv; ++k) Wgmma<64>::ss<0, 0>(acc, desc_k(A0, D.TR, k), desc_k(b, 64, k), k > 0);
      for (int k = 0; k < kv; ++k) Wgmma<64>::ss<0, 0>(acc, desc_k(A0, D.TR, k), desc_k(b + rb, 64, k), 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(dvs);
    fence_regs(ph);
    __syncthreads();  // every thread is done with the buffer: the next block's copy runs
    if (tid == 0 && fb + 1 < D.nFB) issue(fb + 1);  // under this one's stores
    // + the Z (or R's last) column: g_den Z_c for queries, 1 R_c[:, dv] for keys
    float* out = key ? dphik : dphiq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ln.row(h), f = 64 * fb + ln.col(j);
        if (r < D.TR && f < D.m) {
          const float w = key ? 1.f : gden[row0 + r];
          const float2 zf = *reinterpret_cast<const float2*>(zs + f);
          *reinterpret_cast<float2*>(out + (row0 + r) * D.m + f) =
              make_float2(fmaf(w, zf.x, acc[4 * j + 2 * h]), fmaf(w, zf.y, acc[4 * j + 2 * h + 1]));
        }
      }
    }
  }
  if (key) store_acc<DV>(dv + row0 * D.dv, D.dv, dvs, ln, D.TR, 0, D.dv);
}

// ---- (c) dK and dV ---------------------------------------------------------------------------
// Shared memory: each consumer's K and V tiles (resident), then the ring's
// stages (Q, g_num), then g_den of each stage, the barriers.
struct DkdvLayout {
  uint32_t kw, vw, stage, q, g, res, gd, bars, total;
  __host__ __device__ DkdvLayout(const Dims& D, int stages) {
    kw = a_tile(D.nDB, D.TR);
    vw = a_tile(D.nVB, D.TR);
    res = D.NW * (kw + vw);
    q = 0;
    g = blocks_bytes(D.nDB, D.TR);
    stage = g + blocks_bytes(D.nVB, D.TR);
    gd = res + stages * stage;
    bars = gd + stages * 256;
    total = bars + (2 * stages + 1) * 8;
  }
};

// One block per (row, chunk, pair of 64-key tiles, 128-column slice of d):
// consumer warpgroup w owns key tile kt = NW kb + w, its K and V resident,
// dK and dV in registers; the producer streams the query tiles of every
// query head from the first consumer's key tile on.  Per query tile: S^T =
// K Q^T and dP^T = V g^T (wgmma from shared memory), P^T and dS^T masked and
// split into bf16 hi + lo in registers, then dV += P^T g and dK += dS^T Q
// (two terms each) with P^T and dS^T as wgmma's register A.
template <int DV, int DN>
__global__ void __launch_bounds__(kThreads, 1) chimera_bwd_wgmma_dkdv_kernel(
    const __grid_constant__ CUtensorMap tK, const __grid_constant__ CUtensorMap tV,
    const __grid_constant__ CUtensorMap tQ, const __grid_constant__ CUtensorMap tG,
    const float* __restrict__ gden, float* __restrict__ dk, float* __restrict__ dv, Dims D) {
  extern __shared__ uint8_t raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(((uintptr_t)raw + 1023) & ~(uintptr_t)1023);
  const int S = D.stages;
  const DkdvLayout lay(D, S);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + lay.bars);
  uint64_t* empty = full + S;
  uint64_t* resb = empty + S;
  int x = blockIdx.x;
  const int sl = x % D.ns;
  x /= D.ns;
  const int c = x % D.n;
  x /= D.n;
  const int bh = x % D.BH, kb = x / D.BH;  // heaviest key tiles first
  const int qt0 = kb * D.NW;  // the first query tile any consumer needs
  const int wg = threadIdx.x / kWG;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], 4 * D.NW);  // every consumer warp releases
    }
    bar_init(resb, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {  // ---- producer
    regs_down<kDown>();
    if (threadIdx.x == kConsumers * kWG) {
      const uint32_t tb = blocks_bytes(1, D.TR);
      bar_expect(resb, D.NW * (D.nDB + D.nVB) * tb);
      for (int w = 0; w < D.NW; ++w) {
        const int row = bh * D.T + c * D.L + (qt0 + w) * D.TR;
        for (int b = 0; b < D.nDB; ++b) tma_load(sm + w * (lay.kw + lay.vw) + b * tb, &tK, 64 * b, row, resb);
        for (int b = 0; b < D.nVB; ++b)
          tma_load(sm + w * (lay.kw + lay.vw) + lay.kw + b * tb, &tV, 64 * b, row, resb);
      }
      int it = 0;
      for (int g = 0; g < D.Gq; ++g) {
        for (int qt = qt0; qt < D.nt; ++qt, ++it) {
          const int st = it % S;
          bar_wait(&empty[st], ((it / S) & 1) ^ 1);
          uint8_t* s = sm + lay.res + st * lay.stage;
          const int row = (bh * D.Gq + g) * D.T + c * D.L + qt * D.TR;
          bar_expect(&full[st], (D.nDB + D.nVB) * tb + D.TR * 4);
          for (int b = 0; b < D.nDB; ++b) tma_load(s + lay.q + b * tb, &tQ, 64 * b, row, &full[st]);
          for (int b = 0; b < D.nVB; ++b) tma_load(s + lay.g + b * tb, &tG, 64 * b, row, &full[st]);
          bulk_load(sm + lay.gd + st * 256, gden + row, D.TR * 4, &full[st]);
        }
      }
    }
  } else {  // ---- consumers
    regs_up<kUp>();
    if (wg >= D.NW) return;
    const int tid = threadIdx.x % kWG;
    const Lane ln(tid);
    const int kt = qt0 + wg;
    const size_t krow = (size_t)bh * D.T + (size_t)c * D.L + kt * D.TR;
    const uint8_t* Kw = sm + wg * (lay.kw + lay.vw);
    const uint8_t* Vw = Kw + lay.kw;
    const bool with_dv = sl == 0;
    float adv[DV / 2], adk[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) adk[i] = 0.f;
    // dV starts from its stream term, which the stream kernel wrote
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ln.row(h), e = ln.col(j);
        float2 v = make_float2(0.f, 0.f);
        if (with_dv && r < D.TR && e < D.dv)
          v = *reinterpret_cast<const float2*>(dv + (krow + r) * D.dv + e);
        adv[4 * j + 2 * h] = v.x;
        adv[4 * j + 2 * h + 1] = v.y;
      }
    }
    const int kd = (D.d + 15) / 16, kv = D.dv / 16, kq = D.TR / 16;
    bar_wait(resb, 0);
    int it = 0;
    for (int g = 0; g < D.Gq; ++g) {
      for (int qt = qt0; qt < D.nt; ++qt, ++it) {
        const int st = it % S;
        bar_wait(&full[st], (it / S) & 1);
        const uint8_t* s = sm + lay.res + st * lay.stage;
        const float* gd = reinterpret_cast<const float*>(sm + lay.gd + st * 256);
        if (qt >= kt) {
          float sT[32], pT[32];
          wg_fence();
          mma_nt(sT, D.TR, kd, Kw, s + lay.q, true);
          mma_nt(pT, D.TR, kv, Vw, s + lay.g, true);
          wg_commit();
          wg_wait<0>();
          fence_regs(sT);
          fence_regs(pT);
          // P^T and dS^T: row r is key kt TR + r, column i query qt TR + i of the chunk
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int r = ln.row(h), i = ln.col(j) + e, a = 4 * j + 2 * h + e;
                const bool ok = i < D.TR && r < D.TR && kt * D.TR + r <= qt * D.TR + i;
                const float p = ok ? expf(sT[a] * D.scale) : 0.f;
                sT[a] = p;
                pT[a] = ok ? p * (pT[a] + gd[i]) * D.scale : 0.f;
              }
            }
          }
          // dV += P^T g, then dK += dS^T Q: one product's fragments live at a time
          uint32_t hi[4][4], lo[4][4];
          if (with_dv) {
            frags(sT, hi, lo);
            wg_fence();
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (k < kq) {
                Wgmma<DV>::template rs<1>(adv, hi[k], desc_mn(s + lay.g, D.TR, k), 1);
                Wgmma<DV>::template rs<1>(adv, lo[k], desc_mn(s + lay.g, D.TR, k), 1);
              }
            }
            wg_commit();
            wg_wait<0>();
            fence_regs(adv);
            fence_regs(hi);
            fence_regs(lo);
          }
          frags(pT, hi, lo);
          wg_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (k < kq) {
              Wgmma<DN>::template rs<1>(adk, hi[k], desc_mn(s + lay.q, D.TR, k, 2 * sl), 1);
              Wgmma<DN>::template rs<1>(adk, lo[k], desc_mn(s + lay.q, D.TR, k, 2 * sl), 1);
            }
          }
          wg_commit();
          wg_wait<0>();
          fence_regs(adk);
          fence_regs(hi);
          fence_regs(lo);
        }
        if ((threadIdx.x & 31) == 0) bar_arrive(&empty[st]);
      }
    }
    store_acc<DN>(dk + krow * D.d, D.d, adk, ln, D.TR, 128 * sl, D.d);
    if (with_dv) store_acc<DV>(dv + krow * D.dv, D.dv, adv, ln, D.TR, 0, D.dv);
  }
}

// ---- (d) dQ ------------------------------------------------------------------------------------
// Shared memory: each consumer's Q and g_num tiles and g_den (resident),
// then the ring's stages (K, V), the barriers.
struct DqLayout {
  uint32_t qw, gw, per, res, stage, k, v, gd, bars, total;
  __host__ __device__ DqLayout(const Dims& D, int stages) {
    qw = a_tile(D.nDB, D.TR);
    gw = a_tile(D.nVB, D.TR);
    per = qw + gw;
    res = D.NW * per;
    k = 0;
    v = blocks_bytes(D.nDB, D.TR);
    stage = v + blocks_bytes(D.nVB, D.TR);
    gd = res + stages * stage;
    bars = gd + D.NW * 256;
    total = bars + (2 * stages + 1) * 8;
  }
};

// One block per (row, query head, chunk, pair of 64-query tiles, 128-column
// slice of d): consumer warpgroup w owns query tile qt = NW qb + w, its Q,
// g_num and g_den resident, dQ in registers; the producer streams the key
// tiles up to the last consumer's diagonal.  Per key tile: S = Q K^T, dP =
// g V^T, dS masked and split, dQ += dS K (two terms).
template <int DV, int DN>
__global__ void __launch_bounds__(kThreads, 1) chimera_bwd_wgmma_dq_kernel(
    const __grid_constant__ CUtensorMap tK, const __grid_constant__ CUtensorMap tV,
    const __grid_constant__ CUtensorMap tQ, const __grid_constant__ CUtensorMap tG,
    const float* __restrict__ gden, float* __restrict__ dq, Dims D) {
  extern __shared__ uint8_t raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(((uintptr_t)raw + 1023) & ~(uintptr_t)1023);
  const int S = D.stages;
  const DqLayout lay(D, S);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + lay.bars);
  uint64_t* empty = full + S;
  uint64_t* resb = empty + S;
  const int nqb = (D.nt + D.NW - 1) / D.NW;
  int x = blockIdx.x;
  const int sl = x % D.ns;
  x /= D.ns;
  const int c = x % D.n;
  x /= D.n;
  const int g = x % D.Gq;
  x /= D.Gq;
  const int bh = x % D.BH, qb = nqb - 1 - x / D.BH;  // heaviest query tiles first
  const int kt_end = min(D.nt, (qb + 1) * D.NW);  // key tiles [0, kt_end)
  const int wg = threadIdx.x / kWG;
  const size_t hrow = ((size_t)bh * D.Gq + g) * D.T + (size_t)c * D.L;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], 4 * D.NW);
    }
    bar_init(resb, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {  // ---- producer
    regs_down<kDown>();
    if (threadIdx.x == kConsumers * kWG) {
      const uint32_t tb = blocks_bytes(1, D.TR);
      int nw = 0;  // consumers with a query tile
      for (int w = 0; w < D.NW; ++w) nw += qb * D.NW + w < D.nt;
      bar_expect(resb, nw * ((D.nDB + D.nVB) * tb + D.TR * 4));
      for (int w = 0; w < nw; ++w) {
        const int row = (int)hrow + (qb * D.NW + w) * D.TR;
        uint8_t* r = sm + w * lay.per;
        for (int b = 0; b < D.nDB; ++b) tma_load(r + b * tb, &tQ, 64 * b, row, resb);
        for (int b = 0; b < D.nVB; ++b) tma_load(r + lay.qw + b * tb, &tG, 64 * b, row, resb);
        bulk_load(sm + lay.gd + w * 256, gden + row, D.TR * 4, resb);
      }
      for (int kt = 0; kt < kt_end; ++kt) {
        const int st = kt % S;
        bar_wait(&empty[st], ((kt / S) & 1) ^ 1);
        uint8_t* s = sm + lay.res + st * lay.stage;
        const int row = bh * D.T + c * D.L + kt * D.TR;
        bar_expect(&full[st], (D.nDB + D.nVB) * tb);
        for (int b = 0; b < D.nDB; ++b) tma_load(s + lay.k + b * tb, &tK, 64 * b, row, &full[st]);
        for (int b = 0; b < D.nVB; ++b) tma_load(s + lay.v + b * tb, &tV, 64 * b, row, &full[st]);
      }
    }
  } else {  // ---- consumers
    regs_up<kUp>();
    const int qt = qb * D.NW + wg;
    if (wg >= D.NW || qt >= D.nt) {
      // a consumer without a query tile still releases every stage
      if (wg < D.NW)
        for (int kt = 0; kt < kt_end; ++kt) {
          bar_wait(&full[kt % S], (kt / S) & 1);
          if ((threadIdx.x & 31) == 0) bar_arrive(&empty[kt % S]);
        }
      return;
    }
    const int tid = threadIdx.x % kWG;
    const Lane ln(tid);
    const uint8_t* Qw = sm + wg * lay.per;
    const uint8_t* Gw = Qw + lay.qw;
    const float* gd = reinterpret_cast<const float*>(sm + lay.gd + wg * 256);
    float adq[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) adq[i] = 0.f;
    const int kd = (D.d + 15) / 16, kv = D.dv / 16, kk = D.TR / 16;
    bar_wait(resb, 0);
    for (int kt = 0; kt < kt_end; ++kt) {
      const int st = kt % S;
      bar_wait(&full[st], (kt / S) & 1);
      const uint8_t* s = sm + lay.res + st * lay.stage;
      if (kt <= qt) {
        float sc[32], dp[32];
        wg_fence();
        mma_nt(sc, D.TR, kd, Qw, s + lay.k, true);
        mma_nt(dp, D.TR, kv, Gw, s + lay.v, true);
        wg_commit();
        wg_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        // dS: row r is query qt TR + r, column j key kt TR + j of the chunk
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = ln.row(h), jj = ln.col(j) + e, a = 4 * j + 2 * h + e;
              const bool ok = jj < D.TR && r < D.TR && kt * D.TR + jj <= qt * D.TR + r;
              dp[a] = ok ? expf(sc[a] * D.scale) * (dp[a] + gd[r < D.TR ? r : 0]) * D.scale : 0.f;
            }
          }
        }
        uint32_t dh[4][4], dl[4][4];
        frags(dp, dh, dl);
        wg_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < kk) {
            Wgmma<DN>::template rs<1>(adq, dh[k], desc_mn(s + lay.k, D.TR, k, 2 * sl), 1);
            Wgmma<DN>::template rs<1>(adq, dl[k], desc_mn(s + lay.k, D.TR, k, 2 * sl), 1);
          }
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(adq);
        fence_regs(dh);
        fence_regs(dl);
      }
      if ((threadIdx.x & 31) == 0) bar_arrive(&empty[st]);
    }
    store_acc<DN>(dq + (hrow + (size_t)qt * D.TR) * D.d, D.d, adq, ln, D.TR, 128 * sl, D.d);
  }
}

// ---- the launcher ---------------------------------------------------------------------------
// scratch (bytes, each part 256-byte aligned), where a state is carried:
// the fp32 state and R before and after each chunk, (BH, n, m, dv + 8)
// each, their bf16 hi and lo, (BH n m, dv) each, and their last columns Z
// and R_z, (BH n m) each
struct Scratch {
  size_t state, rstate, shi, slo, rhi, rlo, z, rz, total;
  Scratch(int BH, int T, int dv, int m, int L, bool carried) {
    const size_t n = T / L;
    size_t at = 0;
    auto take = [&](size_t bytes) {
      const size_t p = at;
      at += (bytes + 255) & ~(size_t)255;
      return p;
    };
    const size_t st = carried ? (size_t)BH * n * m * (dv + 8) * 4 : 0;
    state = take(st);
    rstate = take(st);
    const size_t sr = carried ? (size_t)BH * n * m * dv * 2 : 0;
    shi = take(sr);
    slo = take(sr);
    rhi = take(sr);
    rlo = take(sr);
    z = take(carried ? (size_t)BH * n * m * 4 : 0);
    rz = take(carried ? (size_t)BH * n * m * 4 : 0);
    total = at;
  }
};

template <class Kernel>
int set_smem(Kernel k, uint32_t bytes) {
  return (int)cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the most ring stages (up to kMaxStages) that fit beside what is resident
template <class Layout>
int fit_stages(const Dims& D) {
  for (int s = kMaxStages; s >= 1; --s)
    if (Layout(D, s).total + 1024 <= kSmemLimit) return s;
  return 0;
}

template <int DV>
int launch_fold(const CUtensorMap (&maps)[4], const CUtensorMap& pk, const CUtensorMap& pq,
                const float* gden, float* state, float* rstate, const Dims& D,
                cudaStream_t stream) {
  const uint32_t smem = FoldLayout(D).total + 1024;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const size_t blocks = (size_t)((D.nFB + 1) / 2) * (D.n - 1);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int err = set_smem(chimera_bwd_wgmma_fold_kernel<DV>, smem);
  if (err) return err;
  chimera_bwd_wgmma_fold_kernel<DV><<<dim3((unsigned)blocks, D.BH, 2), 2 * kWG, smem, stream>>>(
      maps[1], maps[3], pk, pq, gden, state, rstate, D);
  return (int)cudaGetLastError();
}

template <int DV, int DN>
int launch_local(const CUtensorMap (&maps)[4], const float* gden, float* dq, float* dk,
                 float* dv, Dims D, cudaStream_t stream) {
  Dims Dk = D, Dq = D;
  Dk.stages = fit_stages<DkdvLayout>(D);
  Dq.stages = fit_stages<DqLayout>(D);
  if (Dk.stages == 0 || Dq.stages == 0) return (int)cudaErrorInvalidValue;
  const int npb = (D.nt + D.NW - 1) / D.NW;  // blocks of NW tiles a chunk
  const size_t kv_blocks = (size_t)npb * D.BH * D.n * D.ns, q_blocks = kv_blocks * D.Gq;
  if (q_blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const uint32_t kv_smem = DkdvLayout(Dk, Dk.stages).total + 1024;
  const uint32_t q_smem = DqLayout(Dq, Dq.stages).total + 1024;
  int err = set_smem(chimera_bwd_wgmma_dkdv_kernel<DV, DN>, kv_smem);
  if (err) return err;
  chimera_bwd_wgmma_dkdv_kernel<DV, DN><<<(unsigned)kv_blocks, kThreads, kv_smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], gden, dk, dv, Dk);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = set_smem(chimera_bwd_wgmma_dq_kernel<DV, DN>, q_smem);
  if (err) return err;
  chimera_bwd_wgmma_dq_kernel<DV, DN><<<(unsigned)q_blocks, kThreads, q_smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], gden, dq, Dq);
  return (int)cudaGetLastError();
}

template <int DV>
int launch_stream(const CUtensorMap (&maps)[6], const __nv_bfloat16* phi_k, const float* gden,
                  const float* z, const float* rz, float* dv, float* dphiq, float* dphik, Dims D,
                  cudaStream_t stream) {
  const uint32_t smem = StreamLayout(D).total + 1024;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const size_t blocks = (size_t)D.BH * D.n * D.nt * (1 + D.Gq);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int err = set_smem(chimera_bwd_wgmma_stream_kernel<DV>, smem);
  if (err) return err;
  chimera_bwd_wgmma_stream_kernel<DV><<<(unsigned)blocks, kWG, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], phi_k, gden, z, rz, dv, dphiq,
      dphik, D);
  return (int)cudaGetLastError();
}

template <int DV>
int launch_dn(int dn, const CUtensorMap (&maps)[4], const float* gden, float* dq, float* dk,
              float* dv, const Dims& D, cudaStream_t s) {
  switch (dn) {
    case 32: return launch_local<DV, 32>(maps, gden, dq, dk, dv, D, s);
    case 64: return launch_local<DV, 64>(maps, gden, dq, dk, dv, D, s);
    case 96: return launch_local<DV, 96>(maps, gden, dq, dk, dv, D, s);
    default: return launch_local<DV, 128>(maps, gden, dq, dk, dv, D, s);
  }
}

}  // namespace wg

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
    case 16: return fp::launch<16>(q, k, v, phi_q, phi_k, g_num, g_den, dq, dk, dv, dphi_q, dphi_k, state, rstate, BH, Gq, T, d, m, L, scale, use_local, use_stream, s);
    case 32: return fp::launch<32>(q, k, v, phi_q, phi_k, g_num, g_den, dq, dk, dv, dphi_q, dphi_k, state, rstate, BH, Gq, T, d, m, L, scale, use_local, use_stream, s);
    case 64: return fp::launch<64>(q, k, v, phi_q, phi_k, g_num, g_den, dq, dk, dv, dphi_q, dphi_k, state, rstate, BH, Gq, T, d, m, L, scale, use_local, use_stream, s);
    case 128: return fp::launch<128>(q, k, v, phi_q, phi_k, g_num, g_den, dq, dk, dv, dphi_q, dphi_k, state, rstate, BH, Gq, T, d, m, L, scale, use_local, use_stream, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the bf16 route's scratch in bytes (wg::Scratch), or -1 for a shape it refuses
extern "C" long long chimera_attention_bwd_bf16_scratch(int BH, int T, int dvw, int m, int L,
                                                        int use_stream) {
  if (BH <= 0 || T <= 0 || L <= 0 || T % L != 0 || dvw <= 0 || m <= 0) return -1;
  return (long long)wg::Scratch(BH, T, dvw, m, L, use_stream && T > L).total;
}

// The bf16 route: q, k, v, phi_q, phi_k and g_num bf16, g_den fp32; the
// five gradients fp32; scratch of chimera_attention_bwd_bf16_scratch bytes,
// 256-byte aligned.  dq and dk are left as they are without use_local (the
// caller passes zeros).
extern "C" int chimera_attention_bwd_bf16_launch(
    const void* q, const void* k, const void* v, const void* phi_q, const void* phi_k,
    const void* g_num, const float* g_den, float* dq, float* dk, float* dv, float* dphi_q,
    float* dphi_k, void* scratch, int BH, int Gq, int T, int d, int dvw, int m, int L,
    float scale, int use_local, int use_stream, void* stream) {
  using namespace wg;
  const bool chunk_ok = L == 16 || L == 32 || L == 64 || L == 128 || L == 256;
  const bool dv_ok = dvw == 16 || dvw == 32 || dvw == 64 || dvw == 128;
  if (BH <= 0 || Gq <= 0 || T <= 0 || !chunk_ok || !dv_ok || T % L != 0 || d <= 0 ||
      d % 8 != 0 || m <= 0 || m % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, phi_q, phi_k, g_num, g_den, dq, dk, dv, dphi_q, dphi_k};
  for (const void* p : ptrs)
    if (p == nullptr || ((uintptr_t)p & 15)) return (int)cudaErrorInvalidValue;
  if (scratch == nullptr || ((uintptr_t)scratch & 255)) return (int)cudaErrorInvalidValue;
  const int n = T / L;
  const bool carried = use_stream && n > 1;
  const Scratch sc(BH, T, dvw, m, L, carried);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  float* state = carried ? reinterpret_cast<float*>(base + sc.state) : nullptr;
  float* rstate = carried ? reinterpret_cast<float*>(base + sc.rstate) : nullptr;
  auto bf = [&](size_t off) { return reinterpret_cast<__nv_bfloat16*>(base + off); };
  auto f32 = [&](size_t off) { return carried ? reinterpret_cast<float*>(base + off) : nullptr; };
  cudaStream_t s = (cudaStream_t)stream;

  Dims D;
  D.BH = BH, D.Gq = Gq, D.T = T, D.d = d, D.dv = dvw, D.m = m, D.L = L, D.n = n;
  D.TR = L < 64 ? L : 64;
  D.nt = L / D.TR;
  D.NW = D.nt >= 2 ? kConsumers : 1;
  D.nDB = (d + 63) / 64, D.nVB = (dvw + 63) / 64, D.nFB = (m + 63) / 64;
  D.ns = (d + 127) / 128;
  D.stages = 0;
  D.carried = carried;
  D.scale = scale;
  if ((size_t)BH * Gq * T > 0x7fffffff) return (int)cudaErrorInvalidValue;

  int err = 0;
  // the tensor maps: K, V, Q, g_num in tiles of TR rows; the state's and
  // R's per slot in tiles of 64 rows
  CUtensorMap local[4], str[6];
  memset(local, 0, sizeof(local));
  memset(str, 0, sizeof(str));
  const uint32_t tr = D.TR;
  bool ok = make_map(&local[0], k, (uint64_t)BH * T, d, tr) &&
            make_map(&local[1], v, (uint64_t)BH * T, dvw, tr) &&
            make_map(&local[2], q, (uint64_t)BH * Gq * T, d, tr) &&
            make_map(&local[3], g_num, (uint64_t)BH * Gq * T, dvw, tr);
  if (ok && carried)
    ok = make_map3(&str[2], bf(sc.rhi), (uint64_t)BH * n, m, dvw) &&
         make_map3(&str[3], bf(sc.rlo), (uint64_t)BH * n, m, dvw) &&
         make_map3(&str[4], bf(sc.shi), (uint64_t)BH * n, m, dvw) &&
         make_map3(&str[5], bf(sc.slo), (uint64_t)BH * n, m, dvw);
  if (!ok) return (int)cudaErrorInvalidValue;
  str[0] = local[1];
  str[1] = local[3];
  // (a) the folds, then the running sums with the state's and R's bf16 terms
  if (carried) {
    if (BH > 65535) return (int)cudaErrorInvalidValue;
    CUtensorMap pk, pq;
    memset(&pk, 0, sizeof(pk));
    memset(&pq, 0, sizeof(pq));
    if (!make_map(&pk, phi_k, (uint64_t)BH * T, m, tr) ||
        !make_map(&pq, phi_q, (uint64_t)BH * Gq * T, m, tr))
      return (int)cudaErrorInvalidValue;
    switch (dvw) {
      case 16:
      case 32: err = launch_fold<32>(local, pk, pq, g_den, state, rstate, D, s); break;
      case 64: err = launch_fold<64>(local, pk, pq, g_den, state, rstate, D, s); break;
      default: err = launch_fold<128>(local, pk, pq, g_den, state, rstate, D, s); break;
    }
    if (err) return err;
    const size_t threads = 2 * (size_t)BH * (m * (dvw + 8) / 4);
    chimera_bwd_wgmma_prefix_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
        state, rstate, bf(sc.shi), bf(sc.slo), bf(sc.rhi), bf(sc.rlo), f32(sc.z), f32(sc.rz), BH,
        n, m, dvw);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  // (b) the stream tier, and dv's first term; (c) dK and dV; (d) dQ
  const __nv_bfloat16* pk16 = static_cast<const __nv_bfloat16*>(phi_k);
  switch (dvw) {
    case 16:
    case 32: err = launch_stream<32>(str, pk16, g_den, f32(sc.z), f32(sc.rz), dv, dphi_q, dphi_k, D, s); break;
    case 64: err = launch_stream<64>(str, pk16, g_den, f32(sc.z), f32(sc.rz), dv, dphi_q, dphi_k, D, s); break;
    default: err = launch_stream<128>(str, pk16, g_den, f32(sc.z), f32(sc.rz), dv, dphi_q, dphi_k, D, s); break;
  }
  if (err || !use_local) return err;
  const int dn = d <= 32 ? 32 : d <= 64 ? 64 : d <= 96 ? 96 : 128;
  switch (dvw) {
    case 16:
    case 32: return launch_dn<32>(dn, local, g_den, dq, dk, dv, D, s);
    case 64: return launch_dn<64>(dn, local, g_den, dq, dk, dv, D, s);
    default: return launch_dn<128>(dn, local, g_den, dq, dk, dv, D, s);
  }
}
