// Backward of causal sliding-window softmax attention for Hopper (sm_90a),
// and of its non-causal mode.
//
// Replaces the backward of the JAX package's window attention op:
// repro/kernels/window_attention/ops.py::_bwd (:37-40), which differentiates
// window_attention_ref (jnp, no Pallas) inside the op's jax.custom_vjp.  For
// o = softmax(q k^T / sqrt(d) + band) v, row i seeing the keys j with
// 0 <= i - j < W, and the incoming gradient dO, it computes
//   P  = exp(q k^T / sqrt(d) - lse)      (recomputed; lse from the forward)
//   D  = rowsum(dO o)
//   dS = P (dO v^T - D)
//   dq = dS k / sqrt(d),  dk = dS^T q / sqrt(d),  dv = P^T dO
// with K and V per kv-head (H % Hkv == 0): dk and dv of a kv-head sum over
// its G = H / Hkv query heads.  Accumulation is fp32 whatever the inputs'
// type; dq, dk and dv are written once each, in the inputs' type.
//
// Three launches, no atomics, so two runs on the same inputs give the same
// bits (the Trainer's resume check runs in deterministic mode):
//   (a) window_bwd_rowdot_kernel: D_i = sum_c dO_ic o_ic, one warp a row.
//   (b) dK/dV: one block per (batch x kv-head, 64-key tile).  It holds its K
//       and V tiles in shared memory and loops over the G query heads and
//       the 64-row query tiles that meet its band, [j0, j0 + 64 + W - 1);
//       per tile it recomputes S^T and dP^T, forms P^T and dS^T and
//       accumulates dV += P^T dO and dK += dS^T Q.  The sum over query heads
//       stays in the block.
//   (c) dQ: one block per (batch x head, 64-row query tile), over the key
//       tiles of its band: S, dP, dS and dQ += dS K.
// Blocks are ordered longest first (key tiles from the start of the
// sequence, query tiles from its end).
//
// bf16 (the training path's type): the products on the tensor cores.
//   * 4 warps a block, each owning 16 keys (b) or 16 query rows (c).  The
//     block's own K and V (b) or Q and dO (c) tiles are staged once; the
//     loop's tiles (Q, dO, lse and D in (b); K and V in (c)) come through a
//     two-stage ring filled by 16-byte cp.async, so tile t + 1 loads while
//     tile t is in the products.  Operands stay bf16 in shared memory, rows
//     at a stride of the width + 16 bytes, which keeps every ldmatrix free
//     of bank conflicts; d = 24 is zero-padded to 32 there (mma's k is 16).
//   * S = Q K^T (S^T = K Q^T in (b)) and dP = dO V^T run as bf16
//     mma.sync.m16n8k16 with fp32 accumulators, fragments from ldmatrix:
//     the bf16 inputs enter exactly.  P and dS are formed in fp32 registers
//     (exp2 in the log2 domain; the band evaluated on the tiles that cross
//     it) and feed the second products straight from the accumulator
//     layout: two adjacent 16 x 8 accumulator tiles are the 16 x 16 A
//     operand of the next mma, so neither leaves registers.  The second
//     products read their B operands with ldmatrix.trans where they reduce
//     over query rows or keys: dO and Q in dV += P^T dO and dK += dS^T Q, K
//     in dQ += dS K.
//   * P and dS enter those products as two bf16 terms, hi = bf16(x) and lo =
//     bf16(x - hi), about 16 bits of each, so each is two mma where one
//     product is needed.  One rounding of P and dS to bf16 (2^-9 of each
//     entry) is beyond the 1e-4 * max|ref| floor that chip_smoke.py holds
//     the bf16 backward to for entries near 0; the split keeps the error
//     near 2^-17 (tests/test_torch_softmax_training.py emulates both).
//   * (b) takes its 64-row query tiles as sub-tiles of 32 queries (16 where
//     d + dv = 256), so that a warp's S^T and dP^T sit beside its dK and dV
//     accumulators (16 x (d + dv) fp32: 128 registers a thread at d = dv =
//     128; with 32 queries there ptxas spilled 48 bytes).
//
// Work the tensor cores do, at the bound's five products of 2 d (or 2 dv)
// flop an in-band pair: S and dP are computed in both (b) and (c), and the
// three products against P or dS run twice (hi and lo), so ten product-units
// are issued where the bound counts five: six in (b), four in (c).
//
// Registers and shared memory (nvcc -Xptxas -v, sm_90a, no spills; (b) /
// (c) a thread): 237 / 241 at (d, dv) = (128, 128), 243 / 231 at (128, 64),
// 228 / 194 at (64, 128), 195 / 177 at (64, 64), 221 / 212 at (96, 64), 125
// / 132 at (32, 32), 96 / 102 at (16, 16), 106 / 125 at (24, 16): two
// blocks of 128 threads an SM.  Shared memory a block, dynamic: 64 rows of
// each of the block's own two operands and two ring stages of 64 rows of
// the loop's two, at row strides of (d + 8) and (dv + 8) bf16, and 1 KB of
// lse and D: 103.0 KB at d = dv = 128 (two blocks an SM), 67.0 KB at (96,
// 64).
//
// Bound on an H100 at Mixtral-8x7B's training shape (B 1 x H 32 over Hkv 8,
// T 8192, W 4096, d = dv = 128): 25.2 M in-band pairs a head and five
// products of 2 d flop a pair, 1.03 TFLOP, 1.0423 ms on the bf16 tensor
// cores at 989 TFLOP/s; at MiniCPM3-4B's (H = Hkv 40, W = T = 8192, d 96,
// dv 64) 1.12 TFLOP, 1.1292 ms; the bytes (~0.5 GB) take 0.15 ms.  The ten
// issued product-units take 2.08 and 2.26 ms at that peak.
//
// What holds it back, on an H100 80GB HBM3 at 700 W (chip_smoke.py's
// check_window_bwd and compare_builds, variants of this source timed in
// turns in one call): 7.04-7.08 ms at Mixtral's shape (the first design's
// CUDA-core kernels 48.07 in the same call), 6.8x its bound; (b) 4.29 ms
// and (c) 2.86 ms in a profiler trace, each ~29 % of the peak rate for the
// product-units it issues, D 0.05 ms.  Without the lo products 6.04 ms, so
// the split costs ~1.0 ms; without exp2 6.59 ms.  MiniCPM3-4B's W = T:
// 8.58-8.65 ms ((b) 5.08, (c) 3.63; first design 58.08), without the lo
// products 7.28, without exp2 7.56: its 1.34 G in-band pairs (1.67x
// Mixtral's, at 0.65x the flop a pair) make the per-pair softmax and split
// work weigh more.  The rest is, by estimate (nothing there reads the SM's
// pipes), operand traffic: every warp reads its B operands from shared
// memory with ldmatrix for its own 16 rows, about 8 multiply-adds a byte,
// which at 128 bytes a clock an SM holds mma.sync to about half its rate;
// wgmma, whose B operand a warpgroup shares from shared memory, is the step
// past it.  A 16-query sub-tile at (96, 64) was
// 8.89 ms; at (128, 128) 16 and 32 time alike (7.04-7.05 against
// 7.07-7.10).
//
// fp32: the CUDA-core kernels of the first design, kept as they were
// (nothing on a timed path runs them: the plain-route step comparison, the
// edges and the fp32 checks do).  Fp32 FMAs out of fp32 tiles in shared
// memory; 256 threads own a 64 x 64 tile as 16 x 16 threads of 4 x 4
// entries at a stride of 16 rows and 16 columns, operand rows read as
// float4 at a row stride of dim + 4 words.  At d = dv = 128 the tiles of K,
// V, Q and dO take 4 x 33 KB and P^T and dS^T 2 x 17 KB: 170 KB of the 227
// KB, one block an SM; 15.4 ms of fp32 FMAs at Mixtral's shape.
//
// Non-causal mode (causal = 0; window_attention_noncausal_bwd_launch): the
// backward of window_attention.cu's non-causal mode, for the encoder of
// whisper-tiny and its softmax cross-attention in training (JAX
// differentiates blockwise_softmax_attention(causal=False) in jnp,
// models/attention.py:42, no pallas_call).  The same three kernels with n_q
// query rows against n_k keys of their own, taken apart, and a runtime
// argument rather than a template axis, so the build instantiates no more
// kernels: D runs over the n_q rows; (b) walks every query tile of [0, n_q)
// of each of its kv-head's G query heads (grid: key tiles of n_k x B*Hkv);
// (c) every key tile of [0, n_k) (grid: query tiles of n_q x B*H); the only
// masks are keys >= n_k and rows >= n_q, on the tiles that hold them.  No
// atomics either.  Bound at whisper-tiny's encoder training shape (B 8 x H
// 6, Tq = Tk 2,048, d = dv = 64, bf16): 2,048^2 x 48 pairs x (6 d + 4 dv)
// flop = 128.8 GFLOP, 0.130 ms at 989 TFLOP/s; the bytes (~25 MB) take
// 0.008 ms.  The encoder's tiles of 64 queries x 64 keys are all full but
// for the last of a ragged length, so the causal mode's design runs as it
// is: the first version, not tuned for this shape.
//
// Contract (every pointer contiguous and 16-byte aligned; q, k, v, o, do,
// dq, dk, dv all float32 or all bfloat16; lse and the scratch D float32):
//   q, o, do (B*H, T, d | dv), k (B*Hkv, T, d), v (B*Hkv, T, dv),
//   lse (B*H, T) -> dq (B*H, T, d), dk (B*Hkv, T, d), dv (B*Hkv, T, dv);
//   in the non-causal mode q, o, do (B*H, Tq, ·), lse (B*H, Tq), k and v
//   (B*Hkv, Tk, ·), any Tq, Tk >= 1
// Takes what the forward takes: H % Hkv == 0, W >= 1 (W > T included), any
// T, and (d, dv) in {(64, 64), (64, 128), (128, 64), (128, 128), (16, 16),
// (32, 32), (96, 64), (24, 16)}; anything else is cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// (a) D_i = sum_c dO_ic o_ic, one warp a row (256 threads a block)
template <typename T, int DV>
__global__ void __launch_bounds__(256) window_bwd_rowdot_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dd, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < DV; c += 32)
    acc = fmaf(to_f(dout[row * DV + c]), to_f(o[row * DV + c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dd[row] = acc;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // the block's own keys (b) or query rows (c)
constexpr int kTile = 64;           // rows of a ring tile: queries (b), keys (c)

// queries of a compute sub-tile in (b): 32, or 16 where a warp's dK and dV
// accumulators take 128 registers a thread (d + dv = 256), which leaves no
// room for 32 queries' S^T and dP^T without spills
template <int D, int DV>
struct SubTile {
  static constexpr int value = D + DV >= 256 ? 16 : 32;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b: m16n8k16, bf16 operands, fp32 accumulator.  a is 16 x 16 (a0
// (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)); b is
// 16 x 8 (b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)); c is 16 x 8 (c0, c1
// (g, 2t..2t+1), c2, c3 (g+8, 2t..)); g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the A operand (16 x 16, rows r0.., columns c0.. of a row-major tile of
// row stride S) for ldsm4: matrices (rows 0-7 | 8-15) x (columns 0-7 | 8-15)
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int S, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * S + c0 + ((lane >> 4) << 3);
}
// B operands of two n-tiles (n0.. and n0 + 8..) over k0 .. k0 + 15 from a
// row-major tile whose rows are n and columns k (ldsm4: r0, r1 the first
// n-tile's b0, b1; r2, r3 the second's)
__device__ __forceinline__ const bf16* b_addr(const bf16* tile, int S, int n0, int k0, int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * S + k0 + (((lane >> 3) & 1) << 3);
}
// the same from a tile whose rows are k and columns n (ldsm4_t)
__device__ __forceinline__ const bf16* bt_addr(const bf16* tile, int S, int k0, int n0, int lane) {
  return tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * S + n0 + ((lane >> 4) << 3);
}

__device__ __forceinline__ uint32_t pack(float lo_col, float hi_col) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// x and y as hi = bf16 pairs and lo = bf16(x - hi.x, y - hi.y)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(x - __low2float(h), y - __high2float(h));
}
// two adjacent 16 x 8 accumulator tiles (columns 0-7 and 8-15) as the
// 16 x 16 A operand, each entry x as hi = bf16(x) and lo = bf16(x - hi)
__device__ __forceinline__ void split_a(const float (&c0)[4], const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// rows row0 .. row0 + ROWS - 1 of src (COLS bf16 each) into dst at row
// stride S, 16 bytes per cp.async; zeros beyond row n - 1 and in the
// padding columns COLS .. CP - 1
template <int ROWS, int COLS, int CP>
__device__ __forceinline__ void load_rows(bf16* dst, int S, const bf16* src, int row0, int n) {
  constexpr int C8 = CP / 8;
  for (int x = threadIdx.x; x < ROWS * C8; x += kThreads) {
    const int r = x / C8, c = (x - r * C8) * 8, row = row0 + r;
    const bool ok = row < n && c < COLS;
    cp_async16(dst + r * S + c, src + (ok ? (size_t)row * COLS + c : 0), ok ? 16 : 0);
  }
}
// 64 floats of src from row0 (zeros beyond n - 1), 4 bytes per cp.async
__device__ __forceinline__ void load_floats(float* dst, const float* src, int row0, int n) {
  for (int x = threadIdx.x; x < kTile; x += kThreads) {
    const bool ok = row0 + x < n;
    cp_async4(dst + x, src + (ok ? row0 + x : 0), ok ? 4 : 0);
  }
}

// Shared memory, in bf16 elements: the block's own two operands (kRows
// rows: K and V in (b), Q and dO in (c)), two ring stages of the loop's
// two (kTile rows: Q and dO in (b), K and V in (c)), then fp32 lse and D
// (a 64-row tile of each per stage in (b), the block's rows in (c)).
template <int D, int DV>
struct Layout {
  static constexpr int DP = (D + 15) / 16 * 16;  // d padded to mma's k (24 -> 32)
  static constexpr int SK = DP + 8, SV = DV + 8;  // row strides (16 bytes of padding)
  static constexpr int own = kRows * (SK + SV);
  static constexpr int stage = kTile * (SK + SV);
  static constexpr int floats = own + 2 * stage;  // offset of the floats
  static constexpr size_t bytes = 2 * (size_t)floats + sizeof(float) * 2 * 2 * kTile;
};

// (b) dK and dV of one (batch x kv-head, 64-key tile)
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 2) window_bwd_dkdv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int BHkv, int H, int Hkv, int n_q, int n_k,
    int window, int causal, float scale) {
  using Lay = Layout<D, DV>;
  constexpr int DP = Lay::DP, SK = Lay::SK, SV = Lay::SV;
  constexpr int NK = DP / 8, NV = DV / 8;  // n-tiles of dK and dV
  constexpr int SUB = SubTile<D, DV>::value;
  constexpr int NH = SUB / 8;              // n-tiles of S^T and dP^T (a sub-tile's queries)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = sm;
  bf16* Vs = Ks + kRows * SK;
  float* fl = reinterpret_cast<float*>(sm + Lay::floats);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int kt = (int)(blockIdx.x / BHkv), bkv = (int)(blockIdx.x % BHkv);
  const int b = bkv / Hkv, kvh = bkv % Hkv, G = H / Hkv;
  const int j0 = kt * kRows;
  const float sc2 = scale * kLog2e;

  load_rows<kRows, D, DP>(Ks, SK, k + (size_t)bkv * n_k * D, j0, n_k);
  load_rows<kRows, DV, DV>(Vs, SV, v + (size_t)bkv * n_k * DV, j0, n_k);
  // query rows that see a key of the tile: causal [j0, min(n, j0 + 63 + W)),
  // non-causal every row [0, n_q)
  const int i_end =
      causal ? (int)min((long long)n_q, (long long)j0 + kRows - 1 + window) : n_q;
  const int it0 = causal ? j0 / kTile : 0, nit = (i_end + kTile - 1) / kTile - it0;
  const int steps = G * nit;
  auto issue = [&](int s) {  // step s: head g = s / nit, query tile it0 + s % nit
    const int st = s & 1, i0 = (it0 + s % nit) * kTile;
    const size_t bh = (size_t)b * H + (size_t)kvh * G + s / nit;
    bf16* Qs = sm + Lay::own + st * Lay::stage;
    load_rows<kTile, D, DP>(Qs, SK, q + bh * n_q * D, i0, n_q);
    load_rows<kTile, DV, DV>(Qs + kTile * SK, SV, dout + bh * n_q * DV, i0, n_q);
    load_floats(fl + st * 2 * kTile, lse + bh * n_q, i0, n_q);
    load_floats(fl + st * 2 * kTile + kTile, dd + bh * n_q, i0, n_q);
    cp_async_commit();
  };
  issue(0);  // K and V join the first tile's group

  float adk[NK][4], adv[NV][4];
#pragma unroll
  for (int j = 0; j < NK; ++j) adk[j][0] = adk[j][1] = adk[j][2] = adk[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) adv[j][0] = adv[j][1] = adv[j][2] = adv[j][3] = 0.f;
  const int kw0 = j0 + 16 * warp;  // this warp's first key
  const int key0 = kw0 + g8, key1 = key0 + 8;  // this lane's two keys (accumulator rows)

  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // step s has landed for every thread; step s - 1 is retired
    if (s + 1 < steps) issue(s + 1);
    const int st = s & 1, i0 = (it0 + s % nit) * kTile;
    const bf16* Qs = sm + Lay::own + st * Lay::stage;
    const bf16* Os = Qs + kTile * SK;
    const float* Ls = fl + st * 2 * kTile;
    const float* Ds = Ls + kTile;
#pragma unroll 1
    for (int h = 0; h < kTile / SUB; ++h) {
      const int q0 = i0 + h * SUB, ql = h * SUB;  // the sub-tile's first query
      // warp-uniform: the sub-tile's queries meet this warp's keys (inside the
      // band when causal); "full": no entry of the sub-tile is masked
      if (kw0 >= n_k || q0 >= n_q ||
          (causal && (q0 + SUB - 1 < kw0 || q0 - (kw0 + 15) >= window)))
        continue;
      const bool full = causal ? q0 >= kw0 + 15 && q0 + SUB - 1 - kw0 < window && q0 + SUB <= n_q
                               : q0 + SUB <= n_q && kw0 + 16 <= n_k;

      // ---- S^T = K Q^T and dP^T = V dO^T (16 keys x SUB queries) ----
      float s_[NH][4], dp[NH][4];
#pragma unroll
      for (int j = 0; j < NH; ++j)
        s_[j][0] = s_[j][1] = s_[j][2] = s_[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4];
        ldsm4(a, a_addr(Ks, SK, 16 * warp, 16 * kk, lane));
#pragma unroll
        for (int jp = 0; jp < NH / 2; ++jp) {
          uint32_t bq[4];
          ldsm4(bq, b_addr(Qs, SK, ql + 16 * jp, 16 * kk, lane));
          mma(s_[2 * jp], a, bq[0], bq[1]);
          mma(s_[2 * jp + 1], a, bq[2], bq[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        uint32_t a[4];
        ldsm4(a, a_addr(Vs, SV, 16 * warp, 16 * kk, lane));
#pragma unroll
        for (int jp = 0; jp < NH / 2; ++jp) {
          uint32_t bo[4];
          ldsm4(bo, b_addr(Os, SV, ql + 16 * jp, 16 * kk, lane));
          mma(dp[2 * jp], a, bo[0], bo[1]);
          mma(dp[2 * jp + 1], a, bo[2], bo[3]);
        }
      }

      // ---- P^T = exp(S^T / sqrt(d) - lse) in the band, dS^T = P^T (dP^T - D) ----
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const int c = ql + 8 * j + 2 * t4;  // this lane's two queries, in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(Ls + c);
        const float2 d2 = *reinterpret_cast<const float2*>(Ds + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = i0 + c + (e & 1), key = e < 2 ? key0 : key1;
          const float lq = (e & 1) ? l2.y : l2.x, del = (e & 1) ? d2.y : d2.x;
          float p = exp2f(fmaf(s_[j][e], sc2, -lq * kLog2e));
          if (!full && !(qi < n_q && (causal ? key <= qi && qi - key < window : key < n_k)))
            p = 0.f;
          s_[j][e] = p;
          dp[j][e] = p * (dp[j][e] - del);
        }
      }

      // ---- dV += P^T dO and dK += dS^T Q, P and dS as hi + lo ----
#pragma unroll
      for (int ks = 0; ks < NH / 2; ++ks) {
        uint32_t hi[4], lo[4];
        split_a(s_[2 * ks], s_[2 * ks + 1], hi, lo);
#pragma unroll
        for (int np = 0; np < DV / 16; ++np) {
          uint32_t bo[4];
          ldsm4_t(bo, bt_addr(Os, SV, ql + 16 * ks, 16 * np, lane));
          mma(adv[2 * np], lo, bo[0], bo[1]);
          mma(adv[2 * np + 1], lo, bo[2], bo[3]);
          mma(adv[2 * np], hi, bo[0], bo[1]);
          mma(adv[2 * np + 1], hi, bo[2], bo[3]);
        }
        split_a(dp[2 * ks], dp[2 * ks + 1], hi, lo);
#pragma unroll
        for (int np = 0; np < DP / 16; ++np) {
          uint32_t bq[4];
          ldsm4_t(bq, bt_addr(Qs, SK, ql + 16 * ks, 16 * np, lane));
          mma(adk[2 * np], lo, bq[0], bq[1]);
          mma(adk[2 * np + 1], lo, bq[2], bq[3]);
          mma(adk[2 * np], hi, bq[0], bq[1]);
          mma(adk[2 * np + 1], hi, bq[2], bq[3]);
        }
      }
    }
  }

  // ---- dK / sqrt(d) and dV, in bf16 (the padding columns of d are dropped) ----
  bf16* dkb = dk + (size_t)bkv * n_k * D + 2 * t4;
  bf16* dvb = dv + (size_t)bkv * n_k * DV + 2 * t4;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    if (8 * j >= D) continue;
    if (key0 < n_k) *reinterpret_cast<uint32_t*>(dkb + (size_t)key0 * D + 8 * j) =
        pack(adk[j][0] * scale, adk[j][1] * scale);
    if (key1 < n_k) *reinterpret_cast<uint32_t*>(dkb + (size_t)key1 * D + 8 * j) =
        pack(adk[j][2] * scale, adk[j][3] * scale);
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (key0 < n_k) *reinterpret_cast<uint32_t*>(dvb + (size_t)key0 * DV + 8 * j) =
        pack(adv[j][0], adv[j][1]);
    if (key1 < n_k) *reinterpret_cast<uint32_t*>(dvb + (size_t)key1 * DV + 8 * j) =
        pack(adv[j][2], adv[j][3]);
  }
}

// (c) dQ of one (batch x head, 64-row query tile)
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 2) window_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
    bf16* __restrict__ dq, int BH, int H, int Hkv, int n_q, int n_k, int window, int causal,
    float scale) {
  using Lay = Layout<D, DV>;
  constexpr int DP = Lay::DP, SK = Lay::SK, SV = Lay::SV;
  constexpr int NK = DP / 8;    // n-tiles of dQ
  constexpr int NS = kTile / 8;  // n-tiles of S and dP (a ring tile's keys)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* Qs = sm;
  bf16* Os = Qs + kRows * SK;
  float* fl = reinterpret_cast<float*>(sm + Lay::floats);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int nqt = (n_q + kRows - 1) / kRows;
  const int it = nqt - 1 - (int)(blockIdx.x / BH);  // the longest bands first
  const size_t bh = blockIdx.x % BH;
  const size_t kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int i0 = it * kRows;
  const float sc2 = scale * kLog2e;
  const bf16* kb = k + kvh * n_k * D;
  const bf16* vb = v + kvh * n_k * DV;

  load_rows<kRows, D, DP>(Qs, SK, q + bh * n_q * D, i0, n_q);
  load_rows<kRows, DV, DV>(Os, SV, dout + bh * n_q * DV, i0, n_q);
  load_floats(fl, lse + bh * n_q, i0, n_q);
  load_floats(fl + kTile, dd + bh * n_q, i0, n_q);
  // keys that a row of the tile sees: causal [max(0, i0 - W + 1), min(n, i0
  // + 64)), non-causal every key [0, n_k)
  const int j_first = causal ? max(0, i0 - window + 1) : 0;
  const int j_end = causal ? min(n_k, i0 + kRows) : n_k;
  const int jt0 = j_first / kTile, jt1 = (j_end + kTile - 1) / kTile;
  auto issue = [&](int jt) {
    bf16* Kt = sm + Lay::own + ((jt - jt0) & 1) * Lay::stage;
    load_rows<kTile, D, DP>(Kt, SK, kb, jt * kTile, n_k);
    load_rows<kTile, DV, DV>(Kt + kTile * SK, SV, vb, jt * kTile, n_k);
    cp_async_commit();
  };
  issue(jt0);  // Q, dO, lse and D join the first tile's group

  float adq[NK][4];
#pragma unroll
  for (int j = 0; j < NK; ++j) adq[j][0] = adq[j][1] = adq[j][2] = adq[j][3] = 0.f;
  const int r0 = i0 + 16 * warp;         // this warp's first row
  const int ra = r0 + g8, rb = ra + 8;    // this lane's two rows
  float l2[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};  // this lane's rows' lse (log2) and D

  for (int jt = jt0; jt < jt1; ++jt) {
    cp_async_wait_all();
    __syncthreads();  // tile jt has landed for every thread; tile jt - 1 is retired
    if (jt + 1 < jt1) issue(jt + 1);
    if (jt == jt0) {
      l2[0] = fl[16 * warp + g8] * kLog2e;
      l2[1] = fl[16 * warp + g8 + 8] * kLog2e;
      dr[0] = fl[kTile + 16 * warp + g8];
      dr[1] = fl[kTile + 16 * warp + g8 + 8];
    }
    const int j0 = jt * kTile;
    // warp-uniform: this warp's rows exist and (causal) meet the tile inside the band
    if (r0 >= n_q || (causal && (j0 > r0 + 15 || r0 - (j0 + kTile - 1) >= window))) continue;
    const bool full = causal ? j0 + kTile - 1 <= r0 && r0 + 15 - j0 < window && r0 + 16 <= n_q
                             : j0 + kTile <= n_k && r0 + 16 <= n_q;
    const bf16* Kt = sm + Lay::own + ((jt - jt0) & 1) * Lay::stage;
    const bf16* Vt = Kt + kTile * SK;

    // ---- S = Q K^T and dP = dO V^T (16 rows x 64 keys) ----
    float s_[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
      s_[j][0] = s_[j][1] = s_[j][2] = s_[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldsm4(a, a_addr(Qs, SK, 16 * warp, 16 * kk, lane));
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t bk[4];
        ldsm4(bk, b_addr(Kt, SK, 16 * jp, 16 * kk, lane));
        mma(s_[2 * jp], a, bk[0], bk[1]);
        mma(s_[2 * jp + 1], a, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      uint32_t a[4];
      ldsm4(a, a_addr(Os, SV, 16 * warp, 16 * kk, lane));
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t bv[4];
        ldsm4(bv, b_addr(Vt, SV, 16 * jp, 16 * kk, lane));
        mma(dp[2 * jp], a, bv[0], bv[1]);
        mma(dp[2 * jp + 1], a, bv[2], bv[3]);
      }
    }

    // ---- dS = P (dP - D), P = exp(S / sqrt(d) - lse) in the band ----
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, row = r ? rb : ra, key = j0 + 8 * j + 2 * t4 + (e & 1);
        float p = exp2f(fmaf(s_[j][e], sc2, -l2[r]));
        if (!full && !(row < n_q && (causal ? key <= row && row - key < window : key < n_k)))
          p = 0.f;
        dp[j][e] = p * (dp[j][e] - dr[r]);
      }

    // ---- dQ += dS K, dS as hi + lo ----
#pragma unroll
    for (int ks = 0; ks < NS / 2; ++ks) {
      uint32_t hi[4], lo[4];
      split_a(dp[2 * ks], dp[2 * ks + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t bk[4];
        ldsm4_t(bk, bt_addr(Kt, SK, 16 * ks, 16 * np, lane));
        mma(adq[2 * np], lo, bk[0], bk[1]);
        mma(adq[2 * np + 1], lo, bk[2], bk[3]);
        mma(adq[2 * np], hi, bk[0], bk[1]);
        mma(adq[2 * np + 1], hi, bk[2], bk[3]);
      }
    }
  }

  // ---- dQ / sqrt(d), in bf16 ----
  bf16* dqb = dq + bh * n_q * D + 2 * t4;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    if (8 * j >= D) continue;
    if (ra < n_q) *reinterpret_cast<uint32_t*>(dqb + (size_t)ra * D + 8 * j) =
        pack(adq[j][0] * scale, adq[j][1] * scale);
    if (rb < n_q) *reinterpret_cast<uint32_t*>(dqb + (size_t)rb * D + 8 * j) =
        pack(adq[j][2] * scale, adq[j][3] * scale);
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* dout, void* dq, void* dk, void* dv, float* dd, int BH, int H, int Hkv,
           int n_q, int n_k, int window, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<D, DV>::bytes;
  static_assert(smem <= 227 * 1024, "shared memory beyond what a block may use");
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  const int BHkv = BH / (H / Hkv);
  const long long ntq = (n_q + kRows - 1) / kRows, ntk = (n_k + kRows - 1) / kRows;
  const long long rows = (long long)BH * n_q;
  const long long blocks_a = (rows + 7) / 8;
  if (blocks_a > 0x7FFFFFFFLL || ntq * BH > 0x7FFFFFFFLL || ntk * BHkv > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const void* kernels[] = {(const void*)window_bwd_dkdv_tc_kernel<D, DV>,
                           (const void*)window_bwd_dq_tc_kernel<D, DV>};
  for (const void* fn : kernels) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)  // room for two blocks an SM
      err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return (int)err;
  window_bwd_rowdot_kernel<bf16, DV><<<(unsigned)blocks_a, 256, 0, stream>>>(
      static_cast<const bf16*>(o), tdo, dd, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  window_bwd_dkdv_tc_kernel<D, DV><<<(unsigned)(ntk * BHkv), kThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, dd, static_cast<bf16*>(dk), static_cast<bf16*>(dv), BHkv, H, Hkv,
      n_q, n_k, window, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  window_bwd_dq_tc_kernel<D, DV><<<(unsigned)(ntq * BH), kThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, dd, static_cast<bf16*>(dq), BH, H, Hkv, n_q, n_k, window, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32: CUDA-core kernels
// ---------------------------------------------------------------------------

namespace fp {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // query rows and keys per tile
constexpr int kSP = kTile + 4;  // row stride of the P^T / dS tiles

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float get(float4 a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// rows row0 .. row0 + 63 of src (COLS elements each) into dst, at a row
// stride of COLS + 4 words; zeros beyond row n - 1
template <int COLS>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0, int n) {
  constexpr int C4 = COLS / 4, S = COLS + 4;
  for (int x = threadIdx.x; x < kTile * C4; x += kThreads) {
    const int r = x / C4, c = (x - r * C4) * 4, row = row0 + r;
    const float4 val = row < n ? load4(src + (size_t)row * COLS + c) : make_float4(0, 0, 0, 0);
    *reinterpret_cast<float4*>(dst + r * S + c) = val;
  }
}

// acc[i][u] += sum_c A[ty + 16 i][c] B[tx + 16 u][c] over c < K: a 64 x 64
// product of two row-major tiles (row stride K + 4)
template <int K>
__device__ __forceinline__ void tile_abt(float (&acc)[4][4], const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int S = K + 4;
#pragma unroll 4
  for (int c = 0; c < K; c += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = load4(A + (ty + 16 * i) * S + c);
#pragma unroll
    for (int u = 0; u < 4; ++u) b[u] = load4(B + (tx + 16 * u) * S + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = dot4(a[i], b[u], acc[i][u]);
  }
}

// acc[i][u] += sum_r M[ty + 16 i][r] X[r][tx + 16 u] over the 64 r of a
// tile: M a 64 x 64 tile (row stride kSP), X a row-major tile of COLS
// columns (row stride COLS + 4); columns at or beyond COLS are skipped
template <int COLS>
__device__ __forceinline__ void tile_mx(float (&acc)[4][(COLS + 15) / 16], const float* M,
                                        const float* X, int ty, int tx) {
  constexpr int NU = (COLS + 15) / 16, S = COLS + 4;
#pragma unroll 2
  for (int r = 0; r < kTile; r += 4) {
    float4 m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = load4(M + (ty + 16 * i) * kSP + r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        if (COLS % 16 == 0 || tx + 16 * u < COLS) {
          const float x = X[(r + e) * S + tx + 16 * u];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][u] = fmaf(get(m[i], e), x, acc[i][u]);
        }
      }
    }
  }
}

// writes acc[i][u] * scale to rows row0 + ty + 16 i (< n), columns
// tx + 16 u (< COLS) of dst (row-major, COLS columns)
template <int COLS>
__device__ __forceinline__ void write_tile(float* dst, const float (&acc)[4][(COLS + 15) / 16],
                                           int row0, int n, float scale, int ty, int tx) {
  constexpr int NU = (COLS + 15) / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int u = 0; u < NU; ++u)
      if (COLS % 16 == 0 || tx + 16 * u < COLS)
        dst[(size_t)row * COLS + tx + 16 * u] = acc[i][u] * scale;
  }
}

template <int D, int DV>
struct Layout {
  static constexpr int K = 0;                      // K tile, 64 x (D + 4)
  static constexpr int V = K + kTile * (D + 4);    // V tile, 64 x (DV + 4)
  static constexpr int Q = V + kTile * (DV + 4);   // Q tile
  static constexpr int O = Q + kTile * (D + 4);    // dO tile
  static constexpr int P = O + kTile * (DV + 4);   // P^T (dkdv) or unused (dq)
  static constexpr int S = P + kTile * kSP;        // dS^T (dkdv) or dS (dq)
  static constexpr int L = S + kTile * kSP;        // lse (log2 domain), 64
  static constexpr int DD = L + kTile;             // D, 64
  static constexpr int total = DD + kTile;
  static constexpr size_t bytes = sizeof(float) * (size_t)total;
};

// (b) dK and dV of one (batch x kv-head, 64-key tile)
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1) window_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
    float* __restrict__ dk, float* __restrict__ dv, int BHkv, int H, int Hkv, int n_q, int n_k,
    int window, int causal, float scale) {
  using Lay = Layout<D, DV>;
  constexpr int NUK = (D + 15) / 16, NUV = (DV + 15) / 16;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kt = (int)(blockIdx.x / BHkv), bkv = (int)(blockIdx.x % BHkv);
  const int b = bkv / Hkv, kvh = bkv % Hkv, G = H / Hkv;
  const int j0 = kt * kTile;
  const float sc2 = scale * kLog2e;

  stage<D>(sm + Lay::K, k + (size_t)bkv * n_k * D, j0, n_k);
  stage<DV>(sm + Lay::V, v + (size_t)bkv * n_k * DV, j0, n_k);

  float adk[4][NUK], adv[4][NUV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int u = 0; u < NUK; ++u) adk[i][u] = 0.f;
#pragma unroll
    for (int u = 0; u < NUV; ++u) adv[i][u] = 0.f;
  }
  // query rows that see a key of the tile: causal [j0, min(n, j0 + 63 + W)),
  // non-causal every row [0, n_q)
  const int i_end =
      causal ? (int)min((long long)n_q, (long long)j0 + kTile - 1 + window) : n_q;
  const int it0 = causal ? j0 / kTile : 0, it1 = (i_end + kTile - 1) / kTile;
  for (int g = 0; g < G; ++g) {
    const size_t bh = (size_t)b * H + (size_t)kvh * G + g;
    for (int it = it0; it < it1; ++it) {
      const int i0 = it * kTile;
      __syncthreads();  // the previous tile's Q, dO, P^T and dS^T are retired
      stage<D>(sm + Lay::Q, q + bh * n_q * D, i0, n_q);
      stage<DV>(sm + Lay::O, dout + bh * n_q * DV, i0, n_q);
      if (tid < kTile) {
        const int row = i0 + tid;
        sm[Lay::L + tid] = row < n_q ? lse[bh * n_q + row] * kLog2e : 0.f;
        sm[Lay::DD + tid] = row < n_q ? dd[bh * n_q + row] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T: keys j0 + ty + 16 i, queries i0 + tx + 16 u
      float s[4][4] = {}, dp[4][4] = {};
      tile_abt<D>(s, sm + Lay::K, sm + Lay::Q, ty, tx);
      tile_abt<DV>(dp, sm + Lay::V, sm + Lay::O, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int jl = ty + 16 * i, il = tx + 16 * u;
          const int jj = j0 + jl, ii = i0 + il;
          const bool in = ii < n_q && (causal ? jj <= ii && ii - jj < window : jj < n_k);
          const float p = in ? exp2f(fmaf(s[i][u], sc2, -sm[Lay::L + il])) : 0.f;
          sm[Lay::P + jl * kSP + il] = p;
          sm[Lay::S + jl * kSP + il] = p * (dp[i][u] - sm[Lay::DD + il]);
        }
      __syncthreads();
      tile_mx<DV>(adv, sm + Lay::P, sm + Lay::O, ty, tx);
      tile_mx<D>(adk, sm + Lay::S, sm + Lay::Q, ty, tx);
    }
  }
  write_tile<D>(dk + (size_t)bkv * n_k * D, adk, j0, n_k, scale, ty, tx);
  write_tile<DV>(dv + (size_t)bkv * n_k * DV, adv, j0, n_k, 1.f, ty, tx);
}

// (c) dQ of one (batch x head, 64-row query tile)
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1) window_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
    float* __restrict__ dq, int BH, int H, int Hkv, int n_q, int n_k, int window, int causal,
    float scale) {
  using Lay = Layout<D, DV>;
  constexpr int NUK = (D + 15) / 16;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nqt = (n_q + kTile - 1) / kTile;
  const int it = nqt - 1 - (int)(blockIdx.x / BH);  // the longest bands first
  const size_t bh = blockIdx.x % BH;
  const size_t kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int i0 = it * kTile;
  const float sc2 = scale * kLog2e;

  stage<D>(sm + Lay::Q, q + bh * n_q * D, i0, n_q);
  stage<DV>(sm + Lay::O, dout + bh * n_q * DV, i0, n_q);
  if (tid < kTile) {
    const int row = i0 + tid;
    sm[Lay::L + tid] = row < n_q ? lse[bh * n_q + row] * kLog2e : 0.f;
    sm[Lay::DD + tid] = row < n_q ? dd[bh * n_q + row] : 0.f;
  }
  float adq[4][NUK];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < NUK; ++u) adq[i][u] = 0.f;
  // keys that a row of the tile sees: causal [max(0, i0 - W + 1), min(n, i0
  // + 64)), non-causal every key [0, n_k)
  const int j_first = causal ? max(0, i0 - window + 1) : 0;
  const int j_end = causal ? min(n_k, i0 + kTile) : n_k;
  const int jt0 = j_first / kTile, jt1 = (j_end + kTile - 1) / kTile;
  for (int jt = jt0; jt < jt1; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();  // the previous tile's K, V and dS are retired
    stage<D>(sm + Lay::K, k + kvh * n_k * D, j0, n_k);
    stage<DV>(sm + Lay::V, v + kvh * n_k * DV, j0, n_k);
    __syncthreads();
    // S and dP: queries i0 + ty + 16 i, keys j0 + tx + 16 u
    float s[4][4] = {}, dp[4][4] = {};
    tile_abt<D>(s, sm + Lay::Q, sm + Lay::K, ty, tx);
    tile_abt<DV>(dp, sm + Lay::O, sm + Lay::V, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int il = ty + 16 * i, jl = tx + 16 * u;
        const int ii = i0 + il, jj = j0 + jl;
        const bool in = ii < n_q && (causal ? jj <= ii && ii - jj < window : jj < n_k);
        const float p = in ? exp2f(fmaf(s[i][u], sc2, -sm[Lay::L + il])) : 0.f;
        sm[Lay::S + il * kSP + jl] = p * (dp[i][u] - sm[Lay::DD + il]);
      }
    __syncthreads();
    tile_mx<D>(adq, sm + Lay::S, sm + Lay::K, ty, tx);
  }
  write_tile<D>(dq + bh * n_q * D, adq, i0, n_q, scale, ty, tx);
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* dout, void* dq, void* dk, void* dv, float* dd, int BH, int H, int Hkv,
           int n_q, int n_k, int window, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<D, DV>::bytes;
  static_assert(smem <= 227 * 1024, "shared memory beyond what a block may use");
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const int BHkv = BH / (H / Hkv);
  const long long ntq = (n_q + kTile - 1) / kTile, ntk = (n_k + kTile - 1) / kTile;
  const long long rows = (long long)BH * n_q;
  const long long blocks_a = (rows + 7) / 8;
  if (blocks_a > 0x7FFFFFFFLL || ntq * BH > 0x7FFFFFFFLL || ntk * BHkv > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_bwd_dkdv_kernel<D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(window_bwd_dq_kernel<D, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_bwd_rowdot_kernel<float, DV><<<(unsigned)blocks_a, 256, 0, stream>>>(
      static_cast<const float*>(o), tdo, dd, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  window_bwd_dkdv_kernel<D, DV><<<(unsigned)(ntk * BHkv), kThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, dd, static_cast<float*>(dk), static_cast<float*>(dv), BHkv, H, Hkv,
      n_q, n_k, window, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  window_bwd_dq_kernel<D, DV><<<(unsigned)(ntq * BH), kThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, dd, static_cast<float*>(dq), BH, H, Hkv, n_q, n_k, window, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace fp

int launch_dims(const void* q, const void* k, const void* v, const void* o, const float* lse,
                const void* dout, void* dq, void* dk, void* dv, float* dd, int BH, int H,
                int Hkv, int n_q, int n_k, int d, int dvw, int window, int causal, float scale,
                bool bf16, cudaStream_t s) {
#define WB_DIMS(D, DV)                                                                         \
  if (d == D && dvw == DV)                                                                     \
    return bf16 ? tc::launch<D, DV>(q, k, v, o, lse, dout, dq, dk, dv, dd, BH, H, Hkv, n_q, n_k, \
                                    window, causal, scale, s)                                  \
                : fp::launch<D, DV>(q, k, v, o, lse, dout, dq, dk, dv, dd, BH, H, Hkv, n_q, n_k, \
                                    window, causal, scale, s);
  WB_DIMS(64, 64)
  WB_DIMS(64, 128)
  WB_DIMS(128, 64)
  WB_DIMS(128, 128)
  WB_DIMS(16, 16)
  WB_DIMS(32, 32)
  WB_DIMS(96, 64)
  WB_DIMS(24, 16)
#undef WB_DIMS
  return (int)cudaErrorInvalidValue;
}

int checked(const void* q, const void* k, const void* v, const void* o, const void* lse,
            const void* dout, void* dq, void* dk, void* dv, void* dd, int BH, int H, int Hkv,
            int n_q, int n_k, int d, int dvw, int window, int causal, float scale, int bf16,
            void* stream) {
  if (BH <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || BH % H != 0 || n_q <= 0 || n_k <= 0 ||
      window <= 0)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, o, lse, dout, dq, dk, dv, dd};
  for (const void* p : ptrs)
    if (!p || ((uintptr_t)p & 15)) return (int)cudaErrorInvalidValue;
  return launch_dims(q, k, v, o, static_cast<const float*>(lse), dout, dq, dk, dv,
                     static_cast<float*>(dd), BH, H, Hkv, n_q, n_k, d, dvw, window, causal, scale,
                     bf16 != 0, (cudaStream_t)stream);
}

}  // namespace

// dd is the caller's fp32 scratch of B*H*T entries (D of kernel (a)).
extern "C" int window_attention_bwd_launch(const void* q, const void* k, const void* v,
                                           const void* o, const void* lse, const void* dout,
                                           void* dq, void* dk, void* dv, void* dd, int BH, int H,
                                           int Hkv, int n, int d, int dvw, int window,
                                           float scale, int bf16, void* stream) {
  return checked(q, k, v, o, lse, dout, dq, dk, dv, dd, BH, H, Hkv, n, n, d, dvw, window, 1,
                 scale, bf16, stream);
}

// The non-causal mode: q, o, do (BH, n_q, d | dv) and lse (BH, n_q) of the
// forward's non-causal mode, k (BH/G, n_k, d), v (BH/G, n_k, dv); dd is the
// caller's fp32 scratch of BH*n_q entries.
extern "C" int window_attention_noncausal_bwd_launch(const void* q, const void* k, const void* v,
                                                     const void* o, const void* lse,
                                                     const void* dout, void* dq, void* dk,
                                                     void* dv, void* dd, int BH, int H, int Hkv,
                                                     int n_q, int n_k, int d, int dvw,
                                                     float scale, int bf16, void* stream) {
  return checked(q, k, v, o, lse, dout, dq, dk, dv, dd, BH, H, Hkv, n_q, n_k, d, dvw, 1, 0,
                 scale, bf16, stream);
}
