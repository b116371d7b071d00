// Causal sliding-window softmax attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/window_attention/kernel.py::window_attention_pallas
// (pallas_call at :111, body _kernel at :35).  Row i of a (batch x head)
// attends to the keys j with 0 <= i - j < W, with scale 1/sqrt(d), an
// online softmax (running max, sum and accumulator) in fp32, and the output
// in the inputs' type: the function of window_attention/ref.py.  When the
// caller passes an lse pointer (training), each row's log-sum-exp of its
// scaled scores, log sum_j exp(q_i k_j / sqrt(d)), is written there in fp32
// once the row is done: the backward (window_attention_bwd.cu) recomputes
// the probabilities from it.  Serving passes null and writes nothing.  K and V
// are read per kv-head (kv-head = head / (H / Hkv)) instead of the
// reference's jnp.repeat to the query-head count (models/attention.py:
// 116-118): the same function, with a quarter of the K/V bytes at
// Mixtral's 32 heads over 8 kv-heads.
//
// Bound on an H100 at the serve path's prefill (B 4 x H 32, T 8192, W
// 4096, d = dv = 128, fp32): 1.65 TFLOP for QK^T and PV over the 25.2 M
// in-band pairs of each head.  On the fp32 CUDA cores that is 24.6 ms at
// 67 TFLOP/s, which a first design (every product on CUDA cores out of
// shared memory) reached at 35 % (70.5 ms).  Here both products run on the
// tensor cores in split fp32 (3xTF32, split_fp32.cuh): 4.95 TFLOP of TF32
// work, 10.0 ms at 495 TFLOP/s, against ~1.3 GB of q, k, v and o (~0.4 ms):
// operations bound it.  One TF32 pass is beyond the fp32 tolerance the
// kernel is held to; the split is within it.
//
// Design.  One block of 8 warps owns 128 query rows of one (batch x head)
// and walks, in a loop, only the 64-key tiles that meet its band [i0 - W +
// 1, i0 + 128); warp w owns rows i0 + 16 w .. + 15 and skips the tiles
// outside its own band.  Blocks are ordered longest first (row blocks from
// the end of the sequence, whose bands are full), and within a row block
// the query heads that share a kv-head are neighbours, so their K and V
// tiles are read from device memory about once and then from L2.
//   * Staging: Q once, then K and V tiles in a two-stage ring filled by
//     16-byte cp.async (rows beyond T zero-filled), so tile t + 1 loads
//     while tile t is in the products.  Row strides of d + 16 bytes keep
//     every fragment load free of bank conflicts.  bf16 inputs are staged
//     as they are and widened to fp32 as fragments are read; they take the
//     same split path (their low halves are zero).
//   * S = Q K^T: m16n8k8 mma.sync, 16 rows x 64 keys per warp, operands
//     read from shared memory one k-step ahead of their products and split
//     as they are read.
//   * Online softmax on the fp32 cores, in the log2 domain (scale * log2 e
//     folded into one FMA before exp2).  The band is evaluated only on the
//     tiles that cross it (the first tile of a band, the diagonal and the
//     ragged right edge); a row whose tile is fully masked keeps the -1e30
//     guard, so exp2(m - m_new) never sees -inf - -inf.  Row sums stay per
//     lane until the end.
//   * O += P V: the scores' accumulator tile is the A operand as it stands,
//     with the keys of the k-step permuted (A column t -> key 2t, t + 4 ->
//     key 2t + 1; V's rows read the same way), so P never leaves registers.
//     Each tile's products go to a fresh accumulator (half of dv at a time)
//     that is added to O with fp32 adds: the tensor cores truncate when they
//     sum, and PV sums over up to W keys.
// What holds it back (seen on an H100 by removing one part at a time): at
// 25.2 ms the kernel is 2.5x its bound.  With one TF32 pass instead of
// three it takes 12.7 ms, so each pass costs ~6.2 ms of mma.sync issue;
// without the split instructions (every warp splits every K and V element
// it reads) 21.6-22.4 ms; without the block barrier per tile 24.7-25.4 ms.
// The rest is the softmax, fragment loads and flushes, which the two warps
// that share a scheduler do not hide behind the products.  Splitting K and
// V once per block into shared memory needs
// hi and lo copies that, beside Q and a ring, do not fit the 227 KB; so
// does wgmma, which wants both in shared memory and V transposed.  Paired
// (8-byte) fragment loads, two query heads of a kv-head per block, skipping
// the masked 8-key blocks of edge tiles, a rolled QK^T loop, skipping O's
// rescale when no row's max moved, and extra fp32 flushes inside QK^T were
// each measured and were no faster.
//
// Full-causal softmax attention (models/attention.py's
// blockwise_softmax_attention, which JAX computes in jnp) runs here too, at
// W = T: with W >= T the band start max(0, i0 - W + 1) is 0, no tile is
// skipped for the window and every tile below the diagonal is "full".
//
// Non-causal mode (causal = 0; window_attention_noncausal_launch): the same
// kernel with n_q query rows against n_k keys of their own, every row
// seeing every key, for blockwise_softmax_attention(causal=False) (the
// encoder of whisper-tiny and its softmax cross-attention, Tq = 1 in
// decode; JAX computes them in jnp, models/attention.py:42, :89, no
// pallas_call).  A block walks every key tile of [0, n_k); the only masks
// are the ragged tail of keys (j >= n_k, zero-filled rows of the last tile)
// and rows >= n_q, which are computed on zeros and never stored.  A runtime
// argument, not a template axis, so the build instantiates no more
// kernels.  Bound at the encoder's shape (B 8 x H 6, T 1,536, d = dv = 64):
// 29 GFLOP of QK^T and PV against 38 MB (bf16) or 75 MB (fp32) of q, k, v
// and o, so operations bound it (0.03 ms at bf16's 989 TFLOP/s, 0.18 ms as
// three TF32 passes); this first version runs the causal mode's split-fp32
// products as they are, so bf16 inputs pay the three passes too.
//
// Contract (q, k, v, o and a non-null lse contiguous and 16-byte aligned;
// q, k, v, o all float32 or all bfloat16, lse float32):
//   q (B*H, T, d), k (B*Hkv, T, d), v (B*Hkv, T, dv) -> o (B*H, T, dv)
//   and, if lse is not null, lse (B*H, T); in the non-causal mode
//   q (B*H, Tq, d), k (B*Hkv, Tk, d), v (B*Hkv, Tk, dv) -> o (B*H, Tq, dv)
//   and, if lse is not null, lse (B*H, Tq) (training: the non-causal
//   backward in window_attention_bwd.cu reads it), any Tq, Tk >= 1
// Takes H % Hkv == 0, W >= 1 (W > T included), any T, and (d, dv) with d
// and dv in {64, 128}, d = dv in {16, 32} (the smoke configs' head widths:
// QK^T runs two or four k-steps, and PV one fresh accumulator of 2 or 4
// n-tiles), (96, 64) (MLA's materialized heads: qk_nope 64 + qk_rope 32,
// v 64; twelve k-steps of QK^T) or (24, 16) (MLA's smoke widths: three
// k-steps); anything else (dv 256 among them: its O accumulator alone
// would take 128 registers a thread) is cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_fp32.cuh"

namespace {

using namespace split_fp32;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBq = 16 * kWarps;  // query rows per block
constexpr int kBk = 64;           // keys per tile
constexpr int kStages = 2;        // K/V ring
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Shared-memory layout in elements of T: Q (kBq rows), then the K and V
// rings; row strides of 16 bytes more than a row.
template <typename T, int D, int DV>
struct Layout {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int SQ = D + kPad;  // Q and K rows
  static constexpr int SV = DV + kPad;
  static constexpr int K = kBq * SQ;
  static constexpr int V = K + kStages * kBk * SQ;
  static constexpr int total = V + kStages * kBk * SV;
  static constexpr size_t bytes = sizeof(T) * (size_t)total;
};

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, 1) window_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int BH, int H, int Hkv, int n_q, int n_k,
    int window, int causal, float sc) {
  using Lay = Layout<T, D, DV>;
  constexpr int SQ = Lay::SQ, SV = Lay::SV;
  constexpr int NT = DV / 8;                 // n-tiles of O
  constexpr int NTH = NT < 8 ? NT : 8;       // n-tiles of a fresh accumulator
  constexpr int NH = NT / NTH;               // halves of dv (one below 64), one each
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int nrb = (n_q + kBq - 1) / kBq;
  const int rb = nrb - 1 - (int)(blockIdx.x / BH);  // the longest row blocks first
  const int bh = (int)(blockIdx.x % BH);             // kv-head sharers side by side
  const int i0 = rb * kBq;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const T* qb = q + (size_t)bh * n_q * D;
  const T* kb = k + (size_t)kvh * n_k * D;
  const T* vb = v + (size_t)kvh * n_k * DV;

  // rows row0 .. row0 + ROWS - 1 of src (COLS elements each) into dst,
  // 16 bytes per cp.async, zeros beyond row n - 1
  auto load_rows = [&](T* dst, int sstride, const T* src, int cols, int row0, int rows, int n) {
    constexpr int E = 16 / sizeof(T);
    const int c16 = cols / E;
    for (int x = tid; x < rows * c16; x += kThreads) {
      const int r = x / c16, e = (x - r * c16) * E;
      const int row = row0 + r;
      const bool ok = row < n;
      cp_async16(dst + r * sstride + e, src + (size_t)(ok ? row : 0) * cols + e, ok ? 16 : 0);
    }
  };
  // the first key any row of the block sees, and one past the last
  const int j_first = causal ? max(0, i0 - window + 1) : 0;
  const int j_end = causal ? min(i0 + kBq, n_k) : n_k;
  const int jt0 = j_first / kBk, jt1 = (j_end + kBk - 1) / kBk;
  auto issue = [&](int jt) {
    const int st = jt % kStages;
    load_rows(smem + Lay::K + st * kBk * SQ, SQ, kb, D, jt * kBk, kBk, n_k);
    load_rows(smem + Lay::V + st * kBk * SV, SV, vb, DV, jt * kBk, kBk, n_k);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  load_rows(smem, SQ, qb, D, i0, kBq, n_q);  // Q joins the first tile's group
  issue(jt0);

  const int r0 = i0 + 16 * warp;  // this warp's first row
  const int ra = r0 + g8, rbw = ra + 8;  // this lane's two rows
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int jt = jt0; jt < jt1; ++jt) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // tile jt has landed for every thread; tile jt - 1 is retired
    if (jt + 1 < jt1) issue(jt + 1);
    const int j0 = jt * kBk;
    // warp-uniform: this warp's rows exist and (causal) meet the tile inside
    // the band; "full": no entry of the tile is masked for any of its rows
    if (r0 >= n_q || (causal && (j0 > r0 + 15 || r0 - (j0 + kBk - 1) >= window))) continue;
    const bool full = causal ? j0 + kBk - 1 <= r0 && r0 + 15 - j0 < window : j0 + kBk <= n_k;
    const T* Ks = smem + Lay::K + (jt % kStages) * kBk * SQ;
    const T* Vs = smem + Lay::V + (jt % kStages) * kBk * SV;

    // ---- S = Q K^T (16 rows x 64 keys), 3xTF32 ----
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    {
      const T* qa = smem + (16 * warp + g8) * SQ + t4;
      const T* kr = Ks + g8 * SQ + t4;
      float a[2][4], b[2][8][2];
      auto load = [&](int u, int x) {
        a[u][0] = to_f(qa[x]);
        a[u][1] = to_f(qa[x + 8 * SQ]);
        a[u][2] = to_f(qa[x + 4]);
        a[u][3] = to_f(qa[x + 8 * SQ + 4]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          b[u][j][0] = to_f(kr[8 * j * SQ + x]);
          b[u][j][1] = to_f(kr[8 * j * SQ + x + 4]);
        }
      };
      load(0, 0);
#pragma unroll
      for (int x = 0; x < D; x += 8) {
        const int u = (x / 8) & 1;
        if (x + 8 < D) load(u ^ 1, x + 8);
        uint32_t ahi[4], alo[4];
        split4(a[u], ahi, alo);
        mma3_n<8>(s, ahi, alo, b[u]);
      }
    }

    // ---- online softmax (log2 domain); masked entries get probability 0 ----
    float mx[2] = {kNeg, kNeg};
    if (full) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ra : rbw, jj = j0 + 8 * j + 2 * t4 + (e & 1);
          if (causal ? !(jj <= i && i - jj < window) : jj >= n_k) s[j][e] = kNeg;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a fully masked row keeps m at (about) -1e30: alpha is 0 or 1, never NaN
      const float mn = fmaxf(m[r], mx[r] * sc);
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[j][e], sc, -m[e >> 1]));
        s[j][e] = (full || s[j][e] != kNeg) ? p : 0.f;
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // ---- O += P V, 3xTF32, one half of dv per fresh accumulator ----
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) {
      float tacc[NTH][4];
#pragma unroll
      for (int j = 0; j < NTH; ++j) tacc[j][0] = tacc[j][1] = tacc[j][2] = tacc[j][3] = 0.f;
      const T* vr = Vs + 2 * t4 * SV + 8 * NTH * hf + g8;
      float b[2][NTH][2];
      auto load = [&](int u, int kk) {
#pragma unroll
        for (int j = 0; j < NTH; ++j) {
          b[u][j][0] = to_f(vr[8 * kk * SV + 8 * j]);
          b[u][j][1] = to_f(vr[8 * kk * SV + SV + 8 * j]);
        }
      };
      load(0, 0);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int u = kk & 1;
        if (kk + 1 < 8) load(u ^ 1, kk + 1);
        // P's k-step kk as the A operand, keys permuted: column t -> key 2t, t + 4 -> 2t + 1
        const float pa[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
        uint32_t ahi[4], alo[4];
        split4(pa, ahi, alo);
        mma3_n<NTH>(tacc, ahi, alo, b[u]);
      }
#pragma unroll
      for (int j = 0; j < NTH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[NTH * hf + j][e] += tacc[j][e];
    }
  }

  // ---- O / l, in q's type ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // the row's log-sum-exp: m is its max in the log2 domain, l its sum of
  // exp2(s sc - m); every lane of a quad holds both
  if (lse != nullptr && t4 == 0) {
    float* lb = lse + (size_t)bh * n_q;
    if (ra < n_q) lb[ra] = (m[0] + log2f(l[0])) * kLn2;
    if (rbw < n_q) lb[rbw] = (m[1] + log2f(l[1])) * kLn2;
  }
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f), inv1 = 1.f / fmaxf(l[1], 1e-30f);
  T* ob = o + (size_t)bh * n_q * DV + 2 * t4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (ra < n_q) store2(ob + (size_t)ra * DV + 8 * j, acc[j][0] * inv0, acc[j][1] * inv0);
    if (rbw < n_q) store2(ob + (size_t)rbw * DV + 8 * j, acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int H,
           int Hkv, int n_q, int n_k, int window, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, D, DV>::bytes;
  static_assert(smem <= 227 * 1024, "shared memory beyond what a block may use");
  cudaError_t err = cudaFuncSetAttribute(window_attention_kernel<T, D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((n_q + kBq - 1) / kBq) * BH;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  window_attention_kernel<T, D, DV><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, BH, H, Hkv, n_q, n_k, window, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dims(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int H,
                int Hkv, int n_q, int n_k, int d, int dv, int window, int causal, float scale,
                cudaStream_t s) {
#define WA_DIMS(D, DV)                                                                      \
  if (d == D && dv == DV)                                                                   \
    return launch<T, D, DV>(q, k, v, o, lse, BH, H, Hkv, n_q, n_k, window, causal, scale, s);
  WA_DIMS(64, 64)
  WA_DIMS(64, 128)
  WA_DIMS(128, 64)
  WA_DIMS(128, 128)
  WA_DIMS(16, 16)
  WA_DIMS(32, 32)
  WA_DIMS(96, 64)
  WA_DIMS(24, 16)
#undef WA_DIMS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int window_attention_launch(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int BH, int H, int Hkv, int n, int d, int dv,
                                       int window, float scale, int bf16, void* stream) {
  if (BH <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || BH % H != 0 || n <= 0 || window <= 0)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, o, lse};
  for (const void* p : ptrs)
    if ((uintptr_t)p & 15) return (int)cudaErrorInvalidValue;  // null passes: lse is optional
  if (!q || !k || !v || !o) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  if (bf16)
    return launch_dims<__nv_bfloat16>(q, k, v, o, l, BH, H, Hkv, n, n, d, dv, window, 1, scale, s);
  return launch_dims<float>(q, k, v, o, l, BH, H, Hkv, n, n, d, dv, window, 1, scale, s);
}

// The non-causal mode: q (BH, n_q, d) against k (BH/G, n_k, d) and v
// (BH/G, n_k, dv), every key seen by every row; lse (BH, n_q) as the causal
// launcher's, optional (training passes it, serving null).
extern "C" int window_attention_noncausal_launch(const void* q, const void* k, const void* v,
                                                 void* o, void* lse, int BH, int H, int Hkv,
                                                 int n_q, int n_k, int d, int dv, float scale,
                                                 int bf16, void* stream) {
  if (BH <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || BH % H != 0 || n_q <= 0 || n_k <= 0)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, o, lse};
  for (const void* p : ptrs)
    if ((uintptr_t)p & 15) return (int)cudaErrorInvalidValue;  // null passes: lse is optional
  if (!q || !k || !v || !o) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  if (bf16)
    return launch_dims<__nv_bfloat16>(q, k, v, o, l, BH, H, Hkv, n_q, n_k, d, dv, 1, 0, scale, s);
  return launch_dims<float>(q, k, v, o, l, BH, H, Hkv, n_q, n_k, d, dv, 1, 0, scale, s);
}
