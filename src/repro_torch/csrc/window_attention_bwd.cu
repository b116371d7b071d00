// Backward of causal sliding-window softmax attention for Hopper (sm_90a).
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
//   (b) window_bwd_dkdv_kernel: one block per (batch x kv-head, 64-key
//       tile).  It holds its K and V tiles in shared memory and loops over
//       the G query heads and the 64-row query tiles that meet its band,
//       [j0, j0 + 64 + W - 1); per tile it recomputes S^T and dP^T, forms
//       P^T and dS^T in shared memory and accumulates dV += P^T dO and
//       dK += dS^T Q in registers.  The sum over query heads stays in the
//       block.
//   (c) window_bwd_dq_kernel: one block per (batch x head, 64-row query
//       tile), over the key tiles of its band: S, dP, then dS in shared
//       memory and dQ += dS K in registers.
// Blocks are ordered longest first (key tiles from the start of the
// sequence, query tiles from its end).
//
// Products: fp32 FMAs on the CUDA cores, out of fp32 tiles in shared
// memory (bf16 inputs are widened as they are staged).  256 threads own a
// 64 x 64 tile as 16 x 16 threads of 4 x 4 entries at a stride of 16 rows
// and 16 columns, so operand rows are read as float4 at a row stride of
// dim + 4 words (conflict-free across a quarter warp) and broadcast down a
// warp's two thread rows.  At d = dv = 128 the tiles of K, V, Q and dO take
// 4 x 33 KB and P^T and dS^T 2 x 17 KB: 170 KB of the 227 KB, one block an
// SM.
//
// Bound on an H100 at Mixtral-8x7B's training shape (B 1 x H 32 over Hkv 8,
// T 8192, W 4096, d = dv = 128): 25.2 M in-band pairs a head and five
// products of 2 d flop a pair, 1.03 TFLOP: 15.4 ms on the fp32 CUDA cores at
// 67 TFLOP/s, 6.2 ms as split TF32 (three passes) at 495 TFLOP/s for fp32
// inputs, 1.04 ms on the bf16 tensor cores at 989 TFLOP/s for bf16 inputs
// (the training path's type); the bytes (~0.5 GB) take 0.15 ms.  This first
// design recomputes S and dP in both (b) and (c) (seven products a pair
// where five are needed) and runs them on the CUDA cores, reading each
// operand from shared memory: it is written to be right; split-TF32
// mma.sync or wgmma tiles are later work.
//
// Contract (every pointer contiguous and 16-byte aligned; q, k, v, o, do,
// dq, dk, dv all float32 or all bfloat16; lse and the scratch D float32):
//   q, o, do (B*H, T, d | dv), k (B*Hkv, T, d), v (B*Hkv, T, dv),
//   lse (B*H, T) -> dq (B*H, T, d), dk (B*Hkv, T, d), dv (B*Hkv, T, dv)
// Takes what the forward takes: H % Hkv == 0, W >= 1 (W > T included), any
// T, and (d, dv) in {(64, 64), (64, 128), (128, 64), (128, 128), (16, 16),
// (32, 32), (96, 64), (24, 16)}; anything else is cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // query rows and keys per tile
constexpr int kSP = kTile + 4;  // row stride of the P^T / dS tiles
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float get(float4 a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// rows row0 .. row0 + 63 of src (COLS elements each) into dst as fp32, at a
// row stride of COLS + 4 words; zeros beyond row n - 1
template <int COLS, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0, int n) {
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
template <int COLS, typename T>
__device__ __forceinline__ void write_tile(T* dst, const float (&acc)[4][(COLS + 15) / 16],
                                           int row0, int n, float scale, int ty, int tx) {
  constexpr int NU = (COLS + 15) / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int u = 0; u < NU; ++u)
      if (COLS % 16 == 0 || tx + 16 * u < COLS)
        store(dst + (size_t)row * COLS + tx + 16 * u, acc[i][u] * scale);
  }
}

// (a) D_i = sum_c dO_ic o_ic, one warp a row
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads) window_bwd_rowdot_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dd, long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < DV; c += 32)
    acc = fmaf(to_f(dout[row * DV + c]), to_f(o[row * DV + c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dd[row] = acc;
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
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, 1) window_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
    T* __restrict__ dk, T* __restrict__ dv, int BHkv, int H, int Hkv, int n, int window,
    float scale) {
  using Lay = Layout<D, DV>;
  constexpr int NUK = (D + 15) / 16, NUV = (DV + 15) / 16;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kt = (int)(blockIdx.x / BHkv), bkv = (int)(blockIdx.x % BHkv);
  const int b = bkv / Hkv, kvh = bkv % Hkv, G = H / Hkv;
  const int j0 = kt * kTile;
  const float sc2 = scale * kLog2e;

  stage<D>(sm + Lay::K, k + (size_t)bkv * n * D, j0, n);
  stage<DV>(sm + Lay::V, v + (size_t)bkv * n * DV, j0, n);

  float adk[4][NUK], adv[4][NUV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int u = 0; u < NUK; ++u) adk[i][u] = 0.f;
#pragma unroll
    for (int u = 0; u < NUV; ++u) adv[i][u] = 0.f;
  }
  // query rows that see a key of the tile: [j0, min(n, j0 + 63 + W))
  const int i_end = (int)min((long long)n, (long long)j0 + kTile - 1 + window);
  const int it0 = j0 / kTile, it1 = (i_end + kTile - 1) / kTile;
  for (int g = 0; g < G; ++g) {
    const size_t bh = (size_t)b * H + (size_t)kvh * G + g;
    for (int it = it0; it < it1; ++it) {
      const int i0 = it * kTile;
      __syncthreads();  // the previous tile's Q, dO, P^T and dS^T are retired
      stage<D>(sm + Lay::Q, q + bh * n * D, i0, n);
      stage<DV>(sm + Lay::O, dout + bh * n * DV, i0, n);
      if (tid < kTile) {
        const int row = i0 + tid;
        sm[Lay::L + tid] = row < n ? lse[bh * n + row] * kLog2e : 0.f;
        sm[Lay::DD + tid] = row < n ? dd[bh * n + row] : 0.f;
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
          const bool in = ii < n && jj <= ii && ii - jj < window;
          const float p = in ? exp2f(fmaf(s[i][u], sc2, -sm[Lay::L + il])) : 0.f;
          sm[Lay::P + jl * kSP + il] = p;
          sm[Lay::S + jl * kSP + il] = p * (dp[i][u] - sm[Lay::DD + il]);
        }
      __syncthreads();
      tile_mx<DV>(adv, sm + Lay::P, sm + Lay::O, ty, tx);
      tile_mx<D>(adk, sm + Lay::S, sm + Lay::Q, ty, tx);
    }
  }
  write_tile<D>(dk + (size_t)bkv * n * D, adk, j0, n, scale, ty, tx);
  write_tile<DV>(dv + (size_t)bkv * n * DV, adv, j0, n, 1.f, ty, tx);
}

// (c) dQ of one (batch x head, 64-row query tile)
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, 1) window_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
    T* __restrict__ dq, int BH, int H, int Hkv, int n, int window, float scale) {
  using Lay = Layout<D, DV>;
  constexpr int NUK = (D + 15) / 16;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nqt = (n + kTile - 1) / kTile;
  const int it = nqt - 1 - (int)(blockIdx.x / BH);  // the longest bands first
  const size_t bh = blockIdx.x % BH;
  const size_t kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int i0 = it * kTile;
  const float sc2 = scale * kLog2e;

  stage<D>(sm + Lay::Q, q + bh * n * D, i0, n);
  stage<DV>(sm + Lay::O, dout + bh * n * DV, i0, n);
  if (tid < kTile) {
    const int row = i0 + tid;
    sm[Lay::L + tid] = row < n ? lse[bh * n + row] * kLog2e : 0.f;
    sm[Lay::DD + tid] = row < n ? dd[bh * n + row] : 0.f;
  }
  float adq[4][NUK];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < NUK; ++u) adq[i][u] = 0.f;
  // keys that a row of the tile sees: [max(0, i0 - W + 1), min(n, i0 + 64))
  const int j_first = max(0, i0 - window + 1), j_end = min(n, i0 + kTile);
  const int jt0 = j_first / kTile, jt1 = (j_end + kTile - 1) / kTile;
  for (int jt = jt0; jt < jt1; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();  // the previous tile's K, V and dS are retired
    stage<D>(sm + Lay::K, k + kvh * n * D, j0, n);
    stage<DV>(sm + Lay::V, v + kvh * n * DV, j0, n);
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
        const bool in = ii < n && jj <= ii && ii - jj < window;
        const float p = in ? exp2f(fmaf(s[i][u], sc2, -sm[Lay::L + il])) : 0.f;
        sm[Lay::S + il * kSP + jl] = p * (dp[i][u] - sm[Lay::DD + il]);
      }
    __syncthreads();
    tile_mx<D>(adq, sm + Lay::S, sm + Lay::K, ty, tx);
  }
  write_tile<D>(dq + bh * n * D, adq, i0, n, scale, ty, tx);
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* dout, void* dq, void* dk, void* dv, float* dd, int BH, int H, int Hkv,
           int n, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<D, DV>::bytes;
  static_assert(smem <= 227 * 1024, "shared memory beyond what a block may use");
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const int BHkv = BH / (H / Hkv);
  const long long nt = (n + kTile - 1) / kTile;
  const long long rows = (long long)BH * n;
  const long long blocks_a = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks_a > 0x7FFFFFFFLL || nt * BH > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_bwd_dkdv_kernel<T, D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(window_bwd_dq_kernel<T, D, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_bwd_rowdot_kernel<T, DV><<<(unsigned)blocks_a, kThreads, 0, stream>>>(
      static_cast<const T*>(o), tdo, dd, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  window_bwd_dkdv_kernel<T, D, DV><<<(unsigned)(nt * BHkv), kThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, dd, static_cast<T*>(dk), static_cast<T*>(dv), BHkv, H, Hkv, n,
      window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  window_bwd_dq_kernel<T, D, DV><<<(unsigned)(nt * BH), kThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, dd, static_cast<T*>(dq), BH, H, Hkv, n, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dims(const void* q, const void* k, const void* v, const void* o, const float* lse,
                const void* dout, void* dq, void* dk, void* dv, float* dd, int BH, int H,
                int Hkv, int n, int d, int dvw, int window, float scale, cudaStream_t s) {
#define WB_DIMS(D, DV)                                                                   \
  if (d == D && dvw == DV)                                                               \
    return launch<T, D, DV>(q, k, v, o, lse, dout, dq, dk, dv, dd, BH, H, Hkv, n, window, \
                            scale, s);
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

}  // namespace

// dd is the caller's fp32 scratch of B*H*T entries (D of kernel (a)).
extern "C" int window_attention_bwd_launch(const void* q, const void* k, const void* v,
                                           const void* o, const void* lse, const void* dout,
                                           void* dq, void* dk, void* dv, void* dd, int BH, int H,
                                           int Hkv, int n, int d, int dvw, int window,
                                           float scale, int bf16, void* stream) {
  if (BH <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || BH % H != 0 || n <= 0 || window <= 0)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, o, lse, dout, dq, dk, dv, dd};
  for (const void* p : ptrs)
    if (!p || ((uintptr_t)p & 15)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = static_cast<const float*>(lse);
  float* dsc = static_cast<float*>(dd);
  if (bf16)
    return launch_dims<__nv_bfloat16>(q, k, v, o, l, dout, dq, dk, dv, dsc, BH, H, Hkv, n, d,
                                      dvw, window, scale, s);
  return launch_dims<float>(q, k, v, o, l, dout, dq, dk, dv, dsc, BH, H, Hkv, n, d, dvw, window,
                            scale, s);
}
