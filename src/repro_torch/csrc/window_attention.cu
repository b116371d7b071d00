// Causal sliding-window softmax attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/window_attention/kernel.py::window_attention_pallas
// (pallas_call at :111, body _kernel at :35).  Row i of a (batch x head)
// attends to the keys j with 0 <= i - j < W, with scale 1/sqrt(d), an
// online softmax (running max, sum and accumulator) in fp32, and the output
// in the inputs' type: the function of window_attention/ref.py.
//
// Design.  The TPU grid walks (row, q block, kv block) with the kv axis
// sequential and the running softmax in VMEM scratch, and clamps and masks
// the kv block index at the left edge (kernel.py:9-16) because a BlockSpec
// cannot start anywhere.  Here one block of 256 threads owns 64 query rows
// of one (batch x head) row and walks, in a loop, only the 64-key tiles
// that meet its band [i0 - W + 1, i0 + 64), so nothing carries across
// blocks and the loop simply starts at the first tile in the band.  The
// ragged right edge (T not a multiple of 64) and the band are masked in the
// kernel, so any T and any W >= 1 work.  K and V are read per kv-head
// (kv-head = head / (H / Hkv)) instead of the reference's jnp.repeat to the
// query-head count (models/attention.py:116-118): the same function, with
// a quarter of the K/V bytes at Mixtral's 32 heads over 8 kv-heads.
//
// Per tile: K is staged transposed and V as it is in shared memory (fp32;
// bf16 inputs are converted on the way in), each thread computes a 4 x 4
// block of the 64 x 64 scores from float4 loads of the transposed Q and K
// tiles, the row max and sum are reduced over the 16 threads of a row with
// warp shuffles, P is written transposed over the K tile, and each thread
// adds P V into its 4 rows x (dv / 16) columns, kept in registers.  Shared
// memory: 4 * (68 d + 68 max(d, 64) + 64 dv) bytes, 102,400 B at d = dv =
// 128, so two blocks fit on an SM.  Products run on CUDA cores in fp32
// (TF32 stays off, as the package sets it).
//
// Bound on an H100 at the serve path's prefill (B 4 x H 32, T 8192, W
// 4096, d = dv = 128, fp32): 1.65 TFLOP for QK^T and PV over the 25.2 M
// in-band pairs of each head, ~24.6 ms at 67 TFLOP/s fp32, against ~1.3 GB
// of q, k, v and o (~0.4 ms): operations bound it.  The inner loops issue
// two 16-byte shared-memory loads per 16 FMAs (QK^T) and three per 32
// (PV); tensor cores (wgmma with a split-fp32 or bf16 scheme), TMA and a
// pipelined tile ring are later work.
//
// Contract (q, k, v, o contiguous, all float32 or all bfloat16):
//   q (B*H, T, d), k (B*Hkv, T, d), v (B*Hkv, T, dv) -> o (B*H, T, dv)
// Requires H % Hkv == 0, W >= 1, dv in {64, 128, 256}, B*H <= 65535 and the
// shared memory above within the 227 KB a block may use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx) owns rows 4ty.. and keys 4tx..
constexpr int kLd = 68;        // row stride of the transposed tiles (float4-aligned, 4-way stores)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// reductions over the 16 threads of one row (lanes that differ in bits 0-3)
__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int d, int dv) {
  return sizeof(float) * ((size_t)kLd * d + (size_t)kLd * (d > kBk ? d : kBk) + (size_t)kBk * dv);
}

template <typename T, int NH>
__global__ void __launch_bounds__(kThreads) window_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int H, int Hkv, int n, int d, int window, float scale) {
  constexpr int DV = 64 * NH;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;            // (d, kLd) this block's queries, transposed
  float* kt = qt + kLd * d;    // (d, kLd) one key tile, transposed; then P^T (kBk, kLd)
  float* vs = kt + kLd * (d > kBk ? d : kBk);  // (kBk, DV) one value tile

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int i0 = blockIdx.x * kBq;
  const int bh = blockIdx.y;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const T* qb = q + (size_t)bh * n * d;
  const T* kb = k + (size_t)kvh * n * d;
  const T* vb = v + (size_t)kvh * n * DV;

  for (int x = t; x < kBq * d; x += kThreads) {
    const int r = x / d, e = x - r * d;
    const int i = i0 + r;
    qt[e * kLd + r] = i < n ? to_f(qb[(size_t)i * d + e]) : 0.f;
  }

  float m[4], l[4], acc[4][4 * NH];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    m[u] = kNeg;
    l[u] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NH; ++c) acc[u][c] = 0.f;
  }

  const int j_first = max(0, i0 - window + 1);  // first key any row of the block sees
  const int j_end = min(i0 + kBq, n);           // one past the last
  for (int j0 = j_first - j_first % kBk; j0 < j_end; j0 += kBk) {
    __syncthreads();  // the previous tile's readers of kt (as P^T) and vs are done
    for (int x = t; x < kBk * d; x += kThreads) {
      const int c = x / d, e = x - c * d;
      const int j = j0 + c;
      kt[e * kLd + c] = j < n ? to_f(kb[(size_t)j * d + e]) : 0.f;
    }
    for (int x = t; x < kBk * DV; x += kThreads) {
      const int c = x / DV;
      const int j = j0 + c;
      vs[x] = j < n ? to_f(vb[(size_t)j * DV + (x - c * DV)]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) s[u][w] = 0.f;
    for (int e = 0; e < d; ++e) {
      const float4 a = *reinterpret_cast<const float4*>(qt + e * kLd + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(kt + e * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) s[u][w] = fmaf(av[u], bv[w], s[u][w]);
    }
    __syncthreads();  // every thread is done with kt: it takes P^T next

    // online softmax over this tile; masked entries get probability 0
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + ty * 4 + u;
      float mx = kNeg;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int j = j0 + tx * 4 + w;
        const bool in_band = j <= i && i - j < window && j < n;
        s[u][w] = in_band ? s[u][w] * scale : kNeg;
        mx = fmaxf(mx, s[u][w]);
      }
      const float mn = fmaxf(m[u], max16(mx));
      const float alpha = expf(m[u] - mn);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float p = s[u][w] == kNeg ? 0.f : expf(s[u][w] - mn);
        s[u][w] = p;
        sum += p;
      }
      l[u] = l[u] * alpha + sum16(sum);
      m[u] = mn;
#pragma unroll
      for (int c = 0; c < 4 * NH; ++c) acc[u][c] *= alpha;
    }
    float* pt = kt;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) pt[(tx * 4 + w) * kLd + ty * 4 + u] = s[u][w];
    __syncthreads();

    for (int c = 0; c < kBk; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(pt + c * kLd + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const float4 b = *reinterpret_cast<const float4*>(vs + c * DV + h * 64 + tx * 4);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w) acc[u][h * 4 + w] = fmaf(av[u], bv[w], acc[u][h * 4 + w]);
      }
    }
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty * 4 + u;
    if (i >= n) continue;
    const float den = fmaxf(l[u], 1e-30f);
    T* ob = o + ((size_t)bh * n + i) * DV + tx * 4;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int w = 0; w < 4; ++w) ob[h * 64 + w] = from_f<T>(acc[u][h * 4 + w] / den);
  }
}

template <typename T, int NH>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int H, int Hkv,
           int n, int d, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, 64 * NH);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(window_attention_kernel<T, NH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + kBq - 1) / kBq, BH);
  window_attention_kernel<T, NH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, n, d, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dv(const void* q, const void* k, const void* v, void* o, int BH, int H, int Hkv,
              int n, int d, int dv, int window, float scale, cudaStream_t s) {
  switch (dv) {
    case 64: return launch<T, 1>(q, k, v, o, BH, H, Hkv, n, d, window, scale, s);
    case 128: return launch<T, 2>(q, k, v, o, BH, H, Hkv, n, d, window, scale, s);
    case 256: return launch<T, 4>(q, k, v, o, BH, H, Hkv, n, d, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int window_attention_launch(const void* q, const void* k, const void* v, void* o,
                                       int BH, int H, int Hkv, int n, int d, int dv,
                                       int window, float scale, int bf16, void* stream) {
  if (BH <= 0 || BH > 65535 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || BH % H != 0 || n <= 0 ||
      d <= 0 || window <= 0 || smem_bytes(d, dv) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_dv<__nv_bfloat16>(q, k, v, o, BH, H, Hkv, n, d, dv, window, scale, s);
  return launch_dv<float>(q, k, v, o, BH, H, Hkv, n, d, dv, window, scale, s);
}
