// Fused streaming decode step for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_step/kernel.py::decode_step_pallas
// (pallas_call at :145, body _kernel at :30).  One thread block per
// (flow, kv-head) runs the paper's per-packet program (Alg. 1 lines 12-16):
//   1. write the arriving (k, v) into the SRAM ring at slot count,
//   2. exact exp-kernel readout over ring slots <= count (local layer),
//   3. phi_q^T S and phi_q^T Z against the compressed stream (Eq. 6),
//   4. add the optional static-global partials (Eq. 14) and merge,
//   5. fold-on-full: when count + 1 >= L, S += phi(ring)^T v, Z += sum phi(ring),
//      clear the ring, count <- 0 (Eqs. 9-10).
// S, Z and the ring are updated in place; only what changes is written: the
// ring slot on a plain step, S, Z and the cleared ring on a fold.  The new
// fill levels go to count_out (count_in is read by every head of a flow, so
// it cannot be overwritten while other heads' blocks may still read it).
//
// Bound on this card: bytes.  A plain step reads S (m*dv floats, 74 % of the
// bytes at the paper's shape), Z, phi_q, q and the valid ring rows; a fold
// also reads phi_buf and writes S.  At BH 1024, d = dv 64, m 256, L 64 with
// one flow in 64 folding that is 90 MB, 0.027 ms at 3.35 TB/s.
//
// Design.  The warps of a block split in two halves that run at once and
// meet at one barrier:
//   * warps 0-3 stream S and Z against phi_q with 16-byte loads, eight in
//     flight per thread, from the block's first instruction (they do not
//     wait for the fill level);
//   * warps 4-7 read the fill level, stage the valid ring rows (16-byte
//     loads, all issued at once), compute the local scores with four lanes
//     per slot (every slot at once) and the local numerator.
// A folding block then computes S += phi_buf^T v_ring with all 256 threads,
// each holding a 4 x 4 tile of S in registers, phi_buf streamed through two
// shared-memory tiles with cp.async so that the next tile loads while the
// current one is folded.  The fold is 1M FMAs per row at the paper's shape;
// a first design did it as 64 dependent chains per thread with operands
// loaded from device memory, and its 16 folding blocks set the kernel's time
// (0.167 ms against 0.036 ms when no flow folds, measured on an H100).
// Here a step with one flow in 64 folding takes about 0.050 ms and one with
// none 0.028 ms: the folding blocks still end last (each does its fold on
// one SM after its readout; splitting a row over a cluster of two blocks,
// or prefetching phi_buf to L2, measured slower).
// fp32 throughout on CUDA cores, so the engine's decisions match the CPU's.
//
// Two layouts of shared memory.  Where the whole ring (L x dv values and
// L x (d + 4) keys) fits beside the partials, as at the paper's shape, it is
// staged whole (the design above).  Where it does not, as at the zoo's
// default Chimera widths (L 256, d = dv = m 128: 262,144 B of ring alone),
// the ring goes through shared memory in tiles of kTileRows rows: the local
// half stages a tile, scores it and adds its numerator to the partials it
// keeps in shared memory, then takes the next tile (the exp kernel is
// unnormalized, so the tiles' partials simply add); the fold walks the
// pairs (row tile of S, ring tile) with both the phi_buf tile and the ring's
// value tile double-buffered by cp.async, the arriving value read from v_t.
//
// Contract (all float32, contiguous, 16-byte aligned; BH = flows * heads):
//   q (BH,Gq,d) k_t (BH,d) v_t (BH,dv) phi_q (BH,Gq,m) phi_buf (BH,L,m)
//   k_buf (BH,L,d) v_buf (BH,L,dv) S (BH,m,dv) Z (BH,m)
//   count_in, count_out (BH/heads,) int32, 0 <= count < L
//   gnum (BH,Gq,dv) and gden (BH,Gq), or both null
//   out (BH,Gq,dv)
// Takes dv in {16, 32, 64, 128}, d and m multiples of 4, and the shared
// memory of the whole-ring layout, else of the tiled one, within what a
// block may use; anything else is cudaErrorInvalidValue.  At dv 16 a row of
// S is four float4 column groups, so the stream half sums 32 row groups and
// a fold tile is 256 rows of S; at m 16 and d 16 (the smoke configs) the
// tile holds all of S, 16 of the fold's threads own its rows and one score
// quad covers a key.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalf = kThreads / 2;  // threads of each half

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x); acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z); acc.w = fmaf(a, b.w, acc.w);
}
__device__ __forceinline__ void add4(float4& a, float4 b) { a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

constexpr int kTileRows = 64;  // ring rows per tile of the tiled layout

// Shared-memory layout, in floats, staging kt ring rows at once (kt = L: the
// whole ring).  The fold's tiles reuse the space of the staged ring, the
// query and the partials, which are dead by then: with the whole ring staged
// they follow its values (which the fold reads in place), else they take
// the space from its start, the phi_buf tiles then the value tiles.
struct Layout {
  int kt, vs, ks, qs, sc, red_s, red_l, den_s, den_l, ftile, fv, total;
  __host__ __device__ Layout(int Gq, int d, int dv, int L, int m, bool tiled) {
    const int rgh = kHalf / (dv / 4);       // row groups of a half
    const int mt = 4 * (kThreads / (dv / 4));  // rows of S per fold tile
    const int fw = mt < m ? mt : m;         // width of a phi_buf tile
    kt = tiled && L > kTileRows ? kTileRows : L;
    vs = 0;                                 // (kt, dv) ring values
    ks = vs + kt * dv;                      // (kt, d + 4) ring keys
    qs = ks + kt * (d + 4);                 // (Gq, d)
    sc = qs + Gq * d;                       // (Gq, kt) local scores
    red_s = sc + ((Gq * kt + 3) & ~3);      // (Gq, rgh, dv) stream partials
    red_l = red_s + Gq * rgh * dv;          // (Gq, rgh, dv) local partials
    den_s = red_l + Gq * rgh * dv;          // (Gq, rgh)
    den_l = den_s + Gq * rgh;               // (Gq, rgh)
    const int end = den_l + Gq * rgh;
    ftile = tiled ? 0 : ks;                 // (2, kt, fw) phi_buf tiles, on a fold
    fv = ftile + 2 * kt * fw;               // (2, kt, dv) ring value tiles (tiled)
    const int fend = fv + (tiled ? 2 * kt * dv : 0);
    total = end > fend ? end : fend;
  }
};

template <int DV, bool TILED>
__global__ void __launch_bounds__(kThreads, 4) decode_step_kernel(
    const float* __restrict__ q, const float* __restrict__ k_t,
    const float* __restrict__ v_t, const float* __restrict__ phi_q,
    const float* __restrict__ phi_buf, float* __restrict__ k_buf,
    float* __restrict__ v_buf, float* __restrict__ S, float* __restrict__ Z,
    const int32_t* __restrict__ count_in, int32_t* __restrict__ count_out,
    const float* __restrict__ gnum, const float* __restrict__ gden,
    float* __restrict__ out, int heads, int Gq, int d, int m, int L, float gamma) {
  constexpr int CG = DV / 4;          // float4 column groups of a row of S
  constexpr int RGH = kHalf / CG;     // row groups of a half
  constexpr int RG = kThreads / CG;   // row groups of the block (the fold)
  constexpr int MT = 4 * RG;          // rows of S per fold tile
  extern __shared__ __align__(16) float smem[];
  __shared__ int c_sh;  // the fill level, read by the local half
  const Layout lay(Gq, d, DV, L, m, TILED);
  const int KT = lay.kt;              // ring rows staged at once (L: all)
  float* vs = smem + lay.vs;
  float* ks = smem + lay.ks;
  float* qs = smem + lay.qs;
  float* sc = smem + lay.sc;
  float* red_s = smem + lay.red_s;
  float* red_l = smem + lay.red_l;
  float* den_s = smem + lay.den_s;
  float* den_l = smem + lay.den_l;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int t = threadIdx.x;
  const int dp = d + 4;
  const float* Sb = S + (size_t)bh * m * DV;
  const float* Zb = Z + (size_t)bh * m;

  if (t < kHalf) {
    // stream readout: thread (cg, rg) sums rows rg, rg + RGH, ... of phi_q S
    const int cg = t % CG, rg = t / CG;
    for (int g = 0; g < Gq; ++g) {
      const float* pq = phi_q + ((size_t)bh * Gq + g) * m;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      float dn = 0.f;
#pragma unroll 8
      for (int i = rg; i < m; i += RGH) {
        const float p = __ldg(pq + i);
        fma4(acc, p, ld4(Sb + (size_t)i * DV + 4 * cg));
        dn = fmaf(p, __ldg(Zb + i), dn);
      }
      st4(red_s + (g * RGH + rg) * DV + 4 * cg, acc);
      if (cg == 0) den_s[g * RGH + rg] = dn;
    }
  } else {
    // local layer: stage the valid ring rows (the arriving token at slot c),
    // the whole ring at once or a tile of KT rows at a time
    const int u = t - kHalf;
    int c = count_in[b];
    c = c < 0 ? 0 : (c >= L ? L - 1 : c);  // memory safety only; callers keep 0 <= c < L
    if (u == 0) c_sh = c;
    const float* kb = k_buf + (size_t)bh * L * d;
    const float* vb = v_buf + (size_t)bh * L * DV;
    const float* kt = k_t + (size_t)bh * d;
    const float* vt = v_t + (size_t)bh * DV;
    const int d4 = d / 4;
    const float inv_sqrt_d = rsqrtf((float)d);
    const int quad = u & 3;
    const int cg = u % CG, rg = u / CG;
    for (int x = u; x < Gq * d4; x += kHalf) st4(qs + 4 * x, ld4(q + (size_t)bh * Gq * d + 4 * x));
    for (int j0 = 0; j0 <= c; j0 += KT) {
      const int n = c + 1 - j0 < KT ? c + 1 - j0 : KT;  // valid rows of this tile
      for (int x = u; x < n * d4; x += kHalf) {
        const int jj = x / d4, e = 4 * (x - jj * d4), j = j0 + jj;
        st4(ks + jj * dp + e, ld4(j == c ? kt + e : kb + (size_t)j * d + e));
      }
      for (int x = u; x < n * CG; x += kHalf) {
        const int jj = x / CG, e = 4 * (x - jj * CG), j = j0 + jj;
        st4(vs + jj * DV + e, ld4(j == c ? vt + e : vb + (size_t)j * DV + e));
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kHalf) : "memory");
      // scores exp(q.k_j / sqrt(d)): four lanes per slot, 32 slots at once
      for (int g = 0; g < Gq; ++g) {
        for (int i0 = 0; i0 < n; i0 += kHalf / 4) {
          const int jj = i0 + u / 4;
          float acc = 0.f;
          if (jj < n)
            for (int e = 4 * quad; e < d; e += 16) {
              const float4 a = ld4(qs + g * d + e), kk = ld4(ks + jj * dp + e);
              acc = fmaf(a.x, kk.x, fmaf(a.y, kk.y, fmaf(a.z, kk.z, fmaf(a.w, kk.w, acc))));
            }
          acc += __shfl_xor_sync(0xffffffffu, acc, 1);
          acc += __shfl_xor_sync(0xffffffffu, acc, 2);
          if (jj < n && quad == 0) sc[g * KT + jj] = expf(acc * inv_sqrt_d);
        }
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kHalf) : "memory");
      // local numerator: thread (cg, rg) sums slots rg, rg + RGH, ... of the
      // tile into its own partial (a tile's partials add to the last one's)
      for (int g = 0; g < Gq; ++g) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        float dn = 0.f;
        for (int jj = rg; jj < n; jj += RGH) {
          const float s = sc[g * KT + jj];
          fma4(acc, s, ld4(vs + jj * DV + 4 * cg));
          dn += s;
        }
        float* rl = red_l + (g * RGH + rg) * DV + 4 * cg;
        if (j0 > 0) {
          add4(acc, ld4(rl));
          if (cg == 0) dn += den_l[g * RGH + rg];
        }
        st4(rl, acc);
        if (cg == 0) den_l[g * RGH + rg] = dn;
      }
      if (j0 + KT <= c) asm volatile("bar.sync 1, %0;\n" ::"n"(kHalf) : "memory");
    }
  }
  __syncthreads();
  const int c = c_sh;
  const bool full = c + 1 >= L;

  // merge the partials (+ static globals) and normalize
  for (int x = t; x < Gq * CG; x += kThreads) {
    const int g = x / CG, e = 4 * (x - g * CG);
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    float den = 0.f;
    for (int r = 0; r < RGH; ++r) {
      add4(num, ld4(red_l + (g * RGH + r) * DV + e));
      add4(num, ld4(red_s + (g * RGH + r) * DV + e));
      den += den_l[g * RGH + r] + den_s[g * RGH + r];
    }
    if (gnum != nullptr) {
      add4(num, ld4(gnum + ((size_t)bh * Gq + g) * DV + e));
      den += gden[(size_t)bh * Gq + g];
    }
    const float inv = 1.f / (den + gamma);
    st4(out + ((size_t)bh * Gq + g) * DV + e,
        make_float4(num.x * inv, num.y * inv, num.z * inv, num.w * inv));
  }

  float* kw = k_buf + (size_t)bh * L * d;
  float* vw = v_buf + (size_t)bh * L * DV;
  if (!full) {
    for (int x = t; x < d / 4; x += kThreads) st4(kw + (size_t)c * d + 4 * x, ld4(k_t + (size_t)bh * d + 4 * x));
    for (int x = t; x < CG; x += kThreads) st4(vw + (size_t)c * DV + 4 * x, ld4(v_t + (size_t)bh * DV + 4 * x));
  } else {
    // fold: thread (cg, rg) owns rows 4 rg .. 4 rg + 3 of each MT-row tile of
    // S and columns 4 cg .. 4 cg + 3.  The steps walk (row tile, ring tile)
    // pairs, each step's phi_buf tile (and, tiled, the ring's value tile)
    // double-buffered; with the whole ring staged there is one ring tile and
    // its values are read where the local half staged them.
    __syncthreads();  // the partials are read; their space takes the tiles
    const float* pb = phi_buf + (size_t)bh * L * m;
    const float* vb = v_buf + (size_t)bh * L * DV;
    const float* vt = v_t + (size_t)bh * DV;
    float* Sw = S + (size_t)bh * m * DV;
    float* Zw = Z + (size_t)bh * m;
    float* ft = smem + lay.ftile;
    float* fv = smem + lay.fv;
    const int mt = MT < m ? MT : m;  // tile width, in rows of S
    const int ntile = (m + MT - 1) / MT;
    const int nkt = (L + KT - 1) / KT;  // ring tiles (1 unless tiled)
    const int nstep = ntile * nkt;
    const int cg = t % CG, rg = t / CG;
    auto load_step = [&](int step, int buf) {
      const int r0 = (step / nkt) * MT, w = (m - r0 < MT ? m - r0 : MT) / 4;
      const int j0 = (step % nkt) * KT, n = L - j0 < KT ? L - j0 : KT;
      float* dst = ft + buf * KT * mt;
      for (int x = t; x < n * w; x += kThreads) {
        const int j = x / w, e = 4 * (x - j * w);
        cp_async16(dst + j * mt + e, pb + (size_t)(j0 + j) * m + r0 + e);
      }
      if (TILED) {
        float* vdst = fv + buf * KT * DV;
        for (int x = t; x < n * CG; x += kThreads) {
          const int j = x / CG, e = 4 * (x - j * CG);
          cp_async16(vdst + j * DV + e, j0 + j == c ? vt + e : vb + (size_t)(j0 + j) * DV + e);
        }
      }
      cp_async_commit();
    };
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0, a2 = a0, a3 = a0, z = a0;
    load_step(0, 0);
    for (int step = 0; step < nstep; ++step) {
      if (step + 1 < nstep) {
        load_step(step + 1, (step + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int tile = step / nkt, kk = step % nkt;
      const int n = L - kk * KT < KT ? L - kk * KT : KT;
      const float* f = ft + (step & 1) * KT * mt;
      const float* vsrc = TILED ? fv + (step & 1) * KT * DV : vs;
      const int r = tile * MT + 4 * rg;  // first row of this thread's tile
      if (r < m) {
        if (kk == 0) a0 = a1 = a2 = a3 = z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
          const float4 p = ld4(f + j * mt + 4 * rg);
          const float4 v = ld4(vsrc + j * DV + 4 * cg);
          fma4(a0, p.x, v); fma4(a1, p.y, v); fma4(a2, p.z, v); fma4(a3, p.w, v);
          add4(z, p);
        }
        if (kk + 1 == nkt) {
          // the sums, then the state, as the plain version adds them
          float* s = Sw + (size_t)r * DV + 4 * cg;
          float4 o = ld4(s);           add4(o, a0); st4(s, o);
          o = ld4(s + DV);             add4(o, a1); st4(s + DV, o);
          o = ld4(s + 2 * DV);         add4(o, a2); st4(s + 2 * DV, o);
          o = ld4(s + 3 * DV);         add4(o, a3); st4(s + 3 * DV, o);
          if (cg == 0) {
            float4 zo = ld4(Zw + r);
            add4(zo, z);
            st4(Zw + r, zo);
          }
        }
      }
      __syncthreads();  // the step's buffer is refilled next
    }
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int x = t; x < L * d / 4; x += kThreads) st4(kw + 4 * x, zero);
    for (int x = t; x < L * CG; x += kThreads) st4(vw + 4 * x, zero);
  }
  if (t == 0 && bh % heads == 0) count_out[b] = full ? 0 : c + 1;
}

template <int DV, bool TILED>
int launch_layout(const float* q, const float* k_t, const float* v_t, const float* phi_q,
                  const float* phi_buf, float* k_buf, float* v_buf, float* S, float* Z,
                  const int32_t* count_in, int32_t* count_out, const float* gnum,
                  const float* gden, float* out, int BH, int heads, int Gq, int d, int m,
                  int L, float gamma, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_step_kernel<DV, TILED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_step_kernel<DV, TILED><<<BH, kThreads, smem, stream>>>(
      q, k_t, v_t, phi_q, phi_buf, k_buf, v_buf, S, Z, count_in, count_out,
      gnum, gden, out, heads, Gq, d, m, L, gamma);
  return (int)cudaGetLastError();
}

// the whole ring where it fits, else the tiled ring
template <int DV>
int launch(const float* q, const float* k_t, const float* v_t, const float* phi_q,
           const float* phi_buf, float* k_buf, float* v_buf, float* S, float* Z,
           const int32_t* count_in, int32_t* count_out, const float* gnum,
           const float* gden, float* out, int BH, int heads, int Gq, int d, int m,
           int L, float gamma, cudaStream_t stream) {
  constexpr size_t kLimit = 227 * 1024;
  size_t smem = sizeof(float) * (size_t)Layout(Gq, d, DV, L, m, false).total;
  if (smem <= kLimit)
    return launch_layout<DV, false>(q, k_t, v_t, phi_q, phi_buf, k_buf, v_buf, S, Z, count_in,
                                    count_out, gnum, gden, out, BH, heads, Gq, d, m, L, gamma,
                                    smem, stream);
  smem = sizeof(float) * (size_t)Layout(Gq, d, DV, L, m, true).total;
  if (smem > kLimit) return (int)cudaErrorInvalidValue;
  return launch_layout<DV, true>(q, k_t, v_t, phi_q, phi_buf, k_buf, v_buf, S, Z, count_in,
                                 count_out, gnum, gden, out, BH, heads, Gq, d, m, L, gamma,
                                 smem, stream);
}

bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" int decode_step_launch(
    const float* q, const float* k_t, const float* v_t, const float* phi_q,
    const float* phi_buf, float* k_buf, float* v_buf, float* S, float* Z,
    const int32_t* count_in, int32_t* count_out, const float* gnum,
    const float* gden, float* out, int BH, int heads, int Gq, int d, int dv,
    int m, int L, float gamma, void* stream) {
  if (BH <= 0 || heads <= 0 || BH % heads || Gq <= 0 || d <= 0 || d % 4 || m <= 0 ||
      m % 4 || L <= 0)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k_t, v_t, phi_q, phi_buf, k_buf, v_buf, S, Z, gnum, gden, out};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dv) {
    case 16: return launch<16>(q, k_t, v_t, phi_q, phi_buf, k_buf, v_buf, S, Z, count_in, count_out, gnum, gden, out, BH, heads, Gq, d, m, L, gamma, s);
    case 32: return launch<32>(q, k_t, v_t, phi_q, phi_buf, k_buf, v_buf, S, Z, count_in, count_out, gnum, gden, out, BH, heads, Gq, d, m, L, gamma, s);
    case 64: return launch<64>(q, k_t, v_t, phi_q, phi_buf, k_buf, v_buf, S, Z, count_in, count_out, gnum, gden, out, BH, heads, Gq, d, m, L, gamma, s);
    case 128: return launch<128>(q, k_t, v_t, phi_q, phi_buf, k_buf, v_buf, S, Z, count_in, count_out, gnum, gden, out, BH, heads, Gq, d, m, L, gamma, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
