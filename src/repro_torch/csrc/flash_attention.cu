// Online-softmax (flash) attention for Hopper (sm_90a) on the TF32 tensor
// cores in 3xTF32 form, with a plain C interface loaded through ctypes
// (kernels/flash_attention.py binds it, kernels/_build.py compiles it).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas.
//
// What it computes: o = softmax(q k^T * scale + mask) v per (batch*head),
// q (BH, T, hd), k/v (BH, S, hd), f32 or bf16, accumulated in fp32, the
// result in q's dtype.  The mask keeps key s for query t when s < S, and
// s <= t (causal), and t - s < window (sliding window).  A query row that
// has seen no kept key yet contributes nothing (p = 0): the TPU kernel lets
// such a row accumulate exp(0) terms and relies on a later block to scale
// them away; here they are never added.  A row with no kept key at all
// (a window that ends before the first key) gets the mean of v over all
// S keys, which is what the reference softmax gives when every score is
// masked.
//
// What bounds it on this card: operations.  4*hd flops per kept (query,
// key) pair against 16*hd bytes per row of q, k, v and o; at the qwen1.5
// prefill shape (T = S = 2048, hd = 64, causal) 8.6 GFLOP against 33.5 MB.
// One TF32 product keeps 10 mantissa bits and misses the reference's 2e-5
// tolerance by far; three do not: each f32 operand x splits into
// hi = tf32(x) and lo = x - hi, and hi*hi + hi*lo + lo*hi, summed in fp32,
// drops only lo*lo and lo's own rounding (below 2^-21 relative).  So both
// products run on mma.sync m16n8k8 tf32 at three MMAs each (bf16 q, k, v
// are exact in tf32: QK^T takes one MMA and PV two, only p being split),
// and the bound is 3 x 8.6 GFLOP at TF32's 495 TFLOP/s.  mma.sync, not
// wgmma: wgmma's tf32 form takes both operands K-major from shared memory,
// and V as PV's B operand is N-major.  Design:
//   * one block of 8 warps per (bh, tile of 64 query rows): 4 row groups
//     of 16 rows (the MMA's m16) times 2 key groups, each taking half of
//     every K/V tile with its own (m, l, o); the two merge once at the end.
//     A causal prefill is bound by its longest block (the last q tile sees
//     every key), and the key split halves that chain;
//   * the grid runs heads fastest and q tiles in reverse, so every head's
//     heaviest causal tiles start first;
//   * K/V tiles of 64 keys (32 at hd > 128), double-buffered: cp.async
//     copies of 4 elements fill the next tile while the MMAs run on this
//     one, zero-filling rows past S and the hd padding; hd is padded to a
//     multiple of 8 (zeros add nothing to q.k); one barrier a tile;
//   * within each 8-wide hd step, MMA column t is hd 2t and column t+4 hd
//     2t+1 (for q and k alike), so a fragment pair is one 8-byte load; k
//     rows padded by 8 and v rows by 4 elements make the B fragments
//     K[n0+g][d0+2t..] and V[k0+2t(+1)][n0+g] hit 32 distinct banks (f32);
//   * the split into hi and lo is two integer operations and a subtraction
//     (cvt runs on the slower conversion pipe); the MMAs are issued term by
//     term, so consecutive MMAs are independent;
//   * the online softmax runs on the accumulator fragments in log2 units
//     (ex2.approx): each score row lives in one quad of 4 threads, so a row
//     max takes two __shfl_xor steps and the row sum is reduced once, at
//     the end;
//   * p never moves: the C fragment of S = QK^T holds columns 2t, 2t+1 of
//     each 8-key slice, the A fragment of PV wants columns t, t+4.  Within
//     each slice the keys are taken in the order (0,2,4,6,1,3,5,7), so A
//     column t is key 2t and column t+4 key 2t+1, both already in the
//     thread's registers; V's B fragment reads rows 2t and 2t+1 to match;
//   * kv tiles wholly above the diagonal or wholly outside the window are
//     not loaded; a warp skips the half tiles its own rows cannot see, and
//     applies the per-element mask only on edge tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <algorithm>
#include <math.h>
#include <stdint.h>

struct FlashArgs {
  const void* q;      // (BH, T, hd)
  const void* k;      // (BH, S, hd)
  const void* v;      // (BH, S, hd)
  void* o;            // (BH, T, hd), q's dtype
  int BH, T, S, hd;
  int causal;
  int has_window, window;
  float scale;
};

constexpr int BQ = 64, THREADS = 256;   // 8 warps: 4 row groups x 2 key groups

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = v.x;
  b = v.y;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// x ~ hi + lo.  hi is x rounded to tf32, to nearest with ties away from
// zero (cvt.rna's rounding, in two integer operations: cvt runs on the
// slower conversion pipe); lo = x - hi is exact in fp32 and goes to the MMA
// as it is: the tensor cores read a tf32 operand's top 19 bits, so lo is
// truncated to tf32 there (an error below 2^-21 |x|).  Without SPLIT, x is
// exact in tf32 (bf16 data) and lo is not used.
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (SPLIT) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// 2^x on the SFU; inputs are <= 0 here (scores minus their running max),
// and results below 2^-126 flush to zero, where they add nothing to a sum.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy BYTES from global to shared memory, or zeros when !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(s), "l"(src), "n"(BYTES), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

// Rows [row0, row0 + nrows) of a (rows, hd) matrix into dst (stride ld),
// 4 elements per copy; rows past `rows` and columns past hd become zeros.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, int row0,
                                          int nrows, int rows, int hd, int hdp) {
  const int cpr = hdp / 4;
  for (int i = threadIdx.x; i < nrows * cpr; i += THREADS) {
    const int r = i / cpr, c = (i - r * cpr) * 4;
    const bool valid = row0 + r < rows && c < hd;
    cp_async<(int)(4 * sizeof(T))>(dst + r * ld + c,
                            valid ? src + (size_t)(row0 + r) * hd + c : src, valid);
  }
}

// HDMAX: the padded hd this instance covers (loops are unrolled to it);
// BK: keys per tile, split between the two warp groups.
template <typename T, int HDMAX, int BK>
__global__ void __launch_bounds__(THREADS, HDMAX <= 64 ? 2 : 1) flash_tc_kernel(const FlashArgs a) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NKS = HDMAX / 8;         // 8-wide steps over hd
  constexpr int NT = BK / 16;            // 8-key slices of a warp's half tile
  constexpr int G = NKS < 8 ? NKS : 8;   // hd steps of PV split at a time
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = a.hd, hdp = (hd + 7) & ~7, nks = hdp / 8;
  const int ldk = hdp + 8, ldv = hdp + 4;   // q's rows as k's
  // [stage][k [BK][ldk], v [BK][ldv]], then q [BQ][ldk]
  const int stage_elems = BK * (ldk + ldv);
  T* skv = reinterpret_cast<T*>(smem_raw);
  T* sq = skv + 2 * stage_elems;

  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kgroup = warp / 4, koff = kgroup * (BK / 2);
  const T* q = static_cast<const T*>(a.q) + (size_t)bh * a.T * hd;
  const T* k = static_cast<const T*>(a.k) + (size_t)bh * a.S * hd;
  const T* v = static_cast<const T*>(a.v) + (size_t)bh * a.S * hd;

  // Keys any row of this block can see: [kv_lo, kv_hi).
  int kv_lo = 0, kv_hi = a.S;
  if (a.causal) kv_hi = min(a.S, q0 + BQ);
  if (a.has_window) kv_lo = max(0, q0 - a.window + 1);
  const int kt0 = (kv_lo / BK) * BK;
  const int ntiles = kv_hi > kt0 ? (kv_hi - kt0 + BK - 1) / BK : 0;
  auto stage_k = [&](int st) { return skv + st * stage_elems; };
  auto stage_v = [&](int st) { return skv + st * stage_elems + BK * ldk; };
  auto load_kv = [&](int st, int kt) {
    load_tile(stage_k(st), ldk, k, kt, BK, a.S, hd, hdp);
    load_tile(stage_v(st), ldv, v, kt, BK, a.S, hd, hdp);
  };

  load_tile(sq, ldk, q, q0, BQ, a.T, hd, hdp);
  if (ntiles > 0) load_kv(0, kt0);
  cp_commit();

  const float scale2 = a.scale * 1.4426950408889634f;   // scores in log2 units
  const int r0 = q0 + (warp % 4) * 16;       // this warp's first query row
  const int rows[2] = {r0 + g, r0 + g + 8};  // the thread's two rows
  const T* sqw = sq + (warp % 4) * 16 * ldk;
  float o[NKS][4];
  for (int j = 0; j < NKS; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1, kt = kt0 + it * BK + koff;   // kt: this warp's keys
    cp_wait<0>();
    __syncthreads();                       // tile it is in; stage st^1 is free
    if (it + 1 < ntiles) load_kv(st ^ 1, kt0 + (it + 1) * BK);   // while it runs
    cp_commit();
    const bool skip = r0 >= a.T || (a.causal && kt > r0 + 15) ||
                      (a.has_window && r0 - (kt + BK / 2 - 1) >= a.window);
    if (skip) continue;
    const T* sk = stage_k(st) + koff * ldk;
    const T* sv = stage_v(st) + koff * ldv;

    // S = q k^T for the warp's 16 rows and its BK/2 keys.  Within each
    // 8-wide hd step, MMA column t is hd 2t and column t+4 is hd 2t+1, for
    // q and k alike (the sum over hd is the same), so each fragment pair is
    // two neighbouring elements.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      if (ks >= nks) break;
      uint32_t ah[4], al[4];
      {
        float x0, x1, x2, x3;
        load2(sqw + g * ldk + ks * 8 + 2 * t, x0, x2);
        load2(sqw + (g + 8) * ldk + ks * 8 + 2 * t, x1, x3);
        split<F32>(x0, ah[0], al[0]);
        split<F32>(x1, ah[1], al[1]);
        split<F32>(x2, ah[2], al[2]);
        split<F32>(x3, ah[3], al[3]);
      }
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float k0, k1;
        load2(sk + (j * 8 + g) * ldk + ks * 8 + 2 * t, k0, k1);
        split<F32>(k0, bh[j][0], bl[j][0]);
        split<F32>(k1, bh[j][1], bl[j][1]);
      }
      // term by term, so that consecutive MMAs are independent
      if (F32) {
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(s[j], al, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(s[j], ah, bl[j][0], bl[j][1]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(s[j], ah, bh[j][0], bh[j][1]);
    }
    // Scale, mask (edge tiles only), and the tile's row maxima.
    const bool edge = kt + BK / 2 > a.S || (a.causal && kt + BK / 2 - 1 > r0) ||
                      (a.has_window && r0 + 15 - kt >= a.window);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale2;
        if (edge) {
          const int kpos = kt + j * 8 + 2 * t + (e & 1), qpos = rows[e >> 1];
          const bool keep = kpos < a.S && (!a.causal || kpos <= qpos) &&
                            (!a.has_window || qpos - kpos < a.window);
          if (!keep) x = -INFINITY;
        }
        s[j][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float m_new = fmaxf(m[h], mt[h]);
      // 0 while m[h] is still -inf; 1 while the row has seen no kept key
      const float corr = m_new == -INFINITY ? 1.f : ex2(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr;
#pragma unroll
      for (int j = 0; j < NKS; ++j) {
        o[j][2 * h] *= corr;
        o[j][2 * h + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mh = m[e >> 1];
        const float p = mh == -INFINITY ? 0.f : ex2(s[j][e] - mh);
        l[e >> 1] += p;
        s[j][e] = p;
      }
    }
    // o += p v.  Key slice j in the order (0,2,4,6,1,3,5,7): the C
    // fragment (c0..c3) is then the A fragment (c0, c2, c1, c3).
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ph[4], pl[4];
      split<true>(s[j][0], ph[0], pl[0]);
      split<true>(s[j][2], ph[1], pl[1]);
      split<true>(s[j][1], ph[2], pl[2]);
      split<true>(s[j][3], ph[3], pl[3]);
      const T* vr = sv + (j * 8 + 2 * t) * ldv + g;
#pragma unroll
      for (int d0 = 0; d0 < NKS; d0 += G) {
        if (d0 >= nks) break;
        uint32_t bh[G][2], bl[G][2];
#pragma unroll
        for (int i = 0; i < G; ++i) {
          if (d0 + i >= nks) break;
          split<F32>(to_f32(vr[(d0 + i) * 8]), bh[i][0], bl[i][0]);
          split<F32>(to_f32(vr[(d0 + i) * 8 + ldv]), bh[i][1], bl[i][1]);
        }
#pragma unroll
        for (int i = 0; i < G; ++i)
          if (d0 + i < nks) mma_tf32(o[d0 + i], pl, bh[i][0], bh[i][1]);
        if (F32) {
#pragma unroll
          for (int i = 0; i < G; ++i)
            if (d0 + i < nks) mma_tf32(o[d0 + i], ph, bl[i][0], bl[i][1]);
        }
#pragma unroll
        for (int i = 0; i < G; ++i)
          if (d0 + i < nks) mma_tf32(o[d0 + i], ph, bh[i][0], bh[i][1]);
      }
    }
  }
  cp_wait<0>();

  // Merge the two key groups: group 1 leaves (m, l, o) in shared memory in
  // its fragment layout, the group-0 warp of the same rows takes it in.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float* xch = reinterpret_cast<float*>(smem_raw) + (warp % 4) * (4 * nks + 4) * 32 + lane;
  __syncthreads();                         // every warp is done with the stages
  if (kgroup == 1) {
    xch[0] = m[0]; xch[32] = m[1]; xch[64] = l[0]; xch[96] = l[1];
#pragma unroll
    for (int j = 0; j < NKS; ++j) {
      if (j >= nks) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[(4 + 4 * j + e) * 32] = o[j][e];
    }
  }
  __syncthreads();
  if (kgroup == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m1 = xch[32 * h], l1 = xch[64 + 32 * h];
    const float mc = fmaxf(m[h], m1);
    const float f0 = mc == -INFINITY ? 0.f : ex2(m[h] - mc);
    const float f1 = mc == -INFINITY ? 0.f : ex2(m1 - mc);
    l[h] = l[h] * f0 + l1 * f1;
#pragma unroll
    for (int j = 0; j < NKS; ++j) {
      if (j >= nks) break;
      o[j][2 * h] = o[j][2 * h] * f0 + xch[(4 + 4 * j + 2 * h) * 32] * f1;
      o[j][2 * h + 1] = o[j][2 * h + 1] * f0 + xch[(5 + 4 * j + 2 * h) * 32] * f1;
    }
  }

  T* out = static_cast<T*>(a.o) + (size_t)bh * a.T * hd;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = rows[h];
    if (qpos >= a.T) continue;
    const bool empty = l[h] == 0.f;        // no kept key: uniform weights 1/S
    const float inv = 1.f / (empty ? (float)a.S : l[h]);
#pragma unroll
    for (int dn = 0; dn < NKS; ++dn) {
      const int d = dn * 8 + 2 * t;
      if (d >= hd) break;
      float x0 = o[dn][2 * h], x1 = o[dn][2 * h + 1];
      if (empty) {
        x0 = x1 = 0.f;
        for (int j = 0; j < a.S; ++j) {
          x0 += to_f32(v[(size_t)j * hd + d]);
          x1 += to_f32(v[(size_t)j * hd + d + 1]);
        }
      }
      store2(out + (size_t)qpos * hd + d, x0 * inv, x1 * inv);
    }
  }
}

template <typename T, int HDMAX, int BK>
static int launch_typed(const FlashArgs& a, cudaStream_t s) {
  // two stages of k and v rows (hdp + 8 and hdp + 4), then q's rows; the
  // merge's exchange (4 warps x 32 lanes x (hdp / 2 + 4) floats) reuses them
  const auto smem_bytes = [](int hdp) {
    return std::max((2 * BK * (2 * hdp + 12) + BQ * (hdp + 8)) * (int)sizeof(T),
               4 * 32 * (hdp / 2 + 4) * (int)sizeof(float));
  };
  const int bytes = smem_bytes((a.hd + 7) & ~7);
  // The most this instance can ask for, set once per process (before any
  // CUDA-graph capture can reach here).
  static bool smem_set = false;
  if (!smem_set) {
    const int most = smem_bytes(HDMAX);
    cudaError_t e = cudaFuncSetAttribute(flash_tc_kernel<T, HDMAX, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         most);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int qtiles = (a.T + BQ - 1) / BQ;
  if (qtiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(a.BH, qtiles);          // every head's heaviest q tile first
  flash_tc_kernel<T, HDMAX, BK><<<grid, THREADS, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_hd(const FlashArgs& a, cudaStream_t s) {
  if (a.hd <= 32) return launch_typed<T, 32, 64>(a, s);
  if (a.hd <= 64) return launch_typed<T, 64, 64>(a, s);
  if (a.hd <= 128) return launch_typed<T, 128, 64>(a, s);
  return launch_typed<T, 256, 32>(a, s);   // 64 keys would pass 227 KB
}

extern "C" {

// Launch on `stream`; bf16 = 1 takes bf16 q/k/v/o, else f32.  hd must be a
// multiple of 4 in [4, 256], and q, k, v, o aligned to 4 elements.
// Returns cudaGetLastError() (0 = launched).
int flash_launch(FlashArgs* a, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->hd < 4 || a->hd > 256 || a->hd % 4 || a->T <= 0 || a->S <= 0 || a->BH <= 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = bf16 ? 8 : 16;
  const void* ptrs[4] = {a->q, a->k, a->v, a->o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % align) return (int)cudaErrorMisalignedAddress;
  return bf16 ? launch_hd<__nv_bfloat16>(*a, s) : launch_hd<float>(*a, s);
}

int flash_args_size(void) { return (int)sizeof(FlashArgs); }

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
