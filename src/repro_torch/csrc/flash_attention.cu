// Online-softmax (flash) attention for Hopper (sm_90a) in fp32 on the CUDA
// cores, with a plain C interface loaded through ctypes
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
// prefill shape (T = S = 2048, hd = 64, causal) that is 8.6 GFLOP against
// 33.5 MB.  No TF32: it cannot hold the 2e-5 tolerance against the fp32
// reference.  Design:
//   * one block of 8 warps per (bh, tile of 32 query rows), each warp
//     owning 4 rows; q tile, k and v tiles (32 keys) staged in shared
//     memory as fp32 (bf16 is widened on the way in);
//   * scores: lane j takes key j of the tile and forms the dot products of
//     its 4 rows (q read as broadcast float4, k as float4 from rows padded
//     by 4 floats), so a warp finds its row maxima and sums with one
//     shuffle reduction per 32 keys;
//   * p goes through shared memory; for p.v the lanes split hd, so the
//     running (m, l, acc) of a row lives in the registers of its warp;
//   * kv tiles wholly above the diagonal or wholly outside the window are
//     not loaded; a warp skips the tiles its own rows cannot see.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
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

constexpr int NW = 8, R = 4, BQ = NW * R, BK = 32, THREADS = NW * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline size_t smem_floats(int hd) {
  return (size_t)BQ * hd + (size_t)BK * (hd + 4) + (size_t)BK * hd + (size_t)NW * R * BK;
}

// DPL: head dims per lane in p.v (hd <= 32 * DPL).
template <typename T, int DPL>
__global__ void __launch_bounds__(THREADS) flash_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int hd = a.hd, ldk = hd + 4;
  float* sq = smem;                      // [BQ][hd]
  float* sk = sq + BQ * hd;              // [BK][hd + 4]
  float* sv = sk + BK * ldk;             // [BK][hd]
  float* sp = sv + BK * hd;              // [NW][R][BK]

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* q = static_cast<const T*>(a.q) + (size_t)bh * a.T * hd;
  const T* k = static_cast<const T*>(a.k) + (size_t)bh * a.S * hd;
  const T* v = static_cast<const T*>(a.v) + (size_t)bh * a.S * hd;

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd;
    sq[i] = (q0 + r < a.T) ? to_f32(q[(size_t)q0 * hd + i]) : 0.f;
  }

  // Keys any row of this block can see: [kv_lo, kv_hi).
  int kv_lo = 0, kv_hi = a.S;
  if (a.causal) kv_hi = min(a.S, q0 + BQ);
  if (a.has_window) kv_lo = max(0, q0 - a.window + 1);
  const int row0 = q0 + warp * R;        // this warp's first query row

  float m[R], l[R], acc[R][DPL];
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  for (int kt = (kv_lo / BK) * BK; kt < kv_hi; kt += BK) {
    __syncthreads();                     // the previous tile is consumed
    for (int i = tid; i < BK * hd; i += THREADS) {
      const int j = i / hd, d = i - j * hd;
      const bool in = kt + j < a.S;
      const size_t g = (size_t)kt * hd + i;
      sk[j * ldk + d] = in ? to_f32(k[g]) : 0.f;
      sv[i] = in ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();
    if (row0 >= a.T) continue;
    if (a.causal && kt > row0 + R - 1) continue;                     // above the diagonal
    if (a.has_window && row0 - (kt + BK - 1) >= a.window) continue;  // outside the window

    // Scores of this lane's key against the warp's R rows.
    const int kpos = kt + lane;
    float s[R];
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const float* kr = sk + lane * ldk;
    const float* qr = sq + warp * R * hd;
    for (int d = 0; d < hd; d += 4) {
      const float4 kv4 = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + r * hd + d);
        s[r] = fmaf(qv.x, kv4.x, s[r]);
        s[r] = fmaf(qv.y, kv4.y, s[r]);
        s[r] = fmaf(qv.z, kv4.z, s[r]);
        s[r] = fmaf(qv.w, kv4.w, s[r]);
      }
    }
    float corr[R];
    float* pw = sp + warp * R * BK;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = row0 + r;
      const bool keep = kpos < a.S && (!a.causal || kpos <= qpos) &&
                        (!a.has_window || qpos - kpos < a.window);
      const float sc = keep ? s[r] * a.scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sc));
      float p = 0.f;
      corr[r] = 1.f;
      if (m_new != -INFINITY) {          // the row has seen a kept key
        p = keep ? expf(sc - m_new) : 0.f;
        corr[r] = expf(m[r] - m_new);    // 0 while m[r] is still -inf
      }
      l[r] = l[r] * corr[r] + warp_sum(p);
      m[r] = m_new;
      pw[r * BK + lane] = p;
    }
    __syncwarp();

    // acc = acc * corr + p . v, lanes splitting hd.
    for (int r = 0; r < R; ++r)
      for (int e = 0; e < DPL; ++e) acc[r][e] *= corr[r];
    for (int j = 0; j < BK; j += 4) {
      float4 p4[R];
#pragma unroll
      for (int r = 0; r < R; ++r) p4[r] = *reinterpret_cast<const float4*>(pw + r * BK + j);
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        if (d >= hd) break;
        const float v0 = sv[(j + 0) * hd + d], v1 = sv[(j + 1) * hd + d];
        const float v2 = sv[(j + 2) * hd + d], v3 = sv[(j + 3) * hd + d];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float t = acc[r][e];
          t = fmaf(p4[r].x, v0, t);
          t = fmaf(p4[r].y, v1, t);
          t = fmaf(p4[r].z, v2, t);
          t = fmaf(p4[r].w, v3, t);
          acc[r][e] = t;
        }
      }
    }
    __syncwarp();                        // pw is rewritten by the next tile
  }

  T* o = static_cast<T*>(a.o) + (size_t)bh * a.T * hd;
  for (int r = 0; r < R; ++r) {
    const int qpos = row0 + r;
    if (qpos >= a.T) break;
    if (l[r] == 0.f) {                   // no kept key: uniform weights 1/S
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        if (d >= hd) break;
        float sum = 0.f;
        for (int j = 0; j < a.S; ++j) sum += to_f32(v[(size_t)j * hd + d]);
        acc[r][e] = sum;
      }
      l[r] = (float)a.S;
    }
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) o[(size_t)qpos * hd + d] = from_f32<T>(acc[r][e] / l[r]);
    }
  }
}

template <typename T, int DPL>
static int launch_typed(const FlashArgs& a, cudaStream_t s) {
  const size_t bytes = smem_floats(a.hd) * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, DPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.T + BQ - 1) / BQ, a.BH);
  flash_kernel<T, DPL><<<grid, THREADS, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_dpl(const FlashArgs& a, cudaStream_t s) {
  if (a.hd <= 32) return launch_typed<T, 1>(a, s);
  if (a.hd <= 64) return launch_typed<T, 2>(a, s);
  if (a.hd <= 128) return launch_typed<T, 4>(a, s);
  return launch_typed<T, 8>(a, s);
}

extern "C" {

// Launch on `stream`; bf16 = 1 takes bf16 q/k/v/o, else f32.  hd must be a
// multiple of 4 in [4, 256].  Returns cudaGetLastError() (0 = launched).
int flash_launch(FlashArgs* a, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->hd < 4 || a->hd > 256 || a->hd % 4 || a->T <= 0 || a->S <= 0 || a->BH <= 0)
    return (int)cudaErrorInvalidValue;
  return bf16 ? launch_dpl<__nv_bfloat16>(*a, s) : launch_dpl<float>(*a, s);
}

int flash_args_size(void) { return (int)sizeof(FlashArgs); }

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
