// Integer GEMM with an int32 accumulator and the fused S5 requantisation,
// for Hopper (sm_90a), with a plain C interface loaded through ctypes
// (kernels/quant_matmul.py binds it, kernels/_build.py compiles it).
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul.py::
// quant_matmul_pallas (both out_modes).
//
// What it computes: out = x (M, K) . w (K, N) over integer codes, summed in
// int32 with XLA's wraparound (unsigned arithmetic, reinterpreted), then
//   * out_mode "int32":   the raw accumulator;
//   * out_mode "requant": one round-half-up shift plus saturation (stage
//     S5: clamp((acc + 2^(shift-1)) >> shift, lo, hi), the add wrapping),
//     applied once after the last K tile, stored in the code dtype.
// Addition modulo 2^32 is associative, so the tiling (and the reference's
// `block`) cannot change the result.
//
// What bounds it on this card: at the qwen1.5-0.5B prefill shape (2048 x
// 1024 x 2816) the int8 tensor cores would make it memory-bound on the
// int32 output (28 MB moved against 11.8 GOP).  This first kernel runs on
// the CUDA cores: __dp4a (four int8 products summed into an int32, the
// add wrapping) for int8 codes, a scalar wrapping MAC for int16/int32
// codes, so it is bound by the CUDA cores' integer rate, far above the
// bound.  Design:
//   * one 256-thread block per 64 x 64 output tile; the K loop runs inside
//     the block (the TPU's sequential K grid axis), the accumulator in
//     registers, 4 x 4 outputs per thread;
//   * K tiles of x and w staged in shared memory, w transposed so both
//     operands are read along K (packed 4 bytes at a time for __dp4a);
//     rows are padded by 4 bytes so the strided reads hit distinct banks;
//   * ragged edges are masked on load (zeros), so no padding copies.
// Tensor-core mma/wgmma (s8 x s8 -> s32) is later work; int16 codes have
// no integer tensor-core path on Hopper.

#include <cuda_runtime.h>
#include <stdint.h>

struct QmmArgs {
  const void* x;     // (M, K) codes
  const void* w;     // (K, N) codes, same dtype as x
  void* out;         // (M, N) int32 accumulator or requantised codes
  int M, K, N;
  int requant;       // 0: int32 accumulator, 1: S5 requantisation
  int shift, lo, hi; // S5 parameters (requant)
  int out_bytes;     // element size of out: 4 (int32), or 1/2/4 codes
  int vec;           // 1: x rows may be read 16 bytes at a time (int8)
};

constexpr int BM = 64, BN = 64, THREADS = 256;

__device__ __forceinline__ int s5(int acc, const QmmArgs& a) {
  int t = a.shift ? ((int)((unsigned)acc + (1u << (a.shift - 1))) >> a.shift) : acc;
  return min(max(t, a.lo), a.hi);
}

__device__ __forceinline__ void store_tile(const int (&acc)[4][4], int m0, int n0,
                                           const QmmArgs& a) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= a.M) continue;
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= a.N) continue;
      const long long o = (long long)m * a.N + n;
      const int v = a.requant ? s5(acc[i][j], a) : acc[i][j];
      switch (a.out_bytes) {
        case 1: static_cast<int8_t*>(a.out)[o] = (int8_t)v; break;
        case 2: static_cast<int16_t*>(a.out)[o] = (int16_t)v; break;
        default: static_cast<int32_t*>(a.out)[o] = v; break;
      }
    }
  }
}

// int8 codes: __dp4a over K packed four at a time.
constexpr int BK8 = 64, LD8 = BK8 + 4;   // bytes per staged row (+4: banks)

__global__ void __launch_bounds__(THREADS) qmm_dp4a_kernel(const QmmArgs a) {
  __shared__ __align__(16) int8_t sx[BM * LD8];   // [m][k]
  __shared__ __align__(16) int8_t sw[BN * LD8];   // [n][k] (w transposed)
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int8_t* x = static_cast<const int8_t*>(a.x);
  const int8_t* w = static_cast<const int8_t*>(a.w);
  int acc[4][4] = {};

  for (int k0 = 0; k0 < a.K; k0 += BK8) {
    {  // x tile: thread -> (row, 16-byte segment)
      const int r = tid / 4, seg = (tid % 4) * 16;
      const int m = m0 + r, k = k0 + seg;
      int* dst = reinterpret_cast<int*>(sx + r * LD8 + seg);
      if (a.vec && m < a.M && k + 16 <= a.K) {
        const int4 v = *reinterpret_cast<const int4*>(x + (long long)m * a.K + k);
        dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
      } else {
        for (int q = 0; q < 4; ++q) {
          unsigned packed = 0;
          for (int b = 0; b < 4; ++b) {
            const int kk = k + 4 * q + b;
            const int8_t e = (m < a.M && kk < a.K) ? x[(long long)m * a.K + kk] : 0;
            packed |= (unsigned)(uint8_t)e << (8 * b);
          }
          dst[q] = (int)packed;
        }
      }
    }
    {  // w tile, transposed: thread -> (column, 16 rows of K); loads along N
      const int c = tid % BN, kq = (tid / BN) * 16;
      const int n = n0 + c;
      int* dst = reinterpret_cast<int*>(sw + c * LD8 + kq);
      for (int q = 0; q < 4; ++q) {
        unsigned packed = 0;
        for (int b = 0; b < 4; ++b) {
          const int kk = k0 + kq + 4 * q + b;
          const int8_t e = (n < a.N && kk < a.K) ? w[(long long)kk * a.N + n] : 0;
          packed |= (unsigned)(uint8_t)e << (8 * b);
        }
        dst[q] = (int)packed;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK8; kk += 4) {
      int av[4], bv[4];
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const int*>(sx + (ty + 16 * i) * LD8 + kk);
      for (int j = 0; j < 4; ++j)
        bv[j] = *reinterpret_cast<const int*>(sw + (tx + 16 * j) * LD8 + kk);
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  store_tile(acc, m0, n0, a);
}

// int16 / int32 codes: scalar MAC, wrapping at 2^32.
constexpr int BKW = 32, LDW = BKW + 1;

template <typename T>
__global__ void __launch_bounds__(THREADS) qmm_wide_kernel(const QmmArgs a) {
  __shared__ int sx[BM * LDW];   // [m][k]
  __shared__ int sw[BN * LDW];   // [n][k]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  unsigned acc[4][4] = {};

  for (int k0 = 0; k0 < a.K; k0 += BKW) {
    for (int i = tid; i < BM * BKW; i += THREADS) {
      const int r = i / BKW, kk = i % BKW;          // loads along K
      const int m = m0 + r, k = k0 + kk;
      sx[r * LDW + kk] = (m < a.M && k < a.K) ? (int)x[(long long)m * a.K + k] : 0;
    }
    for (int i = tid; i < BN * BKW; i += THREADS) {
      const int c = i % BN, kk = i / BN;            // loads along N
      const int n = n0 + c, k = k0 + kk;
      sw[c * LDW + kk] = (n < a.N && k < a.K) ? (int)w[(long long)k * a.N + n] : 0;
    }
    __syncthreads();
    for (int kk = 0; kk < BKW; ++kk) {
      unsigned av[4], bv[4];
      for (int i = 0; i < 4; ++i) av[i] = (unsigned)sx[(ty + 16 * i) * LDW + kk];
      for (int j = 0; j < 4; ++j) bv[j] = (unsigned)sw[(tx + 16 * j) * LDW + kk];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
  int out[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) out[i][j] = (int)acc[i][j];
  store_tile(out, m0, n0, a);
}

extern "C" {

// Launch on `stream`; elem_bytes (1, 2, 4) is the element size of x and w
// (int8 / int16 / int32 codes).  Returns cudaGetLastError() (0 = launched).
int qmm_launch(QmmArgs* a, int elem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->M <= 0 || a->N <= 0 || a->K < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((a->N + BN - 1) / BN, (a->M + BM - 1) / BM);
  switch (elem_bytes) {
    case 1:
      a->vec = (a->K % 16 == 0 && (reinterpret_cast<uintptr_t>(a->x) % 16) == 0) ? 1 : 0;
      qmm_dp4a_kernel<<<grid, THREADS, 0, s>>>(*a);
      break;
    case 2: qmm_wide_kernel<int16_t><<<grid, THREADS, 0, s>>>(*a); break;
    case 4: qmm_wide_kernel<int32_t><<<grid, THREADS, 0, s>>>(*a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int qmm_args_size(void) { return (int)sizeof(QmmArgs); }

const char* qmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
