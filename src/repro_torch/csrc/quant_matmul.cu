// Integer GEMM with an int32 accumulator and the fused S5 requantisation,
// for Hopper (sm_90a), with a plain C interface loaded through ctypes
// (kernels/quant_matmul.py binds it, kernels/_build.py compiles it).
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul.py::
// quant_matmul_pallas (both out_modes).
//
// What it computes: out = x (M, K) . w (K, N) over integer codes, summed in
// int32 with XLA's wraparound, then
//   * out_mode "int32":   the raw accumulator;
//   * out_mode "requant": one round-half-up shift plus saturation (stage
//     S5: clamp((acc + 2^(shift-1)) >> shift, lo, hi), the add wrapping),
//     applied once after the last K tile, stored in the code dtype.
// Addition modulo 2^32 is associative, so the tiling (and the reference's
// `block`) cannot change the result.
//
// What bounds it on this card: at the qwen1.5-0.5B prefill shape (2048 x
// 1024 x 2816) the int8 tensor cores make it memory-bound: 11.8 GOP at
// 1,979 TOP/s take 6.0 us, the int32 output alone (23 MB of 28 MB moved)
// 6.9 us.  int8 codes therefore run on the int8 tensor cores:
//   * mma.sync m16n8k32 s8.s8.s32 without .satfinite, so the int32 sums
//     wrap modulo 2^32 exactly as XLA's do; mma.sync rather than wgmma,
//     since at half the int8 peak the MMAs still sit below the bytes bound;
//   * one 256-thread block per 128 x 128 output tile, 8 warps of 64 x 32,
//     K tiles of 128 bytes in a 3-stage cp.async ring (16-byte copies,
//     zero-filled past M, N and K; 108 KB, so two blocks share an SM), A
//     and B fragments through ldmatrix from rows padded to 144 bytes (8
//     rows x 16 bytes hit 32 banks);
//   * both MMA operands must be K-major, and w is (K, N); ldmatrix cannot
//     transpose 8-bit elements, so qmm_wt_kernel first writes w^T into an
//     (N, Kp) scratch (Kp = K rounded up to 16, zero-padded; one read and
//     one write of w, 2.9 MB each at the qwen shape, 4 bytes a thread where
//     N % 4 == 0), launched by the same call;
//   * x rows that are not 16-byte aligned (K % 16 != 0, or an offset base
//     pointer) are staged by byte loads in place of cp.async;
//   * the epilogue applies S5 in registers, stages the tile in shared
//     memory in the output dtype and writes it with 16-byte stores.
// int16/int32 codes have no integer tensor-core path on Hopper: they keep a
// CUDA-core kernel (one 64 x 64 tile per block, a wrapping scalar MAC).

#include <cuda_runtime.h>
#include <stdint.h>

struct QmmArgs {
  const void* x;     // (M, K) codes
  const void* w;     // (K, N) codes, same dtype as x
  void* out;         // (M, N) int32 accumulator or requantised codes
  void* wt;          // int8: (N, Kp) scratch for w^T, Kp = K rounded up to 16
  int M, K, N;
  int requant;       // 0: int32 accumulator, 1: S5 requantisation
  int shift, lo, hi; // S5 parameters (requant)
  int out_bytes;     // element size of out: 4 (int32), or 1/2/4 codes
};

__device__ __forceinline__ int s5(int acc, const QmmArgs& a) {
  int t = a.shift ? ((int)((unsigned)acc + (1u << (a.shift - 1))) >> a.shift) : acc;
  return min(max(t, a.lo), a.hi);
}

__device__ __forceinline__ void store_code(void* out, long long o, int v, int bytes) {
  switch (bytes) {
    case 1: static_cast<int8_t*>(out)[o] = (int8_t)v; break;
    case 2: static_cast<int16_t*>(out)[o] = (int16_t)v; break;
    default: static_cast<int32_t*>(out)[o] = v; break;
  }
}

// ---------------------------------------------------------------------------
// int8 codes: the tensor-core path
// ---------------------------------------------------------------------------

// w (K, N) -> wt (N, Kp), zeros in k >= K; a 64 x 64 byte tile per block.
__global__ void __launch_bounds__(256) qmm_wt_kernel(const QmmArgs a) {
  __shared__ __align__(4) uint8_t tile[64][68];   // [n][k]
  const int n0 = blockIdx.x * 64, k0 = blockIdx.y * 64, kp = (a.K + 15) & ~15;
  const uint8_t* w = static_cast<const uint8_t*>(a.w);
  if (a.N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0) {
    for (int i = threadIdx.x; i < 64 * 16; i += 256) {   // 4 bytes along N
      const int kk = i / 16, nn = (i % 16) * 4;
      const int k = k0 + kk, n = n0 + nn;
      const uint32_t word = (k < a.K && n < a.N)
          ? *reinterpret_cast<const uint32_t*>(w + (long long)k * a.N + n) : 0u;
      for (int b = 0; b < 4; ++b) tile[nn + b][kk] = (uint8_t)(word >> (8 * b));
    }
  } else {
    for (int i = threadIdx.x; i < 64 * 64; i += 256) {   // bytes along N
      const int kk = i / 64, nn = i % 64;
      const int k = k0 + kk, n = n0 + nn;
      tile[nn][kk] = (k < a.K && n < a.N) ? w[(long long)k * a.N + n] : 0;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * 16; i += 256) {
    const int nn = i / 16, kw = (i % 16) * 4;      // writes along K, 4 bytes
    const int n = n0 + nn, k = k0 + kw;
    if (n < a.N && k < kp)
      *reinterpret_cast<uint32_t*>(static_cast<uint8_t*>(a.wt) + (long long)n * kp + k) =
          *reinterpret_cast<const uint32_t*>(&tile[nn][kw]);
  }
}

constexpr int IM = 128, IN = 128, IK = 128, STAGES = 3, LDS = IK + 16;
constexpr int ITHREADS = 256;
constexpr int STAGE_BYTES = (IM + IN) * LDS;
constexpr int IMMA_SMEM = STAGES * STAGE_BYTES;   // 110,592 bytes: two blocks an SM
static_assert(IM * (IN * 4 + 32) <= IMMA_SMEM, "the int32 output tile is staged in the ring");

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// VX: x rows are 16-byte aligned (K % 16 == 0 and an aligned base).
template <bool VX>
__global__ void __launch_bounds__(ITHREADS) qmm_imma_kernel(const QmmArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;   // the warp's sub-tile
  const int m0 = blockIdx.y * IM, n0 = blockIdx.x * IN;
  const int kp = (a.K + 15) & ~15, ktiles = (a.K + IK - 1) / IK;
  const int8_t* x = static_cast<const int8_t*>(a.x);
  const int8_t* wt = static_cast<const int8_t*>(a.wt);

  auto load_stage = [&](int st, int kt) {
    uint8_t* sa = smem + st * STAGE_BYTES;
    uint8_t* sb = sa + IM * LDS;
    const int k0 = kt * IK;
    for (int i = tid; i < IM * (IK / 16); i += ITHREADS) {
      const int r = i / (IK / 16), c = (i % (IK / 16)) * 16;
      const int m = m0 + r, k = k0 + c;
      if (VX) {
        const bool ok = m < a.M && k < a.K;
        cp_async16(sa + r * LDS + c, ok ? x + (long long)m * a.K + k : x, ok);
      } else {
        uint32_t wd[4] = {0u, 0u, 0u, 0u};
        if (m < a.M)
          for (int b = 0; b < 16 && k + b < a.K; ++b)
            wd[b / 4] |= (uint32_t)(uint8_t)x[(long long)m * a.K + k + b] << (8 * (b % 4));
        *reinterpret_cast<uint4*>(sa + r * LDS + c) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
    }
    for (int i = tid; i < IN * (IK / 16); i += ITHREADS) {
      const int r = i / (IK / 16), c = (i % (IK / 16)) * 16;
      const int n = n0 + r, k = k0 + c;
      const bool ok = n < a.N && k < kp;
      cp_async16(sb + r * LDS + c, ok ? wt + (long long)n * kp + k : wt, ok);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ktiles) load_stage(st, st);
    cp_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();                 // tile kt landed; tile kt-1 consumed
    if (kt + STAGES - 1 < ktiles) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_commit();
    const uint8_t* sa = smem + (kt % STAGES) * STAGE_BYTES;
    const uint8_t* sb = sa + IM * LDS;
#pragma unroll
    for (int kk = 0; kk < IK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
      // A: matrices (rows 0-7 | 8-15) x (bytes 0-15 | 16-31) = a0..a3
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], sa + (wm + i * 16 + lane % 16) * LDS + kk + (lane / 16) * 16);
      // B: two n8 tiles per ldmatrix, (b0, b1) of each
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, sb + (wn + j * 8 + lane % 8 + (lane / 16) * 8) * LDS + kk +
                           ((lane / 8) % 2) * 16);
        bf[j][0] = r[0]; bf[j][1] = r[1]; bf[j + 1][0] = r[2]; bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_wait<0>();
  __syncthreads();                   // the ring is free: stage the output tile

  const int ob = a.out_bytes, ldo = IN * ob + (ob == 4 ? 32 : 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (a.requant) { v0 = s5(v0, a); v1 = s5(v1, a); }
        uint8_t* p = smem + (wm + i * 16 + g + 8 * h) * ldo + (wn + j * 8 + 2 * t) * ob;
        if (ob == 4) *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
        else if (ob == 2) *reinterpret_cast<uint32_t*>(p) = (uint32_t)(uint16_t)v0 | (uint32_t)v1 << 16;
        else *reinterpret_cast<uint16_t*>(p) = (uint16_t)((uint8_t)v0 | (uint32_t)(uint8_t)v1 << 8);
      }
  __syncthreads();
  const int cpr = IN * ob / 16, per = 16 / ob;      // 16-byte chunks per row
  const bool vec = (a.N * ob) % 16 == 0;           // out rows 16-byte aligned
  for (int i = tid; i < IM * cpr; i += ITHREADS) {
    const int r = i / cpr, c = (i % cpr) * per, m = m0 + r, n = n0 + c;
    if (m >= a.M || n >= a.N) continue;
    const uint8_t* src = smem + r * ldo + c * ob;
    const long long o = (long long)m * a.N + n;
    if (vec && n + per <= a.N) {
      *reinterpret_cast<uint4*>(static_cast<uint8_t*>(a.out) + o * ob) =
          *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < per && n + e < a.N; ++e) {
        const uint8_t* s = src + e * ob;
        const int val = ob == 4 ? *reinterpret_cast<const int*>(s)
                      : ob == 2 ? (int)*reinterpret_cast<const int16_t*>(s)
                                : (int)*reinterpret_cast<const int8_t*>(s);
        store_code(a.out, o + e, val, ob);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// int16 / int32 codes: scalar MAC on the CUDA cores, wrapping at 2^32
// ---------------------------------------------------------------------------

constexpr int WM = 64, WN = 64, WK = 32, LDW = WK + 1, WTHREADS = 256;

template <typename T>
__global__ void __launch_bounds__(WTHREADS) qmm_wide_kernel(const QmmArgs a) {
  __shared__ int sx[WM * LDW];   // [m][k]
  __shared__ int sw[WN * LDW];   // [n][k]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * WM, n0 = blockIdx.x * WN;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  unsigned acc[4][4] = {};

  for (int k0 = 0; k0 < a.K; k0 += WK) {
    for (int i = tid; i < WM * WK; i += WTHREADS) {
      const int r = i / WK, kk = i % WK;            // loads along K
      const int m = m0 + r, k = k0 + kk;
      sx[r * LDW + kk] = (m < a.M && k < a.K) ? (int)x[(long long)m * a.K + k] : 0;
    }
    for (int i = tid; i < WN * WK; i += WTHREADS) {
      const int c = i % WN, kk = i / WN;            // loads along N
      const int n = n0 + c, k = k0 + kk;
      sw[c * LDW + kk] = (n < a.N && k < a.K) ? (int)w[(long long)k * a.N + n] : 0;
    }
    __syncthreads();
    for (int kk = 0; kk < WK; ++kk) {
      unsigned av[4], bv[4];
      for (int i = 0; i < 4; ++i) av[i] = (unsigned)sx[(ty + 16 * i) * LDW + kk];
      for (int j = 0; j < 4; ++j) bv[j] = (unsigned)sw[(tx + 16 * j) * LDW + kk];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= a.M) continue;
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= a.N) continue;
      const int v = (int)acc[i][j];
      store_code(a.out, (long long)m * a.N + n, a.requant ? s5(v, a) : v, a.out_bytes);
    }
  }
}

static int launch_int8(const QmmArgs& a, cudaStream_t s) {
  if (a.K > 0) {
    const dim3 tgrid((a.N + 63) / 64, (((a.K + 15) & ~15) + 63) / 64);
    qmm_wt_kernel<<<tgrid, 256, 0, s>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const bool vx = a.K % 16 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  auto kern = vx ? qmm_imma_kernel<true> : qmm_imma_kernel<false>;
  // Set once per process, before any CUDA-graph capture can reach here.
  static bool smem_set[2] = {false, false};
  if (!smem_set[vx]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, IMMA_SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set[vx] = true;
  }
  const dim3 grid((a.N + IN - 1) / IN, (a.M + IM - 1) / IM);
  kern<<<grid, ITHREADS, IMMA_SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" {

// Launch on `stream`; elem_bytes (1, 2, 4) is the element size of x and w
// (int8 / int16 / int32 codes).  int8 needs `wt`: (N, Kp) int8 scratch,
// 16-byte aligned.  Returns cudaGetLastError() (0 = launched).
int qmm_launch(QmmArgs* a, int elem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->M <= 0 || a->N <= 0 || a->K < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((a->N + WN - 1) / WN, (a->M + WM - 1) / WM);
  switch (elem_bytes) {
    case 1:
      if (a->K > 0 && (a->wt == nullptr || reinterpret_cast<uintptr_t>(a->wt) % 16))
        return (int)cudaErrorInvalidValue;
      return launch_int8(*a, s);
    case 2: qmm_wide_kernel<int16_t><<<grid, WTHREADS, 0, s>>>(*a); break;
    case 4: qmm_wide_kernel<int32_t><<<grid, WTHREADS, 0, s>>>(*a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int qmm_args_size(void) { return (int)sizeof(QmmArgs); }

const char* qmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
