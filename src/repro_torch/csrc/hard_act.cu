// Elementwise integer hard activations for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (kernels/hard_act.py binds it,
// kernels/_build.py compiles it).
//
// Replaces the TPU kernels of src/repro/kernels/hard_act.py:
//   * hard_sigmoid_star_pallas — HardSigmoid* on integer codes, three
//     bit-identical methods:
//       arithmetic: y = x < -bound ? 0 : x >= bound ? one
//                       : clamp((x >> slope_shift) + half, 0, one),
//                   then saturated to the code range;
//       step:       y = outputs[#{thresholds <= x}] over the merged step
//                   table (hard_act.step_table).  The TPU kernel unrolls
//                   the comparator cascade; here the count is found by
//                   bisection over the ascending thresholds, staged in
//                   shared memory — the same index, so the same output;
//       1to1:       y = table[x - int_min] over the full one_to_one_table
//                   (read through the read-only cache from device memory:
//                   65,536 int32 entries at (8,16) exceed shared memory);
//                   a code outside the table gives 0, as the TPU kernel's
//                   one-hot contraction does;
//   * hard_tanh_pallas — clamp(x, ht_lo, ht_hi) at the quantised bounds.
// Output codes have the input's dtype (int8 / int16 / int32).
//
// What bounds it on this card: bytes.  One read and one write per element
// and a handful of integer operations, so the design is a grid-stride loop
// that moves 16 bytes per thread per access (a uint4 of codes) when both
// pointers are 16-byte aligned, and one code at a time for the tail.

#include <cuda_runtime.h>
#include <stdint.h>

struct HactArgs {
  const void* x;         // n codes
  void* out;             // n codes, same dtype
  const int* thr;        // step: (n_thr,) ascending thresholds
  const int* outs;       // step: (n_thr + 1,) outputs
  const int* table;      // 1to1: (table_size,) outputs for codes table_min...
  long long n;
  int method;            // 0 arithmetic, 1 step, 2 1to1, 3 HardTanh
  int slope_shift, bound_int, half_int, one_int;
  int lo, hi;            // arithmetic: the code range; HardTanh: the bounds
  int n_thr;
  int thr_smem;          // 1: the step table is staged in shared memory
  int table_min, table_size;
  int vec;               // 1: x and out are 16-byte aligned
};

enum { ARITH = 0, STEP = 1, LUT = 2, HTANH = 3 };

template <int METHOD>
__device__ __forceinline__ int act(int x, const HactArgs& a, const int* thr,
                                   const int* outs) {
  if (METHOD == ARITH) {
    const int lin = min(max((x >> a.slope_shift) + a.half_int, 0), a.one_int);
    const int y = x < -a.bound_int ? 0 : (x >= a.bound_int ? a.one_int : lin);
    return min(max(y, a.lo), a.hi);
  } else if (METHOD == STEP) {
    int lo = 0, hi = a.n_thr;            // first threshold > x
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (thr[mid] <= x) lo = mid + 1; else hi = mid;
    }
    return outs[lo];
  } else if (METHOD == LUT) {
    const long long i = (long long)x - a.table_min;
    return (i >= 0 && i < a.table_size) ? __ldg(a.table + i) : 0;
  } else {
    return min(max(x, a.lo), a.hi);
  }
}

template <typename T, int METHOD>
__global__ void __launch_bounds__(256) hard_act_kernel(const HactArgs a) {
  extern __shared__ int smem[];
  const int* thr = a.thr;
  const int* outs = a.outs;
  if (METHOD == STEP && a.thr_smem) {
    for (int i = threadIdx.x; i < a.n_thr; i += blockDim.x) smem[i] = a.thr[i];
    for (int i = threadIdx.x; i <= a.n_thr; i += blockDim.x) smem[a.n_thr + i] = a.outs[i];
    __syncthreads();
    thr = smem;
    outs = smem + a.n_thr;
  }
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  constexpr int V = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_vec = a.vec ? a.n / V : 0;
  for (long long i = tid; i < n_vec; i += stride) {
    union { uint4 u; T e[V]; } v;
    v.u = reinterpret_cast<const uint4*>(x)[i];
#pragma unroll
    for (int j = 0; j < V; ++j) v.e[j] = (T)act<METHOD>((int)v.e[j], a, thr, outs);
    reinterpret_cast<uint4*>(out)[i] = v.u;
  }
  for (long long i = n_vec * V + tid; i < a.n; i += stride)
    out[i] = (T)act<METHOD>((int)x[i], a, thr, outs);
}

template <typename T>
static int launch_typed(HactArgs* a, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  constexpr int V = 16 / sizeof(T);
  const long long work = (a->n + V - 1) / V;
  const long long cap = 8LL * sms;                 // enough blocks to fill the card
  const int blocks = (int)(work < 1 ? 1 : ((work + 255) / 256 < cap ? (work + 255) / 256 : cap));
  const long long table_bytes = (2LL * a->n_thr + 1) * sizeof(int);
  a->thr_smem = (a->method == STEP && table_bytes <= 48 * 1024) ? 1 : 0;
  const size_t smem = a->thr_smem ? (size_t)table_bytes : 0;
  switch (a->method) {
    case ARITH: hard_act_kernel<T, ARITH><<<blocks, 256, 0, s>>>(*a); break;
    case STEP:  hard_act_kernel<T, STEP><<<blocks, 256, smem, s>>>(*a); break;
    case LUT:   hard_act_kernel<T, LUT><<<blocks, 256, 0, s>>>(*a); break;
    case HTANH: hard_act_kernel<T, HTANH><<<blocks, 256, 0, s>>>(*a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" {

// Launch on `stream`; elem_bytes (1, 2, 4) picks int8/int16/int32 codes.
// Returns cudaGetLastError() (0 = launched).
int hact_launch(HactArgs* a, int elem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->n <= 0) return (int)cudaErrorInvalidValue;
  a->vec = ((reinterpret_cast<uintptr_t>(a->x) | reinterpret_cast<uintptr_t>(a->out)) % 16) == 0;
  switch (elem_bytes) {
    case 1: return launch_typed<int8_t>(a, s);
    case 2: return launch_typed<int16_t>(a, s);
    case 4: return launch_typed<int32_t>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int hact_args_size(void) { return (int)sizeof(HactArgs); }

const char* hact_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
