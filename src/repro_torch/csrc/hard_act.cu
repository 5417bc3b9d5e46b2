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
//       step:       the TPU kernel's unrolled comparator cascade over the
//                   merged step table (hard_act.step_table),
//                   y = outputs[0] + sum_i (x >= thr_i) * (outputs[i+1] - outputs[i]),
//                   on one of three routes the wrapper picks per (table,
//                   code dtype) (kernels/hard_act.py::step_route):
//                     bytes  — int8 codes, four to a 32-bit word: per
//                              threshold one subtract, one LOP3 (a
//                              majority of three bits) and one mad.hi
//                              that adds the delta into every byte that
//                              passed.  The table rides in the kernel's
//                              parameter space (__grid_constant__), so
//                              every lane reads the same constant-bank
//                              word: no shared memory, no barrier;
//                     words  — the same cascade one code at a time in
//                              int32 (int16/int32 codes, or int8 codes
//                              whose outputs leave a byte);
//                     bisect — tables of more than kCascadeCap (63) thresholds
//                              inside the code dtype's range ((8,16) has
//                              193): the index found by bisection over
//                              the thresholds staged in shared memory;
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
// pointers are 16-byte aligned, and one code at a time for the tail.  The
// step cascade's work per code grows with the table; the bytes route does
// four codes per instruction, ~3 instructions per threshold per word, so
// (4,8)'s 13 thresholds stay under the byte bound.
//
// The bytes route, per byte of a word (each byte a code x):
//   a = x + 128 (the biased, unsigned code), t = thr + 128 likewise;
//   low  = (x | 0x80) - (t & 0x7f): its top bit is (a & 0x7f) >= (t & 0x7f),
//          and it never borrows from the next byte (128 + 0..127 - 0..127);
//   ge   = maj(top bit of a, top bit of ~t, low): its top bit is a >= t;
//   acc += hi32(ge * (delta << 25)): delta in every byte whose top bit is
//          set (delta <= 127, so the product's bytes never meet).
// acc starts at (start + 128) in every byte and, since HardSigmoid* never
// decreases, stays in [start, end] + 128, inside a byte (the wrapper takes
// this route only for such tables); out = acc ^ 0x80808080.

#include <cuda_runtime.h>
#include <stdint.h>

struct HactArgs {
  const void* x;         // n codes
  void* out;             // n codes, same dtype
  const int* thr;        // step, bisect route: (n_thr,) ascending thresholds
  const int* outs;       // step, bisect route: (n_thr + 1,) outputs
  const int* table;      // 1to1: (table_size,) outputs for codes table_min...
  long long n;
  int method;            // 0 arithmetic, 1 step, 2 1to1, 3 HardTanh
  int slope_shift, bound_int, half_int, one_int;
  int lo, hi;            // arithmetic: the code range; HardTanh: the bounds
  int n_thr;
  int thr_smem;          // 1: the step table is staged in shared memory
  int table_min, table_size;
  int vec;               // 1: x and out are 16-byte aligned
  int step_route;        // step: 0 bisect, 1 words, 2 bytes
};

constexpr int kCascadeCap = 63;   // 32 + 16 + 8 + 4 + 2 + 1 slots

// The step cascade of one (table, code dtype), built by the wrapper with
// the thresholds outside the dtype's range folded into `start` (at or
// below its minimum) or dropped (above its maximum).
struct StepCascade {
  int n;                          // thresholds in the cascade (<= kCascadeCap),
                                  // in the slots of cascade_slots(n)
  unsigned start;                 // words: the output below every threshold;
                                  // bytes: (that + 128) in every byte
  unsigned thr[kCascadeCap];      // words: the threshold; bytes: the low 7
                                  // bits of (threshold + 128) in every byte
  unsigned sign[kCascadeCap];     // bytes: 0x80808080 for a negative threshold
  unsigned delta[kCascadeCap];    // words: outputs[i+1] - outputs[i];
                                  // bytes: that << 25
};

enum { ARITH = 0, STEP = 1, LUT = 2, HTANH = 3 };
enum { ROUTE_BISECT = 0, ROUTE_WORDS = 1, ROUTE_BYTES = 2 };

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

// arithmetic, 1to1, HardTanh and the step method's bisect route.
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

// Where a cascade of n thresholds sits (kernels/hard_act.py::cascade_slots):
// up to kExactCap, in slots 0..n-1, run by a kernel instantiated for that
// n (one straight unrolled sequence); above it, in the chunks of 32, 16,
// 8, 4, 2 and 1 slots (at offsets 0, 32, 48, 56, 60, 62) whose length is a
// bit of n, each chunk unrolled at compile-time slots and entered on one
// uniform branch.  Either way the table is read as constant-bank operands.
constexpr int kExactCap = 16;

template <int OFF, int LEN, int NV>
__device__ __forceinline__ void words_chunk(int (&acc)[NV], const int (&y)[NV],
                                            const StepCascade& c) {
#pragma unroll
  for (int i = OFF; i < OFF + LEN; ++i) {
    const int t = (int)c.thr[i], d = (int)c.delta[i];
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] += y[j] >= t ? d : 0;
  }
}

// The words route on NV codes: the thresholds outside, the codes inside,
// so the codes' chains run side by side.
template <int NV>
__device__ __forceinline__ void step_words(int (&y)[NV], const StepCascade& c) {
  int acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = (int)c.start;
  if (c.n & 32) words_chunk<0, 32>(acc, y, c);
  if (c.n & 16) words_chunk<32, 16>(acc, y, c);
  if (c.n & 8) words_chunk<48, 8>(acc, y, c);
  if (c.n & 4) words_chunk<56, 4>(acc, y, c);
  if (c.n & 2) words_chunk<60, 2>(acc, y, c);
  if (c.n & 1) words_chunk<62, 1>(acc, y, c);
#pragma unroll
  for (int j = 0; j < NV; ++j) y[j] = acc[j];
}

template <typename T>
__global__ void __launch_bounds__(256) hact_step_words_kernel(
    const HactArgs a, const __grid_constant__ StepCascade c) {
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  constexpr int V = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_vec = a.vec ? a.n / V : 0;
  for (long long i = tid; i < n_vec; i += stride) {
    union { uint4 u; T e[V]; } v;
    v.u = reinterpret_cast<const uint4*>(x)[i];
    int y[V];
#pragma unroll
    for (int j = 0; j < V; ++j) y[j] = (int)v.e[j];
    step_words<V>(y, c);
#pragma unroll
    for (int j = 0; j < V; ++j) v.e[j] = (T)y[j];
    reinterpret_cast<uint4*>(out)[i] = v.u;
  }
  for (long long i = n_vec * V + tid; i < a.n; i += stride) {
    int y[1] = {(int)x[i]};
    step_words<1>(y, c);
    out[i] = (T)y[0];
  }
}

__device__ __forceinline__ unsigned maj3(unsigned a, unsigned b, unsigned c) {
  unsigned r;
  asm("lop3.b32 %0, %1, %2, %3, 0xE8;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

__device__ __forceinline__ unsigned mad_hi(unsigned a, unsigned b, unsigned c) {
  unsigned r;
  asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

template <int OFF, int LEN, int NW>
__device__ __forceinline__ void bytes_chunk(unsigned (&acc)[NW], const unsigned (&hi)[NW],
                                            const unsigned (&top)[NW],
                                            const StepCascade& c) {
#pragma unroll
  for (int i = OFF; i < OFF + LEN; ++i) {
    const unsigned t7 = c.thr[i], sign = c.sign[i], d = c.delta[i];
#pragma unroll
    for (int j = 0; j < NW; ++j)
      acc[j] = mad_hi(maj3(top[j], sign, hi[j] - t7), d, acc[j]);
  }
}

// The bytes route on NW words of four int8 codes each (the header's
// derivation); the words' chains run side by side.  N: the cascade's
// length when the kernel is instantiated for it, else -1 (chunks).
template <int N, int NW>
__device__ __forceinline__ void step_bytes(unsigned (&w)[NW], const StepCascade& c) {
  unsigned hi[NW], top[NW], acc[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    hi[j] = w[j] | 0x80808080u;          // 128 + the low 7 bits, per byte
    top[j] = ~w[j] & 0x80808080u;        // the biased code's top bit
    acc[j] = c.start;
  }
  if (N >= 0) {
    bytes_chunk<0, (N < 0 ? 0 : N)>(acc, hi, top, c);
  } else {
    if (c.n & 32) bytes_chunk<0, 32>(acc, hi, top, c);
    if (c.n & 16) bytes_chunk<32, 16>(acc, hi, top, c);
    if (c.n & 8) bytes_chunk<48, 8>(acc, hi, top, c);
    if (c.n & 4) bytes_chunk<56, 4>(acc, hi, top, c);
    if (c.n & 2) bytes_chunk<60, 2>(acc, hi, top, c);
    if (c.n & 1) bytes_chunk<62, 1>(acc, hi, top, c);
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) w[j] = acc[j] ^ 0x80808080u;
}

template <int N>
__global__ void __launch_bounds__(256) hact_step_bytes_kernel(
    const HactArgs a, const __grid_constant__ StepCascade c) {
  const uint8_t* x = static_cast<const uint8_t*>(a.x);
  uint8_t* out = static_cast<uint8_t*>(a.out);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_vec = a.vec ? a.n / 16 : 0;
  for (long long i = tid; i < n_vec; i += stride) {
    const uint4 v = reinterpret_cast<const uint4*>(x)[i];
    unsigned w[4] = {v.x, v.y, v.z, v.w};
    step_bytes<N, 4>(w, c);
    reinterpret_cast<uint4*>(out)[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (long long i = n_vec * 16 + tid; i < a.n; i += stride) {
    unsigned w[1] = {x[i]};              // the code in byte 0
    step_bytes<N, 1>(w, c);
    out[i] = (uint8_t)(w[0] & 0xFFu);
  }
}

// The bytes kernel for exactly c.n thresholds (N counts down to 0), or
// for the chunk layout above kExactCap.
template <int N>
static void launch_bytes(const HactArgs* a, const StepCascade* c, int blocks,
                         cudaStream_t s) {
  if (c->n == N) hact_step_bytes_kernel<N><<<blocks, 256, 0, s>>>(*a, *c);
  else if (N > 0) launch_bytes<(N > 0 ? N - 1 : 0)>(a, c, blocks, s);
}

template <typename T>
static int launch_typed(HactArgs* a, const StepCascade* c, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  constexpr int V = 16 / sizeof(T);
  const long long work = (a->n + V - 1) / V;
  const long long cap = 8LL * sms;                 // enough blocks to fill the card
  const int blocks = (int)(work < 1 ? 1 : ((work + 255) / 256 < cap ? (work + 255) / 256 : cap));
  const bool cascade = a->method == STEP && a->step_route != ROUTE_BISECT;
  if (cascade && (c == nullptr || c->n < 0 || c->n > kCascadeCap))
    return (int)cudaErrorInvalidValue;
  if (cascade && a->step_route == ROUTE_BYTES) {
    if (sizeof(T) != 1) return (int)cudaErrorInvalidValue;
    if (c->n <= kExactCap) launch_bytes<kExactCap>(a, c, blocks, s);
    else hact_step_bytes_kernel<-1><<<blocks, 256, 0, s>>>(*a, *c);
    return (int)cudaGetLastError();
  }
  if (cascade) {
    if (a->step_route != ROUTE_WORDS) return (int)cudaErrorInvalidValue;
    hact_step_words_kernel<T><<<blocks, 256, 0, s>>>(*a, *c);
    return (int)cudaGetLastError();
  }
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

// Launch on `stream`; elem_bytes (1, 2, 4) picks int8/int16/int32 codes;
// `cascade` is the step method's table on its words and bytes routes
// (NULL otherwise).  Returns cudaGetLastError() (0 = launched).
int hact_launch(HactArgs* a, const StepCascade* cascade, int elem_bytes,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->n <= 0) return (int)cudaErrorInvalidValue;
  a->vec = ((reinterpret_cast<uintptr_t>(a->x) | reinterpret_cast<uintptr_t>(a->out)) % 16) == 0;
  switch (elem_bytes) {
    case 1: return launch_typed<int8_t>(a, cascade, s);
    case 2: return launch_typed<int16_t>(a, cascade, s);
    case 4: return launch_typed<int32_t>(a, cascade, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int hact_args_size(void) { return (int)sizeof(HactArgs); }

int hact_cascade_size(void) { return (int)sizeof(StepCascade); }

const char* hact_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
