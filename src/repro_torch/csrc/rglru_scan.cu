// The RG-LRU's linear recurrence for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (kernels/rglru_scan.py binds it,
// kernels/_build.py compiles it).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::rglru_seq_pallas.
//
// What it computes: h_t = exp(log_a_t) * h_{t-1} + b_t with h_{-1} = 0,
// over (T, B, W) tensors, every load widened to fp32, h carried in fp32,
// every h_t stored in b's dtype (f32 or bf16; log_a f32 or bf16 on its
// own).  expf is the accurate one (no fast math), and the multiply and
// the add are rounded one at a time (__fmul_rn / __fadd_rn, which the
// compiler never contracts into an FMA), as torch's separate mul and add
// are: over a long chain an FMA's single rounding drifts from the plain
// version by more than 1e-6 wherever h passes near zero.
//
// What bounds it on this card: bytes.  Each element costs one exp, one
// multiply and one add against 4 + 4 + 4 bytes moved (f32), far below the card's
// operations-per-byte line; at RecurrentGemma-2B's prefill (T = 4096,
// B = 2, W = 2560, f32) that is 251.7 MB, 0.0751 ms at 3.35 TB/s.  What
// holds it back in practice is the serial chain over T: there are only
// B * W independent channels (5,120 at that shape) for 132 SMs.  Design:
//   * one thread per (b, w) channel, w fastest across the threads of a
//     warp so that every load and store of a step is one coalesced
//     transaction; a loop over T with h in a register;
//   * the loads of the next DEPTH steps are issued before the current
//     DEPTH steps' exp/multiply/add chain runs (register double buffer), so each
//     thread keeps up to 2 * DEPTH loads in flight instead of one;
//   * the three tensors come with element strides for t and b (w's is 1),
//     so the model's (B, T, W) tensors go in as transposed views without a
//     copy and the result is written straight into a (B, T, W) tensor.
// A chunked two-pass scan over T would give the card more parallel work;
// that is left to a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

struct RglruArgs {
  const void* log_a;  // (T, B, W), element strides a_st, a_sb, 1
  const void* b;      // (T, B, W), element strides b_st, b_sb, 1
  void* h;            // (T, B, W), element strides h_st, h_sb, 1; b's dtype
  long long T, B, W;
  long long a_st, a_sb, b_st, b_sb, h_st, h_sb;
};

constexpr int THREADS = 32;   // channels per block: one warp
constexpr int DEPTH = 16;     // steps per register buffer

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename TA, typename TB>
__device__ __forceinline__ void load_steps(const TA* __restrict__ la,
                                           const TB* __restrict__ bb,
                                           const RglruArgs& a, long long t0,
                                           float (&xa)[DEPTH], float (&xb)[DEPTH]) {
#pragma unroll
  for (int i = 0; i < DEPTH; ++i) {
    if (t0 + i < a.T) {
      xa[i] = to_f32(la[(t0 + i) * a.a_st]);
      xb[i] = to_f32(bb[(t0 + i) * a.b_st]);
    }
  }
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(THREADS) rglru_seq_kernel(const RglruArgs a) {
  const long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (c >= a.B * a.W) return;
  const long long bi = c / a.W, w = c - bi * a.W;
  const TA* __restrict__ la = static_cast<const TA*>(a.log_a) + bi * a.a_sb + w;
  const TB* __restrict__ bb = static_cast<const TB*>(a.b) + bi * a.b_sb + w;
  TB* __restrict__ hh = static_cast<TB*>(a.h) + bi * a.h_sb + w;

  float ca[DEPTH] = {}, cb[DEPTH] = {}, na[DEPTH] = {}, nb[DEPTH] = {};
  load_steps(la, bb, a, 0, ca, cb);
  float h = 0.f;
  for (long long t0 = 0; t0 < a.T; t0 += DEPTH) {
    load_steps(la, bb, a, t0 + DEPTH, na, nb);     // in flight during the chain
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) {
      if (t0 + i < a.T) {
        h = __fadd_rn(__fmul_rn(expf(ca[i]), h), cb[i]);
        hh[(t0 + i) * a.h_st] = from_f32<TB>(h);
      }
    }
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) {
      ca[i] = na[i];
      cb[i] = nb[i];
    }
  }
}

template <typename TA, typename TB>
static int launch_typed(const RglruArgs& a, cudaStream_t s) {
  const long long n = a.B * a.W;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  rglru_seq_kernel<TA, TB><<<blocks, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" {

// Launch on `stream`; a_bf16 / b_bf16 = 1 take bf16 log_a / b (and h in
// b's dtype), else f32.  Returns cudaGetLastError() (0 = launched).
int rglru_launch(RglruArgs* a, int a_bf16, int b_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->T <= 0 || a->B <= 0 || a->W <= 0 ||
      (a->B * a->W + THREADS - 1) / THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (a_bf16)
    return b_bf16 ? launch_typed<__nv_bfloat16, __nv_bfloat16>(*a, s)
                  : launch_typed<__nv_bfloat16, float>(*a, s);
  return b_bf16 ? launch_typed<float, __nv_bfloat16>(*a, s)
                : launch_typed<float, float>(*a, s);
}

int rglru_args_size(void) { return (int)sizeof(RglruArgs); }

const char* rglru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
