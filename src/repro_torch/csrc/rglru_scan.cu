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
// version by more than 1e-6 wherever h passes near zero.  Both routes
// below run each channel's chain in the same order with the same three
// roundings, so they give the same bits.
//
// What bounds it on this card: bytes.  Each element costs one exp, one
// multiply and one add against 4 + 4 + 4 bytes moved (f32), far below the
// card's operations-per-byte line; at RecurrentGemma-2B's prefill (T =
// 4096, B = 2, W = 2560, f32) that is 251.7 MB, 0.0751 ms at 3.35 TB/s.
// The chain over T is serial, but short: two dependent operations a step
// (~8 cycles), ~19 us over 4,096 steps.  What held the first design (one
// thread per channel, a 16-step register double buffer; now the lane
// route) at 6.6x the bound was memory-level parallelism: 160 one-warp
// blocks with 32 loads of 4 bytes in flight each, ~0.65 MB across the
// card, where 3.35 TB/s at ~0.8 us of latency needs ~2.7 MB.
//
// Tile route (rglru_tile_kernel), the design for that bound:
//   * a block owns TILE_C = 32 channels (contiguous in w, within one b row)
//     and walks T in chunks of TILE_T = 64 steps; 32 channels are one
//     chain warp with a lane per channel and 128-byte rows (f32).  At
//     (2, 2560) that is 160 blocks; two fit an SM (98 KB of shared memory
//     each), so all are resident at once and there is no second wave.
//     40 channels would give 128 blocks, but do not map onto one warp;
//   * log_a and b arrive as (TILE_T x 32) tiles in a ring of STAGES = 4
//     stages in shared memory, each tile one TMA copy (`cp.async.bulk.tensor`
//     over a 3-D tensor map of the strided operand, its dimensions (W, T,
//     B) or (W, B, T) in the order its strides grow, made on the host
//     through cudaGetDriverEntryPoint, so the build needs no -lcuda)
//     issued by one producer thread and completing on the stage's `full`
//     mbarrier (complete_tx): up to 48 KB in flight per block (f32).  One
//     1-D bulk copy per 128-byte row instead ran at 0.236 ms on an H100:
//     small copies cost the copy engine more than the bytes;
//   * EXP_WARPS helper warps turn each arrived log_a tile into expf(log_a)
//     (the same expf, so the same bits), in parallel over the tile, and
//     arrive on `ready`; exp is ~25 instructions an element and would
//     otherwise fill the chain warp's issue slots;
//   * the chain warp runs h = __fadd_rn(__fmul_rn(a, h), b) out of shared
//     memory, writes each h over its b in the stage, and one lane stores
//     the tile with one TMA copy (`cp.async.bulk.tensor` to a map of h);
//     once that copy has read the tile, the lane arrives on `empty` to
//     hand the stage back to the producer.  Storing h a row a step from
//     the chain warp instead ran at 0.105 ms against 0.093 on an H100;
//   * it takes the tensors' t and b strides (w's is 1), so the model's
//     (B, T, W) tensors go in as transposed views without a copy.
// A tensor map needs a 16-byte aligned base and strides that are positive
// multiples of 16 bytes, so this route takes log_a, b and h only when each
// has those (kernels/rglru_scan.py::tile_route_fits; rglru_launch refuses
// anything else).  The ragged last channel tile and the last chunk of T
// are the copies' out-of-bounds part: zero-filled on the way in, dropped
// on the way out.
//
// Lane route (rglru_lane_kernel), for the shapes the tile route cannot
// take (e.g. W = 70 in f32): the first design, one thread per channel, w
// fastest across a warp so every load and store of a step is coalesced,
// the loads of the next DEPTH steps in flight while the current DEPTH
// steps run.
//
// A chunked scan that reassociates the chain over T would give the card
// more parallel work, but not these bits: it is not done here.

#include <cuda.h>            // CUtensorMap and its enums; the encoder is looked up at run time
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// ---------------------------------------------------------------------------
// Tile route
// ---------------------------------------------------------------------------

constexpr int TILE_C = 32;      // channels per block: one chain warp
constexpr int TILE_T = 64;      // steps per chunk
constexpr int STAGES = 4;       // chunks in the shared-memory ring
constexpr int EXP_WARPS = 4;    // helper warps computing expf(log_a)
constexpr int TILE_THREADS = 32 * (2 + EXP_WARPS);   // + producer + chain

template <typename TA, typename TB>
struct TileLayout {             // one stage: exp(log_a) f32 | log_a | b
  static constexpr int E_BYTES = TILE_T * TILE_C * 4;
  static constexpr int A_BYTES = TILE_T * TILE_C * (int)sizeof(TA);
  static constexpr int B_BYTES = TILE_T * TILE_C * (int)sizeof(TB);
  static constexpr int STAGE = E_BYTES + A_BYTES + B_BYTES;
  static constexpr int BARS = STAGES * STAGE;          // 3 mbarriers a stage
  static constexpr int SMEM = BARS + 3 * STAGES * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One box of `map` at coordinates (c0, c1, c2) into shared memory,
// reported to `bar`; elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// A map's dimensions are (W, T, B) when t_first, else (W, B, T): the order
// in which its operand's strides grow (the model's (T, B, W) views of
// (B, T, W) tensors are t_first).  A box is 32 channels by 64 steps by one
// b either way, landing as 64 rows of 32.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, bool t_first,
                                         int w, int b, int t, uint64_t* bar) {
  if (t_first) tma_load(dst, map, w, t, b, bar);
  else tma_load(dst, map, w, b, t, bar);
}

// The box at (c0, c1, c2) of `map` from shared memory, one bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void tma_tile_store(const CUtensorMap* map, const void* src,
                                               bool t_first, int w, int b, int t) {
  if (t_first) tma_store(map, src, w, t, b);
  else tma_store(map, src, w, b, t);
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(TILE_THREADS)
    rglru_tile_kernel(const RglruArgs a, const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const __grid_constant__ CUtensorMap map_h, const int t_first_a,
                      const int t_first_b, const int t_first_h) {
  using Lay = TileLayout<TA, TB>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::BARS);  // tiles landed
  uint64_t* ready = full + STAGES;                                  // exp done
  uint64_t* empty = ready + STAGES;                                 // stage consumed

  const long long tiles_w = (a.W + TILE_C - 1) / TILE_C;
  const long long bi = blockIdx.x / tiles_w;
  const long long w0 = (blockIdx.x % tiles_w) * TILE_C;
  const int nch = (int)min((long long)TILE_C, a.W - w0);
  const long long chunks = (a.T + TILE_T - 1) / TILE_T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], 32 * EXP_WARPS);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {                                   // producer: one thread
    if (lane != 0) return;
    for (long long c = 0; c < chunks; ++c) {
      const int s = (int)(c % STAGES);
      const uint32_t parity = (uint32_t)(c / STAGES) & 1;
      mbar_wait(&empty[s], parity ^ 1);              // round 0 passes at once
      unsigned char* st = smem + s * Lay::STAGE;
      mbar_arrive_expect_tx(&full[s], Lay::A_BYTES + Lay::B_BYTES);
      tma_tile(st + Lay::E_BYTES, &map_a, t_first_a, (int)w0, (int)bi, (int)(c * TILE_T),
               &full[s]);
      tma_tile(st + Lay::E_BYTES + Lay::A_BYTES, &map_b, t_first_b, (int)w0, (int)bi,
               (int)(c * TILE_T), &full[s]);
    }
  } else if (warp == 1) {                            // chain
    float h = 0.f;
    for (long long c = 0; c < chunks; ++c) {
      const int s = (int)(c % STAGES);
      const uint32_t parity = (uint32_t)(c / STAGES) & 1;
      mbar_wait(&full[s], parity);
      mbar_wait(&ready[s], parity);
      const int rows = (int)min((long long)TILE_T, a.T - c * TILE_T);
      unsigned char* st = smem + s * Lay::STAGE;
      const float* ea = reinterpret_cast<const float*>(st) + lane;
      TB* bs = reinterpret_cast<TB*>(st + Lay::E_BYTES + Lay::A_BYTES) + lane;
      if (rows == TILE_T) {
#pragma unroll 16
        for (int i = 0; i < TILE_T; ++i) {
          h = step(ea[i * TILE_C], h, to_f32(bs[i * TILE_C]));
          bs[i * TILE_C] = from_f32<TB>(h);            // h over b, in place
        }
      } else {
        for (int i = 0; i < rows; ++i) {
          h = step(ea[i * TILE_C], h, to_f32(bs[i * TILE_C]));
          bs[i * TILE_C] = from_f32<TB>(h);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        tma_tile_store(&map_h, st + Lay::E_BYTES + Lay::A_BYTES, t_first_h, (int)w0, (int)bi,
                       (int)(c * TILE_T));
        if (c > 0) {                                 // the previous chunk's h is read out
          asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
          mbar_arrive(&empty[(c - 1) % STAGES]);
        }
      }
    }
    if (lane == 0) {
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    }
  } else {                                           // expf(log_a) helpers
    const int ht = threadIdx.x - 64;
    for (long long c = 0; c < chunks; ++c) {
      const int s = (int)(c % STAGES);
      const uint32_t parity = (uint32_t)(c / STAGES) & 1;
      mbar_wait(&full[s], parity);
      const int n = (int)min((long long)TILE_T, a.T - c * TILE_T) * TILE_C;
      unsigned char* st = smem + s * Lay::STAGE;
      float* ea = reinterpret_cast<float*>(st);
      const TA* as = reinterpret_cast<const TA*>(st + Lay::E_BYTES);
      for (int i = ht; i < n; i += 32 * EXP_WARPS) ea[i] = expf(to_f32(as[i]));
      mbar_arrive(&ready[s]);
    }
  }
}

// ---------------------------------------------------------------------------
// Lane route
// ---------------------------------------------------------------------------

constexpr int LANE_THREADS = 32;   // channels per block: one warp
constexpr int DEPTH = 16;          // steps per register buffer

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
__global__ void __launch_bounds__(LANE_THREADS) rglru_lane_kernel(const RglruArgs a) {
  const long long c = (long long)blockIdx.x * LANE_THREADS + threadIdx.x;
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
        h = step(expf(ca[i]), h, cb[i]);
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

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
    CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once; null if it is missing.
static TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncodeTiled>(p);
  }
  return fn;
}

// A tensor map over one strided operand, dimensions (W, T, B) when t_first
// else (W, B, T), boxes of 32 channels x 64 steps x one b; false where the
// operand breaks the map's alignment rules.
template <typename E>
static bool tile_map(CUtensorMap* map, const void* p, const RglruArgs& a, long long st,
                     long long sb, bool t_first) {
  const long long es = sizeof(E);
  if (reinterpret_cast<uintptr_t>(p) % 16 || st <= 0 || sb <= 0 || (st * es) % 16 ||
      (sb * es) % 16)
    return false;
  TensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t W = a.W, B = a.B, T = a.T;
  const cuuint64_t dims[3] = {W, t_first ? T : B, t_first ? B : T};
  const cuuint64_t strides[2] = {(cuuint64_t)((t_first ? st : sb) * es),
                                 (cuuint64_t)((t_first ? sb : st) * es)};
  const cuuint32_t box[3] = {TILE_C, t_first ? TILE_T : 1u, t_first ? 1u : TILE_T};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TA, typename TB>
static int launch_typed(const RglruArgs& a, int route, cudaStream_t s) {
  if (route == 1) {
    const long long blocks = (a.B * a.W + LANE_THREADS - 1) / LANE_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    rglru_lane_kernel<TA, TB><<<(unsigned)blocks, LANE_THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  CUtensorMap map_a, map_b, map_h;
  const bool ta = a.a_st <= a.a_sb, tb = a.b_st <= a.b_sb, th = a.h_st <= a.h_sb;
  if (!tile_map<TA>(&map_a, a.log_a, a, a.a_st, a.a_sb, ta) ||
      !tile_map<TB>(&map_b, a.b, a, a.b_st, a.b_sb, tb) ||
      !tile_map<TB>(&map_h, a.h, a, a.h_st, a.h_sb, th))
    return (int)cudaErrorMisalignedAddress;
  const long long blocks = a.B * ((a.W + TILE_C - 1) / TILE_C);
  if (blocks > 0x7fffffffLL || a.T > 0x7fffffffLL || a.W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int smem = TileLayout<TA, TB>::SMEM;
  static bool sized = false;       // the attribute is set once per instantiation
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        rglru_tile_kernel<TA, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  rglru_tile_kernel<TA, TB><<<(unsigned)blocks, TILE_THREADS, smem, s>>>(a, map_a, map_b,
                                                                          map_h, ta, tb, th);
  return (int)cudaGetLastError();
}

extern "C" {

// Launch on `stream`; a_bf16 / b_bf16 = 1 take bf16 log_a / b (and h in
// b's dtype), else f32; route 0 is the tile route, 1 the lane route.
// Returns cudaGetLastError() (0 = launched), cudaErrorMisalignedAddress
// when the tile route is asked for operands its tensor maps cannot take.
int rglru_launch(RglruArgs* a, int a_bf16, int b_bf16, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->T <= 0 || a->B <= 0 || a->W <= 0 || (route != 0 && route != 1))
    return (int)cudaErrorInvalidValue;
  if (a_bf16)
    return b_bf16 ? launch_typed<__nv_bfloat16, __nv_bfloat16>(*a, route, s)
                  : launch_typed<__nv_bfloat16, float>(*a, route, s);
  return b_bf16 ? launch_typed<float, __nv_bfloat16>(*a, route, s)
                : launch_typed<float, float>(*a, route, s);
}

int rglru_args_size(void) { return (int)sizeof(RglruArgs); }

const char* rglru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
