// Fused quantised-LSTM stack for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (kernels/qlstm_cell.py binds it, kernels/_build.py
// compiles it).
//
// Replaces the TPU kernels of src/repro/kernels/qlstm_cell.py:
//   * qlstm_stack_kernel<T, false>: qlstm_seq_multilayer_pallas (and
//     qlstm_seq_pallas, which is the same stack with one layer);
//   * qlstm_stack_kernel<T, true>:  qlstm_seq_slot_pallas.
//
// What it computes: for every step t and layer l, an int32 MAC of [x | h]
// against [W_x ; W_h] plus the bias at product precision, one
// round-half-up shift with saturation (stage S5), HardSigmoid* on i/f/o and
// HardTanh on g, then c = rq(f*c + i*g) and h = rq(o * ht(c)).  Layer l's h
// feeds layer l+1 within the same step.  Integer arithmetic wraps modulo
// 2^32 (unsigned arithmetic, reinterpreted), as XLA's int32 does; right
// shifts of signed values are arithmetic.
//
// What bounds it on this card: neither bytes nor operations.  The paper's
// model (M=1, H=20, T=6) moves a few kilobytes and does ~22 kop per
// sequence, so a launch costs microseconds of latency: the kernel launch
// itself and the T*L chain of dependent steps, each two __syncthreads
// apart.  The design keeps that chain short and off device memory:
//   * the grid runs over blocks of batch rows (the TPU's batch grid axis);
//     the T and L loops run inside the block, because nothing carries
//     between blocks on Hopper (they replace the TPU's sequential grid);
//     the ragged last block is masked, with no padding copies;
//   * every layer's weights and bias are staged once into shared memory
//     (the VMEM-resident weights of the TPU kernel) when they fit the
//     per-block budget, else read from device memory — same bits;
//   * each layer's (h, c) lives in shared memory as int32 (the VMEM
//     scratch), so no state touches device memory between steps;
//   * one thread per (row, gate column) accumulates over K = M + H, a
//     barrier, one thread per (row, unit) updates c and h, a barrier.
// compute_unit (mxu | vpu) selects nothing here: both run this CUDA-core
// int32 MAC.  An int8 tensor-core path (mma.sync s8*s8->s32 with K padded)
// is later work; int16 codes have no integer tensor-core path on Hopper.
//
// Slot variant (device-resident stream state): at t == 0 each row gathers
// its per-layer carry from table[gather[row]]; after the last step it
// scatters the final (h, c) into new_table[scatter[row]].  The wrapper
// passes new_table = table.clone(), so every gather reads the pre-wave
// table whatever order the blocks run in — the all-gathers-before-scatters
// contract of the TPU kernel, which ran the batch as one grid block.  Rows
// n_rows-2 (ZERO) and n_rows-1 (TRASH) are never written; a gather id
// outside the live rows and ZERO reads ZERO, a scatter id outside the live
// rows is dropped, so no id can address memory outside the table.

#include <cuda_runtime.h>
#include <stdint.h>

struct QlstmArgs {
  const void* x;          // (T, B, M) storage codes
  const void* w;          // per layer: W_x (in_l, 4H) then W_h (H, 4H), storage codes
  const int* bias;        // (L, 4H) int32, product precision
  const int* h0;          // (L, B, H) int32 carry in        (stack variant)
  const int* c0;
  int* h_fin;             // (L, B, H) int32 carry out       (stack variant)
  int* c_fin;
  const int* gather;      // (B,) table rows                 (slot variant)
  const int* scatter;     // (B,)
  const int* table;       // (n_rows, L, 2, H) int32
  int* new_table;         // (n_rows, L, 2, H) int32, a copy of table
  void* out;              // (T, B, H) storage codes: last layer's h
  const int* step_thr;    // (n_thr,) HardSigmoid* step thresholds
  const int* step_out;    // (n_thr + 1,) step outputs
  int T, B, M, H, L;
  int n_rows;             // table rows (slot variant)
  int rows_per_block;
  int w_smem;             // in: 1 = stage weights if they fit; out: 1 = staged
  int shift, lo, hi;      // S5: clamp((v + 2^(shift-1)) >> shift, lo, hi)
  int hs_step;            // 1: step table, 0: arithmetic HardSigmoid*
  int n_thr;
  int slope_shift, bound_int, half_int, one_int;
  int ht_lo, ht_hi;
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

__device__ __forceinline__ int requant(int v, const QlstmArgs& a) {
  int t = a.shift ? (wadd(v, 1 << (a.shift - 1)) >> a.shift) : v;
  return min(max(t, a.lo), a.hi);
}

__device__ __forceinline__ int hard_tanh(int v, const QlstmArgs& a) {
  return min(max(v, a.ht_lo), a.ht_hi);
}

__device__ __forceinline__ int hard_sigmoid(int v, const QlstmArgs& a,
                                            const int* thr, const int* outs) {
  int y;
  if (a.hs_step) {
    // The FPGA's cascaded comparators: outputs[#{thresholds <= v}].
    y = outs[0];
    for (int i = 0; i < a.n_thr; ++i) y += (v >= thr[i]) ? outs[i + 1] - outs[i] : 0;
    return y;
  }
  int lin = min(max((v >> a.slope_shift) + a.half_int, 0), a.one_int);
  y = v < -a.bound_int ? 0 : (v >= a.bound_int ? a.one_int : lin);
  return min(max(y, a.lo), a.hi);
}

__host__ __device__ inline long long packed_weights(const QlstmArgs& a) {
  long long g = 4LL * a.H;
  return (a.M + a.H) * g + (long long)(a.L - 1) * 2 * a.H * g;
}

__host__ __device__ inline long long smem_ints(const QlstmArgs& a) {
  long long g = 4LL * a.H, r = a.rows_per_block;
  return a.L * g + 2LL * a.L * r * a.H + r * g + 2LL * a.n_thr + 1;
}

template <typename T, bool SLOT>
__global__ void __launch_bounds__(256) qlstm_stack_kernel(const QlstmArgs a) {
  extern __shared__ int smem[];
  const int H = a.H, G = 4 * a.H, L = a.L, R = a.rows_per_block;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, a.B - row0);
  const int tid = threadIdx.x, nt = blockDim.x;

  int* s_b = smem;                     // (L, G)
  int* s_h = s_b + L * G;              // (L, R, H)
  int* s_c = s_h + L * R * H;          // (L, R, H)
  int* s_g = s_c + L * R * H;          // (R, G) activated gates of one layer
  int* s_thr = s_g + R * G;            // (n_thr,)
  int* s_out = s_thr + a.n_thr;        // (n_thr + 1,)
  T* s_w = reinterpret_cast<T*>(s_out + a.n_thr + 1);

  const T* gw = static_cast<const T*>(a.w);
  if (a.w_smem) {
    const long long n = packed_weights(a);
    for (long long i = tid; i < n; i += nt) s_w[i] = gw[i];
  }
  const T* W = a.w_smem ? s_w : gw;
  for (int i = tid; i < L * G; i += nt) s_b[i] = a.bias[i];
  if (a.hs_step) {
    for (int i = tid; i < a.n_thr; i += nt) s_thr[i] = a.step_thr[i];
    for (int i = tid; i <= a.n_thr; i += nt) s_out[i] = a.step_out[i];
  }
  for (int i = tid; i < L * nrows * H; i += nt) {
    const int l = i / (nrows * H), r = (i / H) % nrows, u = i % H;
    const int row = row0 + r;
    int hv, cv;
    if (SLOT) {
      int g = a.gather[row];
      if (g < 0 || g > a.n_rows - 2) g = a.n_rows - 2;   // ZERO row
      const int* src = a.table + ((long long)g * L + l) * 2 * H;
      hv = src[u];
      cv = src[H + u];
    } else {
      const long long k = ((long long)l * a.B + row) * H + u;
      hv = a.h0[k];
      cv = a.c0[k];
    }
    s_h[(l * R + r) * H + u] = hv;
    s_c[(l * R + r) * H + u] = cv;
  }
  __syncthreads();

  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  for (int t = 0; t < a.T; ++t) {
    long long woff = 0;
    for (int l = 0; l < L; ++l) {
      const int k_in = l == 0 ? a.M : H;
      const T* wx = W + woff;
      const T* wh = wx + (long long)k_in * G;
      woff += (long long)(k_in + H) * G;
      const int* h_l = s_h + l * R * H;
      const int* h_below = l > 0 ? s_h + (l - 1) * R * H : s_h;   // read for l > 0
      for (int i = tid; i < nrows * G; i += nt) {
        const int r = i / G, col = i % G;
        unsigned acc = (unsigned)s_b[l * G + col];
        if (l == 0) {
          const T* xr = x + ((long long)t * a.B + row0 + r) * a.M;
          for (int k = 0; k < a.M; ++k)
            acc += (unsigned)(int)xr[k] * (unsigned)(int)wx[(long long)k * G + col];
        } else {
          for (int k = 0; k < H; ++k)
            acc += (unsigned)h_below[r * H + k] * (unsigned)(int)wx[(long long)k * G + col];
        }
        for (int j = 0; j < H; ++j)
          acc += (unsigned)h_l[r * H + j] * (unsigned)(int)wh[(long long)j * G + col];
        const int pre = requant((int)acc, a);
        s_g[r * G + col] = (col / H == 2) ? hard_tanh(pre, a)
                                           : hard_sigmoid(pre, a, s_thr, s_out);
      }
      __syncthreads();
      for (int i = tid; i < nrows * H; i += nt) {
        const int r = i / H, u = i % H;
        const int* g = s_g + r * G;
        const int k = (l * R + r) * H + u;
        const int c_new = requant(wadd(wmul(g[H + u], s_c[k]), wmul(g[u], g[2 * H + u])), a);
        const int h_new = requant(wmul(g[3 * H + u], hard_tanh(c_new, a)), a);
        s_c[k] = c_new;
        s_h[k] = h_new;
        if (l == L - 1) out[((long long)t * a.B + row0 + r) * H + u] = (T)h_new;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < L * nrows * H; i += nt) {
    const int l = i / (nrows * H), r = (i / H) % nrows, u = i % H;
    const int row = row0 + r;
    const int k = (l * R + r) * H + u;
    if (SLOT) {
      const int s = a.scatter[row];
      if (s >= 0 && s < a.n_rows - 2) {                  // live rows only
        int* dst = a.new_table + ((long long)s * L + l) * 2 * H;
        dst[u] = s_h[k];
        dst[H + u] = s_c[k];
      }
    } else {
      const long long j = ((long long)l * a.B + row) * H + u;
      a.h_fin[j] = s_h[k];
      a.c_fin[j] = s_c[k];
    }
  }
}

template <typename T, bool SLOT>
static int launch_typed(QlstmArgs* a, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const long long base = smem_ints(*a) * (long long)sizeof(int);
  const long long with_w = base + packed_weights(*a) * (long long)sizeof(T);
  a->w_smem = (a->w_smem && with_w <= max_smem) ? 1 : 0;
  const long long bytes = a->w_smem ? with_w : base;
  if (bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(qlstm_stack_kernel<T, SLOT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (a->B + a->rows_per_block - 1) / a->rows_per_block;
  int threads = ((a->rows_per_block * 4 * a->H + 31) / 32) * 32;
  threads = threads > 256 ? 256 : threads;
  qlstm_stack_kernel<T, SLOT><<<blocks, threads, (size_t)bytes, stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" {

// Launch on `stream`; elem_bytes (1, 2, 4) picks int8/int16/int32 codes and
// slot selects the slot variant.  Writes the shared-memory decision back to
// a->w_smem.  Returns cudaGetLastError() (0 = launched).
int qlstm_launch(QlstmArgs* a, int elem_bytes, int slot, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes * 2 + (slot ? 1 : 0)) {
    case 2: return launch_typed<int8_t, false>(a, s);
    case 3: return launch_typed<int8_t, true>(a, s);
    case 4: return launch_typed<int16_t, false>(a, s);
    case 5: return launch_typed<int16_t, true>(a, s);
    case 8: return launch_typed<int32_t, false>(a, s);
    case 9: return launch_typed<int32_t, true>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int qlstm_args_size(void) { return (int)sizeof(QlstmArgs); }

const char* qlstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
