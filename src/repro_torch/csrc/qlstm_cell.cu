// Fused quantised-LSTM stack for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (kernels/qlstm_cell.py binds it, kernels/_build.py
// compiles it).
//
// Replaces the TPU kernels of src/repro/kernels/qlstm_cell.py:
//   * qlstm_rows_kernel<T, false>: qlstm_seq_multilayer_pallas (and
//     qlstm_seq_pallas, which is the same stack with one layer);
//   * qlstm_rows_kernel<T, true>:  qlstm_seq_slot_pallas.
//
// What it computes: for every step t and layer l, an int32 MAC of [x | h]
// against [W_x ; W_h] plus the bias at product precision, one
// round-half-up shift with saturation (stage S5), HardSigmoid* on i/f/o and
// HardTanh on g, then c = rq(f*c + i*g) and h = rq(o * ht(c)).  Layer l's h
// feeds layer l+1 within the same step.  Integer arithmetic wraps modulo
// 2^32 (unsigned arithmetic, reinterpreted), as XLA's int32 does; right
// shifts of signed values are arithmetic.
//
// What bounds it on this card: neither bytes nor operations but latency.
// The paper's model (M=1, H=20, L=1, T=6) moves a few kilobytes and does
// ~22 kop per sequence, so a launch costs the device-memory round trips
// it waits for and the T*L chain of dependent steps.  The first design (one
// thread per (row, gate column), the operands staged one loop after another
// with one byte a load, x read from device memory inside the chain, two
// block barriers a step) waited for ~15 round trips: 0.0147 ms for the
// serving wave's 64 rows.  This design keeps the chain to one round trip
// and short steps:
//   * prologue: the packed weights, the bias and the HardSigmoid* step
//     table go to shared memory by 16-byte cp.async, this block's x codes
//     for all T steps and its carry by plain loads (the slot variant loads
//     its gather id and the row behind it back to back), all issued before
//     one wait and one block barrier; no device-memory read stays inside
//     the T x L loop.  Weights that do not fit the shared-memory budget
//     (or weights_in_smem = 0), and x codes that do not fit after them, are
//     read from device memory instead — same bits;
//   * chain: a row is a group of whole warps, a quad of lanes per unit
//     (4H lanes, at most 256; wider rows take further passes): lane q
//     computes gate column (q % 4) * H + q / 4, its MAC over K = in_l + H,
//     the requant and HardSigmoid*/HardTanh; the quad's four gates meet by
//     __shfl_sync in the lane of gate 0, which updates c and writes h into
//     the other half of a double-buffered h that the whole group reads
//     next.  So a step and layer costs one barrier of the row's warps: a
//     named barrier (bar.sync 1 + row, group size), or __syncwarp when the
//     group is one warp (H <= 8); rows never wait for each other;
//   * the grid runs over blocks of rows_per_block rows (the TPU's batch
//     grid axis; 1 to 8 rows by default, spreading the batch over the SMs),
//     the T and L loops inside the block, because nothing carries between
//     blocks on Hopper; the ragged last block's idle rows leave after the
//     prologue.
// What is left is the chain itself: at the serving wave's 64 rows a row's
// three warps are all an SM runs, so each step costs the issue of one
// lane's dependent instructions, ~2,000 cycles (~1 us) on an H100, with
// the launch and prologue ~3 us.  One lane per unit doing all four gates
// (84 MACs a step at the paper's shape) cost ~1.3-1.9 us a step; weights
// turned per column, 16-byte vector loads, chunked loops with no bound
// test and 256-thread blocks each left the step within 10% of this one
// on an H100 (PERF.md has the readings), so the simplest of them is kept.
// No tensor cores: at a row or two per block and K = 21, an mma.sync
// m16n8k32 int8 tile would be >= 94% padding, and int16/int32 codes have
// no integer tensor-core path on Hopper.  compute_unit (mxu | vpu) selects
// nothing here: both run this CUDA-core int32 MAC.
//
// Slot variant (device-resident stream state): in the prologue each row
// gathers its per-layer carry from table[gather[row]]; after the last step
// it scatters the final (h, c) into new_table[scatter[row]].  The wrapper
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
  const int* step_thr;    // (n_thr,) HardSigmoid* step thresholds, ascending
  const int* step_out;    // (n_thr + 1,) step outputs
  int T, B, M, H, L;
  int n_rows;             // table rows (slot variant)
  int rows_per_block;     // 1..max_rows(H)
  int w_smem;             // in: 1 = stage weights if they fit; out: 1 = staged
  int x_smem;             // out: 1 = x codes staged in shared memory
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

__device__ __forceinline__ int hs_arith(int v, const QlstmArgs& a) {
  int lin = min(max((v >> a.slope_shift) + a.half_int, 0), a.one_int);
  int y = v < -a.bound_int ? 0 : (v >= a.bound_int ? a.one_int : lin);
  return min(max(y, a.lo), a.hi);
}

// HardSigmoid*: the step form is the FPGA's cascaded comparators,
// outputs[0] + the output steps whose threshold v reaches.
__device__ __forceinline__ int hard_sigmoid(int v, const QlstmArgs& a, const int* thr,
                                            const int* outs) {
  if (!a.hs_step) return hs_arith(v, a);
  int y = outs[0];
  for (int i = 0; i < a.n_thr; ++i) y += (v >= thr[i]) ? outs[i + 1] - outs[i] : 0;
  return y;
}

__host__ __device__ inline long long packed_weights(const QlstmArgs& a) {
  long long g = 4LL * a.H;
  return (a.M + a.H) * g + (long long)(a.L - 1) * 2 * a.H * g;
}

// Threads a row's group takes: a quad per unit, whole warps, at most 256
// (units beyond 64 take further passes of the same threads).
__host__ __device__ inline int group_threads(int H) {
  const int q = 4 * H < 256 ? 4 * H : 256;
  return 32 * ((q + 31) / 32);
}

__host__ __device__ inline long long round16(long long n) { return (n + 15) / 16 * 16; }

// Bytes of the int32 part of shared memory: bias, step table, the double-
// buffered h and c; the weights and the x codes follow it.
__host__ __device__ inline long long smem_int_bytes(const QlstmArgs& a) {
  const long long g = 4LL * a.H, r = a.rows_per_block;
  return round16(4 * (a.L * g + 2LL * a.n_thr + 1 + 3LL * a.L * r * a.H));
}

// nbytes from device memory into shared memory by 16-byte cp.async where
// both ends are aligned, the rest by plain loads; waited for by the caller.
__device__ __forceinline__ void stage(void* dst, const void* src, long long nbytes,
                                      int tid, int nt) {
  unsigned char* d = static_cast<unsigned char*>(dst);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(s)) & 15) == 0) {
    done = nbytes / 16 * 16;
    for (long long i = 16LL * tid; i < done; i += 16LL * nt) {
      const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(d + i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(sa), "l"(s + i)
                   : "memory");
    }
  }
  for (long long i = done + tid; i < nbytes; i += nt) d[i] = s[i];
}

__device__ __forceinline__ void group_sync(int r, int gw) {
  if (gw == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(r + 1), "r"(gw) : "memory");
  }
}

template <typename T, bool SLOT>
__global__ void __launch_bounds__(1024) qlstm_rows_kernel(const QlstmArgs a) {
  extern __shared__ __align__(16) int smem[];
  const int H = a.H, G = 4 * a.H, L = a.L, R = a.rows_per_block, M = a.M;
  const int gw = group_threads(H);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int r = tid / gw, q = tid % gw;          // row in the block, thread in its group
  const int gate = q & 3;                        // i, f, g, o: a quad of lanes per unit
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, a.B - row0);
  const int row = row0 + r;

  int* s_b = smem;                     // (L, G)
  int* s_thr = s_b + L * G;            // (n_thr,)
  int* s_out = s_thr + a.n_thr;        // (n_thr + 1,)
  int* s_h = s_out + a.n_thr + 1;      // (2, L, R, H): h_{t-1} | h_t
  int* s_c = s_h + 2 * L * R * H;      // (L, R, H)
  unsigned char* tail = reinterpret_cast<unsigned char*>(smem) + smem_int_bytes(a);
  const long long w_bytes = packed_weights(a) * (long long)sizeof(T);
  T* s_w = reinterpret_cast<T*>(tail);
  T* s_x = reinterpret_cast<T*>(tail + (a.w_smem ? round16(w_bytes) : 0));

  // -- prologue: every load issued, then one wait and one barrier ----------
  stage(s_b, a.bias, 4LL * L * G, tid, nt);
  if (a.hs_step) {
    stage(s_thr, a.step_thr, 4LL * a.n_thr, tid, nt);
    stage(s_out, a.step_out, 4LL * (a.n_thr + 1), tid, nt);
  }
  if (a.w_smem) stage(s_w, a.w, w_bytes, tid, nt);
  const T* x = static_cast<const T*>(a.x);
  if (a.x_smem) {                      // (T, R, M): this block's rows only
    const int per_t = nrows * M;
    for (int i = tid; i < a.T * per_t; i += nt) {
      const int t = i / per_t, k = i - t * per_t;
      s_x[t * R * M + k] = x[((long long)t * a.B + row0) * M + k];
    }
  }
  int scatter_id = 0;
  if (r < nrows) {
    const int* src_h;                  // layer 0's carry; layer l's at + l * l_off
    const int* src_c;
    long long l_off;
    if (SLOT) {
      int g = a.gather[row];
      if (g < 0 || g > a.n_rows - 2) g = a.n_rows - 2;   // ZERO row
      src_h = a.table + (long long)g * L * 2 * H;
      src_c = src_h + H;
      l_off = 2LL * H;
      scatter_id = a.scatter[row];
    } else {
      src_h = a.h0 + (long long)row * H;
      src_c = a.c0 + (long long)row * H;
      l_off = (long long)a.B * H;
    }
    for (int i = q; i < L * H; i += gw) {
      const int l = i / H, u = i - l * H;
      s_h[(l * R + r) * H + u] = src_h[l * l_off + u];
      s_c[(l * R + r) * H + u] = src_c[l * l_off + u];
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  if (r >= nrows) return;              // an idle row group of the last block

  // -- chain: one group barrier a step and layer -----------------------------
  // Thread q computes gate column gate * H + u of unit u = q / 4 (+ gw / 4
  // per pass when 4H > gw): its MAC over K, requant and activation; the
  // quad's four gates meet by shuffle in the lane of gate 0, which updates
  // c and h.
  const T* W = a.w_smem ? s_w : static_cast<const T*>(a.w);
  const T* xr = a.x_smem ? s_x + r * M : x + (long long)row * M;
  const long long x_t = a.x_smem ? (long long)R * M : (long long)a.B * M;
  T* out = static_cast<T*>(a.out);
  const int quad = (threadIdx.x & 31) & ~3;
  int p = 0;                           // s_h half holding h_{t-1}
  for (int t = 0; t < a.T; ++t) {
    long long woff = 0;
    for (int l = 0; l < L; ++l) {
      const int k_in = l == 0 ? M : H;
      const int* hin = l == 0 ? nullptr : s_h + (((p ^ 1) * L + l - 1) * R + r) * H;
      const int* hprev = s_h + ((p * L + l) * R + r) * H;
      for (int u0 = 0; u0 < H; u0 += gw / 4) {   // the same trip count for the group
        const int u = u0 + q / 4;
        const bool live = u < H;
        const int col = gate * H + u;
        int act = 0;
        if (live) {
          const T* wx = W + woff + col;
          const T* wh = wx + (long long)k_in * G;
          unsigned acc = (unsigned)s_b[l * G + col];
          if (l == 0) {
            const T* xt = xr + t * x_t;
            for (int k = 0; k < M; ++k)
              acc += (unsigned)(int)xt[k] * (unsigned)(int)wx[(long long)k * G];
          } else {
            for (int k = 0; k < H; ++k)
              acc += (unsigned)hin[k] * (unsigned)(int)wx[(long long)k * G];
          }
          for (int j = 0; j < H; ++j)
            acc += (unsigned)hprev[j] * (unsigned)(int)wh[(long long)j * G];
          const int pre = requant((int)acc, a);
          act = gate == 2 ? hard_tanh(pre, a) : hard_sigmoid(pre, a, s_thr, s_out);
        }
        const int gi = __shfl_sync(0xffffffffu, act, quad);
        const int gf = __shfl_sync(0xffffffffu, act, quad + 1);
        const int gg = __shfl_sync(0xffffffffu, act, quad + 2);
        const int go = __shfl_sync(0xffffffffu, act, quad + 3);
        if (live && gate == 0) {
          const int k = (l * R + r) * H + u;
          const int c_new = requant(wadd(wmul(gf, s_c[k]), wmul(gi, gg)), a);
          const int h_new = requant(wmul(go, hard_tanh(c_new, a)), a);
          s_c[k] = c_new;
          s_h[(((p ^ 1) * L + l) * R + r) * H + u] = h_new;
          if (l == L - 1) out[((long long)t * a.B + row) * H + u] = (T)h_new;
        }
      }
      woff += (long long)(k_in + H) * G;
      group_sync(r, gw);
    }
    p ^= 1;
  }

  for (int i = q; i < L * H; i += gw) {
    const int l = i / H, u = i - l * H;
    const int hv = s_h[((p * L + l) * R + r) * H + u];
    const int cv = s_c[(l * R + r) * H + u];
    if (SLOT) {
      if (scatter_id >= 0 && scatter_id < a.n_rows - 2) {   // live rows only
        int* dst = a.new_table + ((long long)scatter_id * L + l) * 2 * H;
        dst[u] = hv;
        dst[H + u] = cv;
      }
    } else {
      const long long j = ((long long)l * a.B + row) * H + u;
      a.h_fin[j] = hv;
      a.c_fin[j] = cv;
    }
  }
}

// Rows a block can hold: one group of group_threads(H) a row, at most 1,024
// threads, and at most 15 groups when a group needs a named barrier (ids
// 1..15; 0 is __syncthreads').  kernels/qlstm_cell.py::max_rows_per_block
// is the same rule.
static int max_rows(int H) {
  const int gw = group_threads(H);
  if (gw == 32) return 32;
  return 1024 / gw < 15 ? 1024 / gw : 15;
}

template <typename T, bool SLOT>
static int launch_typed(QlstmArgs* a, cudaStream_t stream) {
  if (a->H <= 0 || a->L <= 0 || a->B <= 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (a->rows_per_block < 1 || a->rows_per_block > max_rows(a->H))
    return (int)cudaErrorInvalidValue;
  const long long base = smem_int_bytes(*a);
  const long long w_bytes = round16(packed_weights(*a) * (long long)sizeof(T));
  const long long x_bytes = (long long)a->T * a->rows_per_block * a->M * sizeof(T);
  if (base > max_smem) return (int)cudaErrorInvalidValue;
  a->w_smem = (a->w_smem && base + w_bytes <= max_smem) ? 1 : 0;
  const long long with_w = base + (a->w_smem ? w_bytes : 0);
  a->x_smem = with_w + x_bytes <= max_smem ? 1 : 0;
  const long long bytes = with_w + (a->x_smem ? x_bytes : 0);
  if (bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(qlstm_rows_kernel<T, SLOT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (a->B + a->rows_per_block - 1) / a->rows_per_block;
  const int threads = a->rows_per_block * group_threads(a->H);
  qlstm_rows_kernel<T, SLOT><<<blocks, threads, (size_t)bytes, stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" {

// Launch on `stream`; elem_bytes (1, 2, 4) picks int8/int16/int32 codes and
// slot selects the slot variant.  Writes the shared-memory decisions back
// to a->w_smem and a->x_smem.  Returns cudaGetLastError() (0 = launched).
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
