// Row-gather and row-scatter probes for Hopper (sm_90a). Gather: out[i, :] =
// table[idx[i], :]; scatter-add: out[T, F] = 0, out[idx[i], :] += g[i, :].
// Each is computed by three mechanisms. The mechanism is what a probe
// measures, so they are separate kernels; the results are the same function.
//
// Replaces the TPU probes with which the JAX package chose the layout of its
// hash tables and the form of their backward:
//   gather_rows_coalesced <- benchmarks/pallas_gather_microbench.py make_vmem_gather (P1)
//   gather_rows_onehot    <- benchmarks/pallas_gather_microbench.py make_onehot_gather (P2)
//   gather_rows_serial    <- benchmarks/pallas_gather_microbench2.py make_scalar_gather (P5)
//   scatter_rows_onehot   <- benchmarks/pallas_gather_microbench.py make_onehot_scatter (P3)
//   scatter_rows_blocked  <- benchmarks/pallas_gather_microbench.py make_vmem_scatter_probe (P4)
//   scatter_rows_serial   <- benchmarks/pallas_gather_microbench2.py make_scalar_scatter (P6)
// Plain PyTorch versions: gather_rows_plain (table[idx]) and
// scatter_rows_plain (index_add_ in fp32) in
// neurad_tpu_torch/benchmarks/gather_microbench.py.
//
// What the TPU probes become here. They hold the whole table (or the whole
// accumulator) in fast on-chip memory; a thread block has 227 KB of shared
// memory and the smallest probed table (16384 x 8 bf16 = 256 KB) already
// exceeds it, so on this card the 50 MB L2 plays that part and tables and
// accumulators live in device memory behind it.
//  * P1 (a block of queries at once): neighbouring lanes read neighbouring
//    16-byte pieces of a row through the read-only path (4 lanes for a 64-byte
//    row) and write them to neighbouring addresses: loads use every byte of the
//    sectors they touch and stores are coalesced.
//  * P5 (one query at a time): one thread per query copies its whole row, 16
//    bytes at a time, serially: the naive form.
//  * P2 (the matrix unit): per warp, a one-hot [16 queries, 16 rows] tile is
//    built in shared memory and multiplied with a 16-row piece of the table on
//    the tensor cores (nvcuda::wmma m16n16k16, bf16 inputs, fp32 accumulate),
//    for every 16 rows of the table; the block stages the table in shared
//    memory a slab of SLAB rows at a time. A width below the fragment's 16
//    columns is zero-padded in the staged slab. The sum has one non-zero term,
//    so the fp32 result equals the bf16 row exactly.
//  * P3 (the matrix unit, transposed): a block owns 8 output tiles of 16 rows
//    (a warp each) and walks over all N updates, CH at a time staged in shared
//    memory (indices, and g rounded to bf16); per 16 updates a warp builds the
//    one-hot [16 rows, 16 updates] tile and multiplies it with the updates'
//    [16, F] piece (wmma, bf16 inputs, fp32 accumulate). A tile has one owner,
//    so there are no atomics, and the product does 2 * N * T * F operations.
//  * P4 (a resident accumulator, one range at a time): block (range, slice)
//    adds the updates of its slice of N that fall in its range of R rows into
//    a shared-memory accumulator (shared atomics, a warp walking 32 updates a
//    step, lanes across the row), then adds the range's non-zero entries to
//    the output with global atomics. R * F * 4 bytes = 96 KB of shared memory.
//  * P6 (one update at a time): one thread per update row adds its F values
//    with F serial fp32 global atomics: the naive form.
//
// What bounds them. The functions are a gather and a scatter-add whatever the
// mechanism. A gather reads the indices and the rows they name once and writes
// the result once; a scatter-add reads the indices and the updates once and
// writes the output once (N * 4 + N * F * 4 + T * F * 4 bytes).
// All six are bound by bytes. P1 and P5 write bf16 (80 MB, 0.024 ms at
// N = 2^20, T = 131072, F = 32 on an H100 SXM), P2 writes fp32 (147 MB,
// 0.044 ms). The one-hot products of P2 and P3 add 2 * N * T * F operations of
// their own (8.8e12 at that shape: 8.9 ms at the bf16 tensor-core peak) that
// the functions do not need; that overhead is what those probes are here to
// show, as they were on the TPU, and it is reported apart from the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;

// P1: thread -> (query, 16-byte piece); pieces = row bytes / 16.
__global__ void __launch_bounds__(THREADS) gather_coalesced_kernel(
    const uint4* __restrict__ table, const int* __restrict__ idx, uint4* __restrict__ out, int64_t n, int pieces) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n * pieces) return;
  const int64_t q = t / pieces;
  const int piece = (int)(t - q * pieces);
  out[t] = __ldg(table + (int64_t)__ldg(idx + q) * pieces + piece);
}

// P5: thread -> query; the row is copied piece by piece.
__global__ void __launch_bounds__(THREADS) gather_serial_kernel(
    const uint4* __restrict__ table, const int* __restrict__ idx, uint4* __restrict__ out, int64_t n, int pieces) {
  const int64_t q = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (q >= n) return;
  const uint4* src = table + (int64_t)idx[q] * pieces;
  uint4* dst = out + q * pieces;
  for (int p = 0; p < pieces; ++p) dst[p] = src[p];
}

// P2: a warp owns 16 queries; FP = F padded to a multiple of 16.
constexpr int SLAB = 512;
constexpr int WARPS = THREADS / 32;

template <int F, int FP>
__global__ void __launch_bounds__(THREADS) gather_onehot_kernel(
    const __nv_bfloat16* __restrict__ table, const int* __restrict__ idx, float* __restrict__ out, int64_t n,
    int t_rows) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 slab[SLAB * FP];
  __shared__ __align__(32) __nv_bfloat16 onehot[WARPS][16 * 16];
  __shared__ __align__(32) float result[WARPS][16 * 16];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t q0 = ((int64_t)blockIdx.x * WARPS + warp) * 16;
  // lane -> row lane / 2 of the one-hot tile, columns (lane % 2) * 8 .. + 8
  const int64_t q = q0 + lane / 2;
  const int my_idx = q < n ? idx[q] : -1;
  const int col0 = (lane % 2) * 8;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FP / 16];
#pragma unroll
  for (int j = 0; j < FP / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int base = 0; base < t_rows; base += SLAB) {
    __syncthreads();
    if constexpr (F == FP) {  // rows are contiguous in both: copy 16 bytes at a time
      constexpr int PIECES = FP / 8;
      const uint4* src = reinterpret_cast<const uint4*>(table) + (int64_t)base * PIECES;
      const int64_t have = (int64_t)min(SLAB, t_rows - base) * PIECES;
      for (int e = threadIdx.x; e < SLAB * PIECES; e += THREADS)
        reinterpret_cast<uint4*>(slab)[e] = e < have ? __ldg(src + e) : make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (int e = threadIdx.x; e < SLAB * FP; e += THREADS) {
        const int r = e / FP, c = e - r * FP;
        slab[e] = (c < F && base + r < t_rows) ? table[(int64_t)(base + r) * F + c] : __float2bfloat16(0.0f);
      }
    }
    __syncthreads();
    for (int k = 0; k < SLAB; k += 16) {
      const int first = base + k + col0;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        onehot[warp][(lane / 2) * 16 + col0 + c] = __float2bfloat16(my_idx == first + c ? 1.0f : 0.0f);
      __syncwarp();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, onehot[warp], 16);
#pragma unroll
      for (int j = 0; j < FP / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, slab + k * FP + j * 16, FP);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int j = 0; j < FP / 16; ++j) {
    wmma::store_matrix_sync(result[warp], acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 16 * 16; e += 32) {
      const int r = e / 16, c = j * 16 + e % 16;
      if (q0 + r < n && c < F) out[(q0 + r) * F + c] = result[warp][e];
    }
    __syncwarp();
  }
}


// P3: block -> 8 output tiles of 16 rows (a warp each); updates staged CH at a time.
constexpr int CH = 256;

template <int F, int FP>
__global__ void __launch_bounds__(THREADS) scatter_onehot_kernel(
    const int* __restrict__ idx, const float* __restrict__ g, float* __restrict__ out, int64_t n, int t_rows) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 upd[CH * FP];
  __shared__ int sidx[CH];
  __shared__ __align__(32) __nv_bfloat16 onehot[WARPS][16 * 16];
  __shared__ __align__(32) float result[WARPS][16 * 16];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * WARPS + warp) * 16;
  // lane -> row lane / 2 of the one-hot tile, update columns (lane % 2) * 8 .. + 8
  const int my_row = row0 + lane / 2;
  const int col0 = (lane % 2) * 8;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FP / 16];
#pragma unroll
  for (int j = 0; j < FP / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int64_t base = 0; base < n; base += CH) {
    __syncthreads();
    for (int e = threadIdx.x; e < CH; e += THREADS) sidx[e] = base + e < n ? __ldg(idx + base + e) : -1;
    for (int e = threadIdx.x; e < CH * FP; e += THREADS) {
      const int r = e / FP, c = e - r * FP;
      upd[e] = __float2bfloat16_rn((c < F && base + r < n) ? __ldg(g + (base + r) * F + c) : 0.0f);
    }
    __syncthreads();
    for (int k = 0; k < CH; k += 16) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        onehot[warp][(lane / 2) * 16 + col0 + c] = __float2bfloat16(sidx[k + col0 + c] == my_row ? 1.0f : 0.0f);
      __syncwarp();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, onehot[warp], 16);
#pragma unroll
      for (int j = 0; j < FP / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, upd + k * FP + j * 16, FP);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int j = 0; j < FP / 16; ++j) {
    wmma::store_matrix_sync(result[warp], acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 16 * 16; e += 32) {
      const int r = e / 16, c = j * 16 + e % 16;
      if (row0 + r < t_rows && c < F) out[(int64_t)(row0 + r) * F + c] = result[warp][e];
    }
    __syncwarp();
  }
}

// P4: block (range, slice); the range's accumulator in dynamic shared memory.
constexpr int RANGE_FLOATS = 24576;  // 96 KB

template <int F>
__global__ void __launch_bounds__(THREADS) scatter_blocked_kernel(
    const int* __restrict__ idx, const float* __restrict__ g, float* __restrict__ out, int64_t n, int t_rows,
    int64_t slice) {
  extern __shared__ float acc[];
  constexpr int R = RANGE_FLOATS / F;
  constexpr int PER = 32 / F > 0 ? 32 / F : 1;  // updates a warp adds at once (lanes across F columns)
  const int r0 = blockIdx.x * R;
  const int rows = min(R, t_rows - r0);
  const int64_t u0 = (int64_t)blockIdx.y * slice;
  const int64_t u1 = min(n, u0 + slice);
  for (int e = threadIdx.x; e < R * F; e += THREADS) acc[e] = 0.0f;
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int64_t w0 = u0 + (int64_t)warp * 32; w0 < u1; w0 += (int64_t)WARPS * 32) {
    const int64_t u = w0 + lane;
    const int r = u < u1 ? __ldg(idx + u) - r0 : -1;
    unsigned hits = __ballot_sync(0xffffffffu, r >= 0 && r < rows);
    while (hits) {
      // PER updates at a time, F lanes each
      int mine = -1, k = 0;
      unsigned rest = hits;
      for (int q = 0; q < PER && rest; ++q) {
        const int b = __ffs(rest) - 1;
        rest &= rest - 1;
        if (lane / F == q) mine = b;
        ++k;
      }
      hits = rest;
      const int rr = __shfl_sync(0xffffffffu, r, mine < 0 ? 0 : mine);
      if (mine >= 0) {
        const int col = lane % F;
        atomicAdd(acc + rr * F + col, __ldg(g + (w0 + mine) * F + col));
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * F; e += THREADS) {
    const float v = acc[e];
    if (v != 0.0f) atomicAdd(out + (int64_t)r0 * F + e, v);
  }
}

// P6: thread -> update row; F serial atomics.
__global__ void __launch_bounds__(THREADS) scatter_serial_kernel(
    const int* __restrict__ idx, const float* __restrict__ g, float* __restrict__ out, int64_t n, int f) {
  const int64_t u = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (u >= n) return;
  float* dst = out + (int64_t)__ldg(idx + u) * f;
  const float* src = g + u * f;
  for (int j = 0; j < f; ++j) atomicAdd(dst + j, __ldg(src + j));
}

int blocks_for(int64_t work) { return (int)((work + THREADS - 1) / THREADS); }

}  // namespace

// table [t_rows, f] bf16, idx [n] int32 in [0, t_rows), out [n, f] bf16;
// f * 2 must be a multiple of 16 bytes. Return the launch's cudaError_t, or -1
// for arguments no kernel takes.
extern "C" int gather_rows_coalesced(const void* table, const int* idx, void* out, long long n, int t_rows, int f,
                                     void* stream) {
  if ((f * 2) % 16 != 0 || f < 8 || n < 0 || n * (f / 8) > 2147483647LL * THREADS) return -1;
  if (n == 0) return 0;
  const int pieces = f / 8;
  gather_coalesced_kernel<<<blocks_for(n * pieces), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), idx, static_cast<uint4*>(out), n, pieces);
  return (int)cudaGetLastError();
}

extern "C" int gather_rows_serial(const void* table, const int* idx, void* out, long long n, int t_rows, int f,
                                  void* stream) {
  if ((f * 2) % 16 != 0 || f < 8 || n < 0) return -1;
  if (n == 0) return 0;
  gather_serial_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), idx, static_cast<uint4*>(out), n, f / 8);
  return (int)cudaGetLastError();
}

// out [n, f] fp32; f in {8, 16, 32}.
extern "C" int gather_rows_onehot(const void* table, const int* idx, float* out, long long n, int t_rows, int f,
                                  void* stream) {
  if (n < 0 || t_rows < 1) return -1;
  if (n == 0) return 0;
  const int blocks = (int)((n + WARPS * 16 - 1) / (WARPS * 16));
  const __nv_bfloat16* tbl = static_cast<const __nv_bfloat16*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f == 8) gather_onehot_kernel<8, 16><<<blocks, THREADS, 0, st>>>(tbl, idx, out, n, t_rows);
  else if (f == 16) gather_onehot_kernel<16, 16><<<blocks, THREADS, 0, st>>>(tbl, idx, out, n, t_rows);
  else if (f == 32) gather_onehot_kernel<32, 32><<<blocks, THREADS, 0, st>>>(tbl, idx, out, n, t_rows);
  else return -1;
  return (int)cudaGetLastError();
}

// Scatter-adds: idx [n] int32 in [0, t_rows), g [n, f] fp32, out [t_rows, f]
// fp32, zero-filled by the caller. Return the launch's cudaError_t, or -1 for
// arguments no kernel takes.
extern "C" int scatter_rows_onehot(const int* idx, const float* g, float* out, long long n, int t_rows, int f,
                                   void* stream) {
  if (n < 0 || t_rows < 1) return -1;
  if (n == 0) return 0;
  const int blocks = (t_rows + WARPS * 16 - 1) / (WARPS * 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f == 8) scatter_onehot_kernel<8, 16><<<blocks, THREADS, 0, st>>>(idx, g, out, n, t_rows);
  else if (f == 16) scatter_onehot_kernel<16, 16><<<blocks, THREADS, 0, st>>>(idx, g, out, n, t_rows);
  else if (f == 32) scatter_onehot_kernel<32, 32><<<blocks, THREADS, 0, st>>>(idx, g, out, n, t_rows);
  else return -1;
  return (int)cudaGetLastError();
}

template <int F>
cudaError_t launch_blocked(const int* idx, const float* g, float* out, int64_t n, int t_rows, cudaStream_t st) {
  constexpr int R = RANGE_FLOATS / F;
  const int ranges = (t_rows + R - 1) / R;
  // enough (range, slice) blocks to fill the card four times over; slices of at least 4096 updates
  int64_t slices = (4 * 132 + ranges - 1) / ranges;
  slices = std::max<int64_t>(1, std::min<int64_t>(slices, (n + 4095) / 4096));
  const int64_t slice = (n + slices - 1) / slices;
  const size_t smem = RANGE_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(scatter_blocked_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  scatter_blocked_kernel<F><<<dim3(ranges, (unsigned)slices), THREADS, smem, st>>>(idx, g, out, n, t_rows, slice);
  return cudaGetLastError();
}

extern "C" int scatter_rows_blocked(const int* idx, const float* g, float* out, long long n, int t_rows, int f,
                                    void* stream) {
  if (n < 0 || t_rows < 1) return -1;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (f == 8) err = launch_blocked<8>(idx, g, out, n, t_rows, st);
  else if (f == 16) err = launch_blocked<16>(idx, g, out, n, t_rows, st);
  else if (f == 32) err = launch_blocked<32>(idx, g, out, n, t_rows, st);
  else return -1;
  return (int)err;
}

extern "C" int scatter_rows_serial(const int* idx, const float* g, float* out, long long n, int t_rows, int f,
                                   void* stream) {
  if (n < 0 || t_rows < 1 || f < 1) return -1;
  if (n == 0) return 0;
  scatter_serial_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(idx, g, out, n, f);
  return (int)cudaGetLastError();
}
