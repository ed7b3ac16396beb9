// Fused multi-resolution hash-grid lookup for Hopper (sm_90a): per sample and
// level, cell index (dense or hashed) -> table row(s) -> D-linear interpolation
// in the read type -> level weight. Forward only.
//
// Replaces the hand-written hot operator of neurad_tpu/ops/hash_encoding.py:
//   hash_grid_fwd <- _interp_gather_cp_impl (cell-packed rows: row fetch, bucket
//                    select, interpolation), and the same family for the other
//                    layouts: _gather_levels_multi_impl (one row per corner) and
//                    _gather_levels_impl (one array for all levels), together
//                    with the index and weight code of hash_encode around them
//                    (scale, floor, _hash / _dense_index, bucket // pk, corner
//                    weights) and gaussian_level_weights.
// Plain PyTorch version of the same function: hash_grid_encode_plain in
// neurad_tpu_torch/ops/hash_encoding.py.
//
// Boundary. In: positions [N, D] fp32 in [0, 1]^D, optionally one std per
// position, and L per-level tables. Out: [N, L * F] fp32. The JAX code loops
// over levels in Python and hands XLA per-level index, sub-bucket and weight
// arrays (40 bytes per sample and level, against a 64-byte bf16 row); here one
// launch does every level of an encoding and none of those arrays exists.
// Positions are the boundary because the backward kernel will have to return
// the gradient for the same inputs: d/d position = scale * sum_c d w_c / d
// offset * <row_c, g>, next to the table's gradient.
//
// Table layouts, all served by one addressing rule. A level's table is
// [rows, pk * row_width] fp32 with pk logical buckets per physical row; its
// row-major memory is also [rows * pk, row_width], so the logical bucket
// addresses its row directly and bucket // pk, bucket % pk never appear.
// CELL = true: row_width = 2^D * F, one row holds a cell's 2^D corner features
// and the cell's floor coordinate is indexed. CELL = false: row_width = F and
// each corner (floor + offset) is indexed on its own. A single array holding
// all levels one after the other is passed as L base pointers into it.
//
// Numbers that must match the plain version to the last bit (the lookup is a
// gather and a fixed-order sum; there are no atomics):
//  * position * scale, floor and the offset are single fp32 operations
//    (__fmul_rn / floorf / __fsub_rn), never contracted into an FMA: floor is a
//    step, and a position one ulp apart lands in another row;
//  * the hash multiplies uint32 coordinates by (1, 2654435761, 805459861,
//    3674653429) with wraparound, xors, then takes % buckets; the dense index
//    clips each coordinate to [0, res - 1] and is row-major, dimension 0 slowest;
//  * corner c has bit i set for dimension i; its weight is the product over the
//    dimensions in order of (offset_i if bit else 1 - offset_i), in fp32;
//  * BF16 = true: the fp32 master table is read and rounded to bf16 in the
//    kernel (round to nearest even; no bf16 copy of the tables is kept), the
//    weights are rounded to bf16, and each product and each of the 2^D - 1
//    additions, corners in order 0 .. 2^D - 1, is rounded to bf16. A product
//    of two bf16 values is exact in fp32 and an fp32 sum rounded to bf16 equals
//    the bf16 sum (24 >= 2 * 8 + 2 bits), so fp32 _rn intrinsics followed by a
//    rounding reproduce bf16 arithmetic; nvcc cannot fuse them;
//  * the level weight is 1 / max(std * (2 * scale), 1) in fp32 and multiplies
//    the interpolated features after their conversion to fp32.
//
// What bounds it: bytes. A sample-level reads one row of 2^D * F fp32 (128 B at
// D = 3, F = 4) and writes F fp32; the arithmetic is about 100 operations. At
// the full width of the NeuRAD field (N = 1,048,576 samples a chunk, L = 8)
// that is 1.07 GB of rows, 0.32 ms at 3.35 TB/s, less what the two dense
// levels (4.6 MB and 45.8 MB) keep in the 50 MB L2, plus 12.6 MB of positions
// and 134 MB of output.
//
// What the design does about it. One thread per (sample, level), levels
// fastest: the L threads of a sample read the same position (a broadcast) and
// write neighbouring pieces of the sample's output row, so stores are
// coalesced; each thread fetches its row as 2^D independent loads of F floats
// through the read-only path (every byte of the 128-byte line it touches is
// used) and sums the corners in registers. Layout, D, F and the read type are
// template parameters, so the corner loops unroll and nothing branches on them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int THREADS = 256;

struct Levels {
  const float* table[MAX_LEVELS];
  uint32_t buckets[MAX_LEVELS];  // logical buckets (rows * pk): the hash's modulus
  int dense_res[MAX_LEVELS];     // 0: hashed level
  float scale[MAX_LEVELS];
};

template <int F>
struct Row;
template <>
struct Row<1> {
  float v[1];
  __device__ __forceinline__ void load(const float* p) { v[0] = __ldg(p); }
};
template <>
struct Row<2> {
  float v[2];
  __device__ __forceinline__ void load(const float* p) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  }
};
template <>
struct Row<4> {
  float v[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
};

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

template <int D>
__device__ __forceinline__ uint32_t bucket_of(const int (&coord)[D], uint32_t buckets, int res) {
  if (res > 0) {
    int idx = 0;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int c = min(max(coord[i], 0), res - 1);
      idx = idx * res + c;
    }
    return (uint32_t)idx;
  }
  uint32_t h = (uint32_t)coord[0];  // prime 1
  if (D > 1) h ^= (uint32_t)coord[1] * 2654435761u;
  if (D > 2) h ^= (uint32_t)coord[2 % D] * 805459861u;
  if (D > 3) h ^= (uint32_t)coord[3 % D] * 3674653429u;
  return h % buckets;
}

template <int D, int F, bool BF16, bool CELL>
__global__ void __launch_bounds__(THREADS) hash_grid_fwd_kernel(
    const float* __restrict__ positions, const float* __restrict__ stds, Levels lv, int n_levels, int64_t n,
    float* __restrict__ out) {
  constexpr int C = 1 << D;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (tid >= n * n_levels) return;
  const int64_t s = tid / n_levels;
  const int l = (int)(tid - s * n_levels);
  const float scale = lv.scale[l];

  int cell[D];
  float off[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float scaled = __fmul_rn(__ldg(positions + s * D + i), scale);
    const float fl = floorf(scaled);
    off[i] = __fsub_rn(scaled, fl);
    cell[i] = (int)fl;
  }

  const float* table = lv.table[l];
  const uint32_t buckets = lv.buckets[l];
  const int res = lv.dense_res[l];
  Row<F> rows[C];
  if constexpr (CELL) {
    const float* row = table + (size_t)bucket_of<D>(cell, buckets, res) * (C * F);
#pragma unroll
    for (int c = 0; c < C; ++c) rows[c].load(row + c * F);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      int corner[D];
#pragma unroll
      for (int i = 0; i < D; ++i) corner[i] = cell[i] + ((c >> i) & 1);
      rows[c].load(table + (size_t)bucket_of<D>(corner, buckets, res) * F);
    }
  }

  float acc[F];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float w = (c & 1) ? off[0] : __fsub_rn(1.0f, off[0]);
#pragma unroll
    for (int i = 1; i < D; ++i) w = __fmul_rn(w, ((c >> i) & 1) ? off[i] : __fsub_rn(1.0f, off[i]));
    if (BF16) w = round_bf16(w);
#pragma unroll
    for (int j = 0; j < F; ++j) {
      const float v = BF16 ? round_bf16(rows[c].v[j]) : rows[c].v[j];
      float term = __fmul_rn(v, w);
      if (BF16) term = round_bf16(term);
      if (c == 0) {
        acc[j] = term;
      } else {
        acc[j] = __fadd_rn(acc[j], term);
        if (BF16) acc[j] = round_bf16(acc[j]);
      }
    }
  }

  float lw = 1.0f;
  if (stds != nullptr) lw = __frcp_rn(fmaxf(__fmul_rn(__ldg(stds + s), 2.0f * scale), 1.0f));
  float* o = out + tid * F;  // (s * n_levels + l) * F
  if (stds != nullptr) {
#pragma unroll
    for (int j = 0; j < F; ++j) acc[j] = __fmul_rn(acc[j], lw);
  }
  if constexpr (F == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else if constexpr (F == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
  } else {
    o[0] = acc[0];
  }
}

template <int D, int F>
cudaError_t launch(const float* positions, const float* stds, const Levels& lv, int n_levels, int64_t n, float* out,
                   bool bf16, bool cell, cudaStream_t stream) {
  const int64_t total = n * n_levels;
  if (total == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  if (bf16 && cell)
    hash_grid_fwd_kernel<D, F, true, true><<<blocks, THREADS, 0, stream>>>(positions, stds, lv, n_levels, n, out);
  else if (bf16)
    hash_grid_fwd_kernel<D, F, true, false><<<blocks, THREADS, 0, stream>>>(positions, stds, lv, n_levels, n, out);
  else if (cell)
    hash_grid_fwd_kernel<D, F, false, true><<<blocks, THREADS, 0, stream>>>(positions, stds, lv, n_levels, n, out);
  else
    hash_grid_fwd_kernel<D, F, false, false><<<blocks, THREADS, 0, stream>>>(positions, stds, lv, n_levels, n, out);
  return cudaGetLastError();
}

}  // namespace

// positions [n, d] fp32; stds [n] fp32 or null (no level weight); tables,
// buckets, dense_res, scales: host arrays of n_levels entries (device pointers
// of the level tables, logical bucket counts, dense resolution or 0, grid
// scale); out [n, n_levels * f] fp32. Returns the launch's cudaError_t, or -1
// for arguments no kernel was built for.
extern "C" int hash_grid_fwd(const float* positions, const float* stds, const void* const* tables, const int* buckets,
                             const int* dense_res, const float* scales, float* out, long long n, int n_levels, int d,
                             int f, int read_bf16, int cell_packed, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || n < 0) return -1;
  if ((n * n_levels + THREADS - 1) / THREADS > 2147483647LL) return -1;
  Levels lv;
  for (int l = 0; l < n_levels; ++l) {
    lv.table[l] = static_cast<const float*>(tables[l]);
    lv.buckets[l] = (uint32_t)buckets[l];
    lv.dense_res[l] = dense_res[l];
    lv.scale[l] = scales[l];
    if (buckets[l] < 1) return -1;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool b = read_bf16 != 0, c = cell_packed != 0;
  cudaError_t err;
  if (d == 3 && f == 1) err = launch<3, 1>(positions, stds, lv, n_levels, n, out, b, c, st);
  else if (d == 3 && f == 2) err = launch<3, 2>(positions, stds, lv, n_levels, n, out, b, c, st);
  else if (d == 3 && f == 4) err = launch<3, 4>(positions, stds, lv, n_levels, n, out, b, c, st);
  else if (d == 4 && f == 1) err = launch<4, 1>(positions, stds, lv, n_levels, n, out, b, c, st);
  else if (d == 4 && f == 2) err = launch<4, 2>(positions, stds, lv, n_levels, n, out, b, c, st);
  else if (d == 4 && f == 4) err = launch<4, 4>(positions, stds, lv, n_levels, n, out, b, c, st);
  else return -1;
  return (int)err;
}
