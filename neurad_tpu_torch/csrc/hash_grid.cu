// Fused multi-resolution hash-grid lookup for Hopper (sm_90a), forward and
// backward: per sample and level, cell index (dense or hashed) -> table row(s)
// -> D-linear interpolation in the read type -> level weight, and the table,
// position and std gradients of the same function.
//
// Replaces the hand-written hot operator of neurad_tpu/ops/hash_encoding.py:
//   hash_grid_fwd <- _interp_gather_cp_impl (cell-packed rows: row fetch, bucket
//                    select, interpolation), and the same family for the other
//                    layouts: _gather_levels_multi_impl (one row per corner) and
//                    _gather_levels_impl (one array for all levels), together
//                    with the index and weight code of hash_encode around them
//                    (scale, floor, _hash / _dense_index, bucket // pk, corner
//                    weights) and gaussian_level_weights.
//   hash_grid_bwd <- _interp_gather_cp_bwd (K1b), _gather_levels_multi_bwd and
//                    _gather_levels_bwd, with the autodiff of the index, weight
//                    and level-weight code around them.
// Plain PyTorch versions of the same functions: hash_grid_encode_plain and
// hash_grid_encode_bwd_plain in neurad_tpu_torch/ops/hash_encoding.py.
//
// Boundary. In: positions [N, D] fp32 in [0, 1]^D, optionally one std per
// position, and L per-level tables. Out: [N, L * F] fp32. The JAX code loops
// over levels in Python and hands XLA per-level index, sub-bucket and weight
// arrays (40 bytes per sample and level, against a 64-byte bf16 row); here one
// launch does every level of an encoding and none of those arrays exists. The
// backward takes the same inputs and the output's gradient g [N, L * F] and
// returns d tables (each table's shape, fp32), d positions [N, D] and d stds
// [N]; any of them may be skipped (a null pointer).
//
// Table layouts, all served by one addressing rule. A level's table is
// [rows, pk * row_width] fp32 with pk logical buckets per physical row; its
// row-major memory is also [rows * pk, row_width], so the logical bucket
// addresses its row directly and bucket // pk, bucket % pk never appear.
// CELL = true: row_width = 2^D * F, one row holds a cell's 2^D corner features
// and the cell's floor coordinate is indexed. CELL = false: row_width = F and
// each corner (floor + offset) is indexed on its own. A single array holding
// all levels one after the other is passed as L base pointers into it. The
// table gradient has the table's layout and is addressed by the same rule (the
// JAX backward scatters into the same unpacked [rows * pk, row_width] view).
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
// The backward, per (sample, level), recomputes the cell, buckets, offsets and
// corner weights with the forward's operations (so it scatters into the rows
// the forward read), then:
//  * g' = g * level weight in fp32, rounded to bf16 with bf16 reads (the JAX
//    cotangent reaching its VJP is that product in the read type);
//  * table gradient: w_c * g'_j, with bf16 reads round_bf16(round_bf16(w_c) *
//    g'_j) as the JAX backward builds its update rows in bf16, added in fp32
//    with vector atomics. The updates of the lanes of a warp that land on one
//    row are summed first, in ascending lane order; the order in which the
//    warps' sums reach a row, and so the last bits of a hot row, changes from
//    launch to launch. (The JAX package accumulates a level in bf16 when its
//    fp32 buffer exceeds 32 MiB; here every level accumulates in fp32.)
//  * dL/dw_c = sum_j row_c,j * g'_j in fp32 from the rows in the read type
//    (re-read here: the autograd function saves only its inputs), folded into
//    dL/doffset_i = sum_c (+-) prod_{k != i} (offset_k or 1 - offset_k) * dL/dw_c
//    and dL/dposition_i = scale * dL/doffset_i;
//  * dL/dstd = -(sum_j o_j * g_j) / x^2 * 2 * scale with x = std * 2 * scale,
//    zero where x <= 1 (the clamp), o the interpolated features before the
//    level weight.
// A block owns whole samples; their position and std gradients are summed
// over the levels in level order through shared memory and written once, with
// no atomics, so they do not vary between launches.
//
// What bounds them: bytes. A forward sample-level reads one row of 2^D * F
// fp32 (128 B at D = 3, F = 4) and writes F fp32; the arithmetic is about 100
// operations. At the full width of the NeuRAD field (N = 1,048,576 samples a
// chunk, L = 8) that is 1.07 GB of rows, 0.32 ms at 3.35 TB/s, less what the
// two dense levels (4.6 MB and 45.8 MB) keep in the 50 MB L2, plus 12.6 MB of
// positions and 134 MB of output. The backward's least traffic is its inputs
// read once (positions, stds, g, and the rows a position gradient needs) and
// the table gradient written once: with the gradient dense over the table, the
// whole table's bytes (432 MiB at the `neurad` preset) bound it, however few
// rows a launch touches.
//
// What the design does about it. One thread per (sample, level), levels
// fastest: the L threads of a sample read the same position (a broadcast) and
// write neighbouring pieces of the sample's output row, so stores are
// coalesced; each thread fetches its row as 2^D independent loads of F floats
// through the read-only path (every byte of the 128-byte line it touches is
// used) and sums the corners in registers. Layout, D, F and the read type are
// template parameters, so the corner loops unroll and nothing branches on them.
//
// The backward (K1b) meets what the forward does not: a scatter whose rows are
// hot. The coarse dense levels put most samples of a ray into a few cells (at
// the `neurad` preset a train chunk's 2.1 M sample-levels fall into 736,018
// distinct rows), and one thread per (sample, level) sent 2^D float4 atomics
// one after another into its 128-byte row: no two lanes of a warp coalesced,
// and no two updates of a hot cell met before L2. So its design differs:
//  * a block owns whole samples and a warp owns one level of 32 consecutive
//    samples (256 threads = 8 levels x 32 samples; 4 levels: two groups of
//    32). A train chunk is ray-major with 32 samples a ray, so a warp is
//    usually one ray at one level and the coarse levels' hot cells meet in it;
//  * the warp finds its lanes with equal buckets (__match_any_sync) and sums
//    their 2^D * F updates, staged in shared memory (32 slots of 2^D * F + 4
//    floats a warp: 4.5 KB at D = 3, F = 4), in ascending lane order, so one
//    update a distinct row leaves the warp;
//  * 2^D * F / 4 consecutive lanes cover one distinct row of the cell-packed
//    layout, a float4 atomic each: one warp instruction adds whole rows, and
//    the row's 128 bytes arrive together. The row re-read for dL/dw_c goes the
//    same way: each distinct row is read once, coalesced, into the staging,
//    and every lane takes its cell's corners from there. It is skipped when no
//    position or std gradient is asked for;
//  * the unpacked layout (one row a corner) keeps the structure corner by
//    corner: the lanes whose corner c lands on one row are grouped, one
//    vector atomic of F floats a distinct row, and each lane reads its own
//    corner rows (F floats each, through L1);
//  * per-corner values live in shared memory or in fully unrolled loops over
//    template parameters, so no instantiation keeps a local-memory frame
//    (the ptxas report in _build/hash_grid.log).

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

// Corner c's weight: the product over the dimensions in order of (offset_i if
// bit i of c is set, else 1 - offset_i), rounded to bf16 with bf16 reads.
template <int D, bool BF16>
__device__ __forceinline__ float corner_weight(const float (&off)[D], int c) {
  float w = (c & 1) ? off[0] : __fsub_rn(1.0f, off[0]);
#pragma unroll
  for (int i = 1; i < D; ++i) w = __fmul_rn(w, ((c >> i) & 1) ? off[i] : __fsub_rn(1.0f, off[i]));
  return BF16 ? round_bf16(w) : w;
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
    const float w = corner_weight<D, BF16>(off, c);
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


// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct LevelGrads {
  float* dtable[MAX_LEVELS];  // null: the level's table needs no gradient
};

constexpr int BWD_WARPS = 8;                      // a block's warps where L <= 8 (L warps where L > 8)
constexpr int BWD_MAX_THREADS = 32 * MAX_LEVELS;  // L = 16: one warp a level

// Shared-memory loads and stores of V consecutive floats (V = 1, 2, 4; the
// address is aligned to the vector).
template <int V>
__device__ __forceinline__ void lds_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

template <int V>
__device__ __forceinline__ void sts_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// One atomic add of F consecutive floats: a vector atomic where F is 4 or 2.
template <int F>
__device__ __forceinline__ void atomic_add_row(float* p, const float (&v)[F]) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && \
    (__CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
  if constexpr (F == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
#else
#pragma unroll
  for (int j = 0; j < F; ++j) atomicAdd(p + j, v[j]);
#endif
}

// The table update w_c * g'_j (round(round(w_c) * round(g'_j)) with bf16 reads;
// g' arrives rounded).
template <int D, bool BF16>
__device__ __forceinline__ float update_term(const float (&off)[D], int c, float gp_j) {
  const float u = __fmul_rn(corner_weight<D, BF16>(off, c), gp_j);
  return BF16 ? round_bf16(u) : u;
}

// Fold corner c's features v (in the read type) into the lane's sums, corners
// in order 0 .. 2^D - 1: dL/dw_c = sum_j v_j g'_j goes into dL/doffset_i with
// the sign of bit i times the product of the other dimensions' factors, in
// order; and the interpolated features o_j (for the std's gradient).
template <int D, int F, bool BF16>
__device__ __forceinline__ void fold_corner(int c, const float (&v)[F], const float (&gp)[F], const float (&off)[D],
                                            float (&doff)[D], float (&o)[F]) {
  float dw = __fmul_rn(v[0], gp[0]);
#pragma unroll
  for (int j = 1; j < F; ++j) dw = __fadd_rn(dw, __fmul_rn(v[j], gp[j]));
  const float w = corner_weight<D, BF16>(off, c);
#pragma unroll
  for (int j = 0; j < F; ++j) {
    float term = __fmul_rn(v[j], w);
    if (BF16) term = round_bf16(term);
    if (c == 0) {
      o[j] = term;
    } else {
      o[j] = __fadd_rn(o[j], term);
      if (BF16) o[j] = round_bf16(o[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float p = 1.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k != i) p = __fmul_rn(p, ((c >> k) & 1) ? off[k] : __fsub_rn(1.0f, off[k]));
    }
    const float term = __fmul_rn(dw, p);
    const float prev = c == 0 ? 0.0f : doff[i];
    doff[i] = ((c >> i) & 1) ? __fadd_rn(prev, term) : __fsub_rn(prev, term);
  }
}

// Level l's parameters, read from the kernel's parameter arrays with constant
// indices only: indexed at run time, ptxas copied the gradients' pointer array
// into a 128-byte local-memory frame.
struct Level {
  const float* table;
  float* dtable;
  uint32_t buckets;
  int res;
  float scale;
};

__device__ __forceinline__ Level level_of(const Levels& lv, const LevelGrads& gr, int l) {
  Level r{lv.table[0], gr.dtable[0], lv.buckets[0], lv.dense_res[0], lv.scale[0]};
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i) {
    if (l == i) r = Level{lv.table[i], gr.dtable[i], lv.buckets[i], lv.dense_res[i], lv.scale[i]};
  }
  return r;
}

// The lanes of a warp whose keys are equal: each lane's peer mask and its
// row's rank among the warp's distinct rows (ascending leader lane); the
// leader of each distinct row writes the row's peer mask and bucket at its
// rank. An inactive lane takes a key no bucket (< 2^31) equals.
struct RowGroup {
  unsigned peers;
  int rank;
  int n_rows;
};

__device__ __forceinline__ RowGroup group_rows(uint32_t bucket, bool active, int lane, unsigned* peers_sh,
                                               uint32_t* row_sh) {
  RowGroup r;
  r.peers = __match_any_sync(0xffffffffu, active ? bucket : (0x80000000u | (unsigned)lane));
  const int leader = __ffs(r.peers) - 1;
  const unsigned leaders = __ballot_sync(0xffffffffu, active && lane == leader);
  r.n_rows = __popc(leaders);
  r.rank = __popc(leaders & ((1u << leader) - 1u));
  if (active && lane == leader) {
    peers_sh[r.rank] = r.peers;
    row_sh[r.rank] = bucket;
  }
  return r;
}

// The sum, in ascending lane order, of the V floats at `offset` of the staging
// slots of the lanes in `peers`.
template <int V>
__device__ __forceinline__ void sum_peers(const float* stage, int stride, int offset, unsigned peers, float (&sum)[V]) {
  lds_vec<V>(stage + (__ffs(peers) - 1) * stride + offset, sum);
  for (unsigned m = peers & (peers - 1); m != 0; m &= m - 1) {
    float t[V];
    lds_vec<V>(stage + (__ffs(m) - 1) * stride + offset, t);
#pragma unroll
    for (int q = 0; q < V; ++q) sum[q] += t[q];
  }
}

template <int D, int F, bool BF16, bool CELL>
__global__ void __launch_bounds__(BWD_MAX_THREADS) hash_grid_bwd_kernel(
    const float* __restrict__ positions, const float* __restrict__ stds, const float* __restrict__ g, Levels lv,
    LevelGrads gr, int n_levels, int groups, int64_t n, float* __restrict__ dpos, float* __restrict__ dstd) {
  constexpr int C = 1 << D;
  constexpr int W = C * F;   // floats of a lane's update: its cell's row, or its C corners' rows
  constexpr int SW = W + 4;  // staging stride: float4-aligned, a quarter warp's float4s in distinct banks
  constexpr int NV = W / 4;  // float4s of a cell-packed row: NV lanes share a row
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l = warp % n_levels, grp = warp / n_levels;  // the warps of a sample group are its levels
  const int per_block = groups * 32;
  float* stage = smem + warp * (32 * SW);  // 32 slots of SW floats
  unsigned* peers_sh = reinterpret_cast<unsigned*>(smem + warps * (32 * SW)) + warp * 64;
  uint32_t* row_sh = peers_sh + 32;
  float* red = smem + warps * (32 * SW + 64);  // [n_levels * (D + 1)][per_block]
  const int64_t s = (int64_t)blockIdx.x * per_block + grp * 32 + lane;
  const bool active = s < n;
  const bool need_rows = dpos != nullptr || dstd != nullptr;
  const Level lev = level_of(lv, gr, l);
  float* dtable = lev.dtable;

  // the forward's cell, offsets and level weight, and g' = g * level weight
  const float scale = lev.scale;
  int cell[D];
  float off[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float scaled = __fmul_rn(active ? __ldg(positions + s * D + i) : 0.0f, scale);
    const float fl = floorf(scaled);
    off[i] = __fsub_rn(scaled, fl);
    cell[i] = (int)fl;
  }
  const float* table = lev.table;
  const uint32_t buckets = lev.buckets;
  const int res = lev.res;
  Row<F> gin;
#pragma unroll
  for (int j = 0; j < F; ++j) gin.v[j] = 0.0f;
  float x = 0.0f, lw = 1.0f;
  if (active) {
    gin.load(g + ((size_t)s * n_levels + l) * F);
    if (stds != nullptr) {
      x = __fmul_rn(__ldg(stds + s), 2.0f * scale);
      lw = __frcp_rn(fmaxf(x, 1.0f));
    }
  }
  float gp[F];
#pragma unroll
  for (int j = 0; j < F; ++j) {
    gp[j] = stds != nullptr ? __fmul_rn(gin.v[j], lw) : gin.v[j];
    if (BF16) gp[j] = round_bf16(gp[j]);
  }

  float doff[D], o[F];
#pragma unroll
  for (int i = 0; i < D; ++i) doff[i] = 0.0f;
#pragma unroll
  for (int j = 0; j < F; ++j) o[j] = 0.0f;

  if constexpr (CELL) {
    // one row a lane: its cell's 2^D corners
    if (dtable != nullptr || need_rows) {
      const RowGroup rg = group_rows(bucket_of<D>(cell, buckets, res), active, lane, peers_sh, row_sh);
      if (dtable != nullptr) {
        if (active) {
#pragma unroll
          for (int e = 0; e < W; e += 4) {
            const float u[4] = {update_term<D, BF16>(off, (e + 0) / F, gp[(e + 0) % F]),
                                update_term<D, BF16>(off, (e + 1) / F, gp[(e + 1) % F]),
                                update_term<D, BF16>(off, (e + 2) / F, gp[(e + 2) % F]),
                                update_term<D, BF16>(off, (e + 3) / F, gp[(e + 3) % F])};
            sts_vec<4>(stage + lane * SW + e, u);
          }
        }
        __syncwarp();
        // NV consecutive lanes on one distinct row, a float4 each: 32 / NV whole rows an instruction
        for (int r0 = 0; r0 < rg.n_rows; r0 += 32 / NV) {
          const int ri = r0 + lane / NV, v = lane % NV;
          if (ri < rg.n_rows) {
            float sum[4];
            sum_peers<4>(stage, SW, v * 4, peers_sh[ri], sum);
            atomic_add_row<4>(dtable + (size_t)row_sh[ri] * W + v * 4, sum);
          }
        }
      }
      if (need_rows) {
        __syncwarp();  // the updates are read; the row list is written
        // each distinct row read once, coalesced, into the staging slot of its rank
        for (int r0 = 0; r0 < rg.n_rows; r0 += 32 / NV) {
          const int ri = r0 + lane / NV, v = lane % NV;
          if (ri < rg.n_rows) {
            Row<4> t;
            t.load(table + (size_t)row_sh[ri] * W + v * 4);
#pragma unroll
            for (int q = 0; q < 4; ++q) t.v[q] = BF16 ? round_bf16(t.v[q]) : t.v[q];
            sts_vec<4>(stage + ri * SW + v * 4, t.v);
          }
        }
        __syncwarp();
        if (active) {
          const float* row = stage + rg.rank * SW;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float v[F];
            lds_vec<F>(row + c * F, v);
            fold_corner<D, F, BF16>(c, v, gp, off, doff, o);
          }
        }
      }
    }
  } else {
    // one row a corner: the lanes whose corner c lands on one row are grouped, corner by corner
#pragma unroll
    for (int c = 0; c < C; ++c) {
      int corner[D];
#pragma unroll
      for (int i = 0; i < D; ++i) corner[i] = cell[i] + ((c >> i) & 1);
      const uint32_t bucket = bucket_of<D>(corner, buckets, res);
      if (dtable != nullptr) {
        if (active) {
          float u[F];
#pragma unroll
          for (int j = 0; j < F; ++j) u[j] = update_term<D, BF16>(off, c, gp[j]);
          sts_vec<F>(stage + lane * SW + c * F, u);
        }
        const RowGroup rg = group_rows(bucket, active, lane, peers_sh, row_sh);
        __syncwarp();
        if (lane < rg.n_rows) {
          float sum[F];
          sum_peers<F>(stage, SW, c * F, peers_sh[lane], sum);
          atomic_add_row<F>(dtable + (size_t)row_sh[lane] * F, sum);
        }
        __syncwarp();  // the row list is rewritten for the next corner
      }
      if (need_rows && active) {
        Row<F> r;
        r.load(table + (size_t)bucket * F);
#pragma unroll
        for (int j = 0; j < F; ++j) r.v[j] = BF16 ? round_bf16(r.v[j]) : r.v[j];
        fold_corner<D, F, BF16>(c, r.v, gp, off, doff, o);
      }
    }
  }

  if (need_rows) {  // uniform over the block
    float dp[D + 1];  // position gradient, then the std's
#pragma unroll
    for (int i = 0; i <= D; ++i) dp[i] = 0.0f;
    if (active && dpos != nullptr) {
#pragma unroll
      for (int i = 0; i < D; ++i) dp[i] = __fmul_rn(doff[i], scale);
    }
    if (active && dstd != nullptr && x > 1.0f) {
      float dlw = __fmul_rn(o[0], gin.v[0]);
#pragma unroll
      for (int j = 1; j < F; ++j) dlw = __fadd_rn(dlw, __fmul_rn(o[j], gin.v[j]));
      dp[D] = __fmul_rn(__fdiv_rn(-dlw, __fmul_rn(x, x)), 2.0f * scale);
    }
    const int t = grp * 32 + lane;  // the sample's place in the block
#pragma unroll
    for (int i = 0; i <= D; ++i) red[(l * (D + 1) + i) * per_block + t] = dp[i];
    __syncthreads();
    // one thread a sample sums its levels in level order and writes once
    const int64_t s0 = (int64_t)blockIdx.x * per_block + threadIdx.x;
    if (threadIdx.x < per_block && s0 < n) {
#pragma unroll
      for (int i = 0; i <= D; ++i) {
        float sum = red[i * per_block + threadIdx.x];
        for (int k = 1; k < n_levels; ++k) sum = __fadd_rn(sum, red[(k * (D + 1) + i) * per_block + threadIdx.x]);
        if (i < D && dpos != nullptr) dpos[s0 * D + i] = sum;
        if (i == D && dstd != nullptr) dstd[s0] = sum;
      }
    }
  }
}

template <int D, int F, bool BF16, bool CELL>
cudaError_t launch_bwd_kernel(const float* positions, const float* stds, const float* g, const Levels& lv,
                              const LevelGrads& gr, int n_levels, int64_t n, float* dpos, float* dstd,
                              cudaStream_t stream) {
  const int groups = n_levels <= BWD_WARPS ? BWD_WARPS / n_levels : 1;
  const int per_block = 32 * groups, threads = per_block * n_levels, warps = threads / 32;
  constexpr int SW = (1 << D) * F + 4;
  const size_t smem = ((size_t)warps * (32 * SW + 64) + (size_t)n_levels * (D + 1) * per_block) * sizeof(float);
  auto kernel = hash_grid_bwd_kernel<D, F, BF16, CELL>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  kernel<<<blocks, threads, smem, stream>>>(positions, stds, g, lv, gr, n_levels, groups, n, dpos, dstd);
  return cudaGetLastError();
}

template <int D, int F>
cudaError_t launch_bwd(const float* positions, const float* stds, const float* g, const Levels& lv,
                       const LevelGrads& gr, int n_levels, int64_t n, float* dpos, float* dstd, bool bf16,
                       bool cell, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  if (bf16 && cell)
    return launch_bwd_kernel<D, F, true, true>(positions, stds, g, lv, gr, n_levels, n, dpos, dstd, stream);
  if (bf16) return launch_bwd_kernel<D, F, true, false>(positions, stds, g, lv, gr, n_levels, n, dpos, dstd, stream);
  if (cell) return launch_bwd_kernel<D, F, false, true>(positions, stds, g, lv, gr, n_levels, n, dpos, dstd, stream);
  return launch_bwd_kernel<D, F, false, false>(positions, stds, g, lv, gr, n_levels, n, dpos, dstd, stream);
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

// The lookup's backward. positions, stds, tables, buckets, dense_res, scales,
// n, n_levels, d, f, read_bf16, cell_packed: as hash_grid_fwd; g [n, n_levels
// * f] fp32, the output's gradient; dtables: host array of n_levels device
// pointers to zero-filled fp32 gradients of the tables' shapes, or null
// entries (no gradient for that level); dpos [n, d] and dstd [n] fp32 or null
// (written, not added to). Cell-packed tables and their gradients start on a
// 16-byte boundary (their rows are read and added as float4s). Returns the
// launch's cudaError_t, or -1 for arguments no kernel was built for.
extern "C" int hash_grid_bwd(const float* positions, const float* stds, const void* const* tables, const int* buckets,
                             const int* dense_res, const float* scales, const float* g, void* const* dtables,
                             float* dpos, float* dstd, long long n, int n_levels, int d, int f, int read_bf16,
                             int cell_packed, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || n < 0) return -1;
  if (dstd != nullptr && stds == nullptr) return -1;
  if ((n + 31) / 32 > 2147483647LL) return -1;
  Levels lv;
  LevelGrads gr;
  for (int l = 0; l < n_levels; ++l) {
    lv.table[l] = static_cast<const float*>(tables[l]);
    lv.buckets[l] = (uint32_t)buckets[l];
    lv.dense_res[l] = dense_res[l];
    lv.scale[l] = scales[l];
    gr.dtable[l] = static_cast<float*>(dtables[l]);
    if (buckets[l] < 1) return -1;
    if (cell_packed && (((uintptr_t)tables[l] | (uintptr_t)dtables[l]) & 15) != 0) return -1;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool b = read_bf16 != 0, c = cell_packed != 0;
  cudaError_t err;
  if (d == 3 && f == 1) err = launch_bwd<3, 1>(positions, stds, g, lv, gr, n_levels, n, dpos, dstd, b, c, st);
  else if (d == 3 && f == 2) err = launch_bwd<3, 2>(positions, stds, g, lv, gr, n_levels, n, dpos, dstd, b, c, st);
  else if (d == 3 && f == 4) err = launch_bwd<3, 4>(positions, stds, g, lv, gr, n_levels, n, dpos, dstd, b, c, st);
  else if (d == 4 && f == 1) err = launch_bwd<4, 1>(positions, stds, g, lv, gr, n_levels, n, dpos, dstd, b, c, st);
  else if (d == 4 && f == 2) err = launch_bwd<4, 2>(positions, stds, g, lv, gr, n_levels, n, dpos, dstd, b, c, st);
  else if (d == 4 && f == 4) err = launch_bwd<4, 4>(positions, stds, g, lv, gr, n_levels, n, dpos, dstd, b, c, st);
  else return -1;
  return (int)err;
}
