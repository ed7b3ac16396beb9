// Fused multi-resolution hash-grid lookup for Hopper (sm_90a), forward and
// backward: per sample and level, cell index (dense or hashed) -> table row(s)
// -> D-linear interpolation in the read type -> level weight, and the table,
// position and std gradients of the same function.
//
// Replaces the hand-written hot operator of neurad_tpu/ops/hash_encoding.py:
//   hash_grid_fwd <- _interp_gather_cp_impl (K1f; cell-packed rows: row fetch,
//                    bucket select, interpolation), and the same family for the
//                    other layouts: _gather_levels_multi_impl (one row per
//                    corner) and _gather_levels_impl (one array for all levels),
//                    together with the index and weight code of hash_encode
//                    around them (scale, floor, _hash / _dense_index, bucket //
//                    pk, corner weights) and gaussian_level_weights.
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
// [rows, pk * row_width] with pk logical buckets per physical row; its
// row-major memory is also [rows * pk, row_width], so the logical bucket
// addresses its row directly and bucket // pk, bucket % pk never appear.
// CELL = true: row_width = 2^D * F, one row holds a cell's 2^D corner features
// and the cell's floor coordinate is indexed. CELL = false: row_width = F and
// each corner (floor + offset) is indexed on its own. A single array holding
// all levels one after the other is passed as L base pointers into it. The
// table gradient has the table's layout and is addressed by the same rule (the
// JAX backward scatters into the same unpacked [rows * pk, row_width] view).
// The forward reads the fp32 master tables, or (with bf16 reads) a bf16 copy
// of them that the tables' owner keeps (a serving state's hash grids): the
// master rounded to bf16 once, round to nearest even, which is what every read
// of the master rounds to.
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
//  * BF16 = true: a table value is rounded to bf16 (in the copy, or at the read
//    of the fp32 master: the same bits), the weights are rounded to bf16, and
//    each product and each of the 2^D - 1 additions, corners in order 0 ..
//    2^D - 1, is rounded to bf16. A product of two bf16 values is exact in fp32
//    and an fp32 sum rounded to bf16 equals the bf16 sum (24 >= 2 * 8 + 2 bits),
//    so fp32 _rn intrinsics followed by a rounding reproduce bf16 arithmetic,
//    and so do bf16 _rn intrinsics; nvcc cannot fuse either;
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
//    (re-read here from the fp32 master: the autograd function saves only its
//    inputs), folded into
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
// values (128 B at D = 3, F = 4 in fp32, 64 B in bf16) and writes F fp32; the
// arithmetic is about 100 operations. At the full width of the NeuRAD field
// (N = 1,048,576 samples a chunk, L = 8) its least traffic is the distinct
// rows it touches, read once (on uniform positions about 3 M of the 8.4 M row
// reads; a chunk's ray-ordered samples fall into far fewer at the coarse
// levels), plus 12.6 MB of positions, 4.2 MB of stds and 134 MB of output.
// The backward's least traffic is its inputs read once (positions, stds, g,
// and the rows a position gradient needs) and the table gradient written
// once: with the gradient dense over the table, the whole table's bytes (432
// MiB at the `neurad` preset) bound it, however few rows a launch touches.
//
// What the designs do about it. Both kernels map a warp to one level of 32
// consecutive samples (a block of 256 threads is 8 levels x 32 samples; 4
// levels: two groups of 32). A chunk is ray-major with 32 samples a ray, so a
// warp is usually one ray at one level, and at the coarse levels most of its
// lanes share a few cells.
//
// The forward (K1f). An earlier version ran one thread per (sample, level),
// levels fastest, each fetching its own 128-byte row as 2^D float4 loads: no
// two lanes of an instruction shared a row, a ray's repeated coarse cells were
// fetched again by every lane, and each instruction touched 32 lines 16 bytes
// apiece. Now:
//  * the warp groups its lanes by equal bucket (__match_any_sync) and fetches
//    each distinct cell-packed row once, as one coalesced read: 16 bytes a lane,
//    the row's 16-byte pieces on consecutive lanes, 32 / pieces rows an
//    instruction, into a staging slot of shared memory (32 slots of 2^D * F + 4
//    fp32 a warp: float4-aligned, a quarter warp's float4s in distinct banks),
//    converted to fp32 (rounded to bf16 with bf16 reads of the master); every
//    lane then takes its cell's corners from its row's slot;
//  * bf16 reads of a serving state come from the bf16 copy: rows of 64 bytes at
//    D = 3, F = 4, half the bytes of the hashed levels, and the dense levels
//    (4.6 and 45.8 MB in fp32) fit the 50 MB L2 together;
//  * the fetch loop is unrolled over a fixed count with predicated loads, so
//    up to four loads a lane are in flight before the first store to the
//    staging (a loop over the run-time row count waited for each in turn);
//  * bf16 reads interpolate in packed bf16 arithmetic, two features an
//    instruction (__hmul2_rn, __hadd2_rn: one rounding of the exact result,
//    the bits of fp32 arithmetic rounded after each operation), from staging
//    slots that hold bf16 pairs; in fp32 with a rounding after each
//    operation, the 68 roundings a sample-level (D = 3, F = 4) went through
//    the card's conversion units at an eighth of the fp32 rate. One feature
//    a level keeps the fp32 form, its roundings in packed pairs;
//  * the block writes its samples' [L * F] output rows through shared memory
//    as whole, coalesced rows (the warp's own F values per sample lie L * F
//    floats apart), with streaming stores that leave the L2 to the tables;
//  * the unpacked layout (one row a corner) keeps the structure corner by
//    corner: each lane loads its corner's row of F values; lanes of an
//    instruction on the same row are served by one request.
//
// The backward (K1b) meets what the forward does not: a scatter whose rows are
// hot. The coarse dense levels put most samples of a ray into a few cells (at
// the `neurad` preset a train chunk's 2.1 M sample-levels fall into 736,018
// distinct rows), and one thread per (sample, level) sent 2^D float4 atomics
// one after another into its 128-byte row: no two lanes of a warp coalesced,
// and no two updates of a hot cell met before L2. So:
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
//  * the unpacked layout keeps the structure corner by corner: the lanes whose
//    corner c lands on one row are grouped, one vector atomic of F floats a
//    distinct row, and each lane reads its own corner rows (F floats each,
//    through L1).
// In both, per-corner values live in shared memory or in fully unrolled loops
// over template parameters, so no instantiation keeps a local-memory frame
// (the ptxas report in _build/hash_grid.log).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int WARPS = 8;                      // a block's warps where L <= 8 (L warps where L > 8)
constexpr int MAX_THREADS = 32 * MAX_LEVELS;  // L = 16: one warp a level

struct Levels {
  const float* table[MAX_LEVELS];  // fp32 master, or (bf16 reads from the copy) its bf16 copy
  uint32_t buckets[MAX_LEVELS];    // logical buckets (rows * pk): the hash's modulus
  int dense_res[MAX_LEVELS];       // 0: hashed level
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

// The two bf16 values of a 32-bit word (element 0 in the low half) as fp32: exact.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Round the N values of v to bf16 in place (nearest even): two at a time with
// one packed conversion, an odd last one alone. The same bits as round_bf16
// on each; the packed conversion issues half as many of the card's
// conversions, whose rate (16 a clock an SM) is an eighth of fp32's.
template <int N>
__device__ __forceinline__ void round_bf16_all(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i + 1 < N; i += 2) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[i], v[i + 1]);
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&p);
    v[i] = bf16_lo(u);
    v[i + 1] = bf16_hi(u);
  }
  if (N & 1) v[N - 1] = round_bf16(v[N - 1]);
}

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

// The cell and in-cell offsets of a position at one level's scale.
template <int D>
__device__ __forceinline__ void cell_of(const float* __restrict__ positions, int64_t s, bool active, float scale,
                                        int (&cell)[D], float (&off)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float scaled = __fmul_rn(active ? __ldg(positions + s * D + i) : 0.0f, scale);
    const float fl = floorf(scaled);
    off[i] = __fsub_rn(scaled, fl);
    cell[i] = (int)fl;
  }
}

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

// ---------------------------------------------------------------------------
// forward (K1f)
// ---------------------------------------------------------------------------

// The weights of corners c and c + 1, rounded to bf16 with bf16 reads (one
// packed conversion: two at a time keeps few of them live).
template <int D, bool BF16>
__device__ __forceinline__ void corner_pair_weights(const float (&off)[D], int c, float (&w)[2]) {
  w[0] = corner_weight<D, false>(off, c);
  w[1] = corner_weight<D, false>(off, c + 1);
  if (BF16) round_bf16_all(w);
}

// Corner c's features v (in the read type) into the interpolated sum with the
// corner's weight w, corners in order 0 .. 2^D - 1 (each product and partial
// sum rounded to bf16 with bf16 reads, in packed pairs).
template <int F, bool BF16>
__device__ __forceinline__ void add_corner(int c, const float (&v)[F], float w, float (&acc)[F]) {
  float term[F];
#pragma unroll
  for (int j = 0; j < F; ++j) term[j] = __fmul_rn(v[j], w);
  if (BF16) round_bf16_all(term);
#pragma unroll
  for (int j = 0; j < F; ++j) acc[j] = c == 0 ? term[j] : __fadd_rn(acc[j], term[j]);
  if (BF16 && c > 0) round_bf16_all(acc);
}

// Two bf16 values (element 0 in the low half) in one 32-bit word, and back.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ __nv_bfloat162 as_bf16x2(uint32_t w) { return *reinterpret_cast<const __nv_bfloat162*>(&w); }

// add_corner in packed bf16 arithmetic, two features an instruction: v holds
// the corner's F features as F / 2 bf16 pairs, w2 its weight in both halves.
// A bf16 product or sum rounds the exact result once (round to nearest even);
// the fp32 product of two bf16 values is exact and the fp32 sum rounded to
// bf16 equals the bf16 sum (24 >= 2 * 8 + 2 bits), so these are the bits of
// add_corner, without a conversion. The _rn forms keep ptxas from fusing a
// product and a sum into one rounding (as plain mul/add may be).
template <int F>
__device__ __forceinline__ void add_corner_bf16x2(int c, const uint32_t (&v)[F / 2], __nv_bfloat162 w2,
                                                  __nv_bfloat162 (&acc)[F / 2]) {
#pragma unroll
  for (int i = 0; i < F / 2; ++i) {
    const __nv_bfloat162 term = __hmul2_rn(as_bf16x2(v[i]), w2);
    acc[i] = c == 0 ? term : __hadd2_rn(acc[i], term);
  }
}

// Level l's table, bucket count, dense resolution and scale, read from the
// kernel's parameter arrays with constant indices only (indexed at run time,
// ptxas copies a parameter array into a local-memory frame).
struct LevelParams {
  const float* table;
  uint32_t buckets;
  int res;
  float scale;
};

__device__ __forceinline__ LevelParams level_params(const Levels& lv, int l) {
  LevelParams r{lv.table[0], lv.buckets[0], lv.dense_res[0], lv.scale[0]};
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i) {
    if (l == i) r = LevelParams{lv.table[i], lv.buckets[i], lv.dense_res[i], lv.scale[i]};
  }
  return r;
}

// A 16-byte piece of a cell-packed row: 4 fp32 or 8 bf16 values.
template <typename T>
using Piece = typename std::conditional<std::is_same<T, float>::value, float4, uint4>::type;

// Piece v of a row, loaded into registers, stored into the row's staging slot
// `dst`: as bf16 pairs (PACKED: the fp32 master rounded in pairs, the bf16
// copy's words as they are), else as fp32 (rounded to bf16 with bf16 reads;
// the copy's values are exact in fp32).
template <bool BF16, bool PACKED>
__device__ __forceinline__ void store_piece(float4 t, int v, float* dst) {
  if constexpr (PACKED) {
    *reinterpret_cast<uint2*>(dst + v * 2) = make_uint2(pack_bf16x2(t.x, t.y), pack_bf16x2(t.z, t.w));
  } else {
    float x[4] = {t.x, t.y, t.z, t.w};
    if (BF16) round_bf16_all(x);
    *reinterpret_cast<float4*>(dst + v * 4) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

template <bool BF16, bool PACKED>
__device__ __forceinline__ void store_piece(uint4 t, int v, float* dst) {
  if constexpr (PACKED) {
    *reinterpret_cast<uint2*>(dst + v * 4) = make_uint2(t.x, t.y);
    *reinterpret_cast<uint2*>(dst + v * 4 + 2) = make_uint2(t.z, t.w);
  } else {  // one feature a level: interpolated in fp32 with roundings, from the copy's exact values
    *reinterpret_cast<float4*>(dst + v * 8) = make_float4(bf16_lo(t.x), bf16_hi(t.x), bf16_lo(t.y), bf16_hi(t.y));
    *reinterpret_cast<float4*>(dst + v * 8 + 4) = make_float4(bf16_lo(t.z), bf16_hi(t.z), bf16_lo(t.w), bf16_hi(t.w));
  }
}

// The F values of one unpacked row (one corner) as fp32, rounded to bf16 with
// bf16 reads of the fp32 master.
template <int F, bool BF16, typename T>
__device__ __forceinline__ void load_corner(const T* __restrict__ p, float (&v)[F]) {
  if constexpr (std::is_same<T, float>::value) {
    Row<F> r;
    r.load(p);
#pragma unroll
    for (int j = 0; j < F; ++j) v[j] = r.v[j];
    if (BF16) round_bf16_all(v);
  } else if constexpr (F == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = bf16_lo(t.x);
    v[1] = bf16_hi(t.x);
    v[2] = bf16_lo(t.y);
    v[3] = bf16_hi(t.y);
  } else if constexpr (F == 2) {
    const uint32_t t = __ldg(reinterpret_cast<const unsigned int*>(p));
    v[0] = bf16_lo(t);
    v[1] = bf16_hi(t);
  } else {
    v[0] = bf16_lo((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
}

// The F features of one unpacked row as F / 2 bf16 pairs (bf16 reads).
template <int F, typename T>
__device__ __forceinline__ void load_corner_bf16x2(const T* __restrict__ p, uint32_t (&v)[F / 2]) {
  if constexpr (std::is_same<T, float>::value) {
    float x[F];
    load_corner<F, false>(p, x);
#pragma unroll
    for (int i = 0; i < F / 2; ++i) v[i] = pack_bf16x2(x[2 * i], x[2 * i + 1]);
  } else if constexpr (F == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// Shared memory of a forward block, in floats: the output rows of its samples
// (stride: L * F rounded up to a float4, plus one float4), then, for the cell-packed
// layout, each warp's 32 staging slots and its bucket and peer lists.
__host__ __device__ constexpr int fwd_out_stride(int n_levels, int f) { return (n_levels * f + 3) / 4 * 4 + 4; }

// A staging slot, in 4-byte words: a cell-packed row in fp32 plus one float4,
// or (packed bf16 reads) in bf16 pairs plus two words (8-byte aligned; a
// half warp's 8-byte reads of distinct rows fall in distinct banks).
__host__ __device__ constexpr int fwd_slot_words(int d, int f, bool packed) {
  return packed ? (1 << d) * f / 2 + 2 : (1 << d) * f + 4;
}

template <int D, int F, bool CELL, bool PACKED>
__host__ __device__ constexpr int fwd_smem_floats(int warps, int per_block, int n_levels) {
  return per_block * fwd_out_stride(n_levels, F) + (CELL ? warps * (32 * fwd_slot_words(D, F, PACKED) + 64) : 0);
}

// (The bound's blocks an SM set ptxas's register budget: left to pick its
// own, it held some instantiations at 40 or 64 registers and spilled.)
template <int D, int F, bool BF16, bool CELL, typename T>
__global__ void __launch_bounds__(MAX_THREADS, D == 3 && CELL ? 3 : 2) hash_grid_fwd_kernel(
    const float* __restrict__ positions, const float* __restrict__ stds, Levels lv, int n_levels, int groups, int64_t n,
    float* __restrict__ out) {
  constexpr int C = 1 << D;
  constexpr int W = C * F;                      // values of a cell-packed row
  constexpr bool PACKED = BF16 && F % 2 == 0;   // bf16 reads interpolate in bf16 pairs
  constexpr int SW = fwd_slot_words(D, F, PACKED);  // staging stride, in words
  constexpr int NP = W * (int)sizeof(T) / 16;   // 16-byte pieces of a cell-packed row: NP lanes share a row
  constexpr int RPI = 32 / NP;                  // rows one fetch instruction covers
  static_assert(NP >= 1 && NP <= 32, "a cell-packed row is 16 to 512 bytes");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l = warp % n_levels, grp = warp / n_levels;  // the warps of a sample group are its levels
  const int per_block = groups * 32;
  const int ow = n_levels * F;  // floats of a sample's output row
  const int os = fwd_out_stride(n_levels, F);
  float* ostage = smem;  // [per_block][os]
  const int64_t s0 = (int64_t)blockIdx.x * per_block;
  const int64_t s = s0 + grp * 32 + lane;
  const bool active = s < n;
  const LevelParams lev = level_params(lv, l);
  const T* table = reinterpret_cast<const T*>(lev.table);

  int cell[D];
  float off[D];
  cell_of<D>(positions, s, active, lev.scale, cell, off);

  float acc[F];
  if constexpr (CELL) {
    float* stage = smem + per_block * os + warp * (32 * SW);  // 32 slots of SW floats
    unsigned* peers_sh = reinterpret_cast<unsigned*>(smem + per_block * os + warps * (32 * SW)) + warp * 64;
    uint32_t* row_sh = peers_sh + 32;
    const RowGroup rg = group_rows(bucket_of<D>(cell, lev.buckets, lev.res), active, lane, peers_sh, row_sh);
    __syncwarp();
    // each distinct row read once, coalesced, into the staging slot of its rank: lane / NP is the lane's row in
    // a fetch instruction, lane % NP its piece; up to 4 loads a lane are in flight before the first store
    constexpr int BATCH = NP < 4 ? NP : 4;
#pragma unroll
    for (int b0 = 0; b0 < NP; b0 += BATCH) {
      if (b0 * RPI >= rg.n_rows) break;
      Piece<T> piece[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int ri = (b0 + i) * RPI + lane / NP;
        if (ri < rg.n_rows) piece[i] = __ldg(reinterpret_cast<const Piece<T>*>(table + (size_t)row_sh[ri] * W) + lane % NP);
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int ri = (b0 + i) * RPI + lane / NP;
        if (ri < rg.n_rows) store_piece<BF16, PACKED>(piece[i], lane % NP, stage + ri * SW);
      }
    }
    __syncwarp();
    const float* row = stage + rg.rank * SW;
    if constexpr (PACKED) {
      __nv_bfloat162 acc2[F / 2];
#pragma unroll
      for (int c = 0; c < C; c += 2) {
        const __nv_bfloat162 w2 = __floats2bfloat162_rn(corner_weight<D, false>(off, c),
                                                        corner_weight<D, false>(off, c + 1));
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          uint32_t v[F / 2];
          const uint32_t* words = reinterpret_cast<const uint32_t*>(row) + (c + k) * (F / 2);
          if constexpr (F == 4) {
            const uint2 t = *reinterpret_cast<const uint2*>(words);
            v[0] = t.x;
            v[1] = t.y;
          } else {
            v[0] = words[0];
          }
          add_corner_bf16x2<F>(c + k, v, k == 0 ? __low2bfloat162(w2) : __high2bfloat162(w2), acc2);
        }
      }
#pragma unroll
      for (int i = 0; i < F / 2; ++i) {
        acc[2 * i] = __low2float(acc2[i]);
        acc[2 * i + 1] = __high2float(acc2[i]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; c += 2) {
        float w[2];
        corner_pair_weights<D, BF16>(off, c, w);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float v[F];
          lds_vec<F>(row + (c + k) * F, v);
          add_corner<F, BF16>(c + k, v, w[k], acc);
        }
      }
    }
  } else if constexpr (PACKED) {
    // one row a corner, loaded by its lane
    __nv_bfloat162 acc2[F / 2];
#pragma unroll
    for (int c = 0; c < C; c += 2) {
      const __nv_bfloat162 w2 = __floats2bfloat162_rn(corner_weight<D, false>(off, c),
                                                      corner_weight<D, false>(off, c + 1));
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        int corner[D];
#pragma unroll
        for (int i = 0; i < D; ++i) corner[i] = cell[i] + (((c + k) >> i) & 1);
        uint32_t v[F / 2];
        load_corner_bf16x2<F>(table + (size_t)bucket_of<D>(corner, lev.buckets, lev.res) * F, v);
        add_corner_bf16x2<F>(c + k, v, k == 0 ? __low2bfloat162(w2) : __high2bfloat162(w2), acc2);
      }
    }
#pragma unroll
    for (int i = 0; i < F / 2; ++i) {
      acc[2 * i] = __low2float(acc2[i]);
      acc[2 * i + 1] = __high2float(acc2[i]);
    }
  } else {
    // one row a corner, loaded by its lane
#pragma unroll
    for (int c = 0; c < C; c += 2) {
      float w[2];
      corner_pair_weights<D, BF16>(off, c, w);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        int corner[D];
#pragma unroll
        for (int i = 0; i < D; ++i) corner[i] = cell[i] + (((c + k) >> i) & 1);
        float v[F];
        load_corner<F, BF16>(table + (size_t)bucket_of<D>(corner, lev.buckets, lev.res) * F, v);
        add_corner<F, BF16>(c + k, v, w[k], acc);
      }
    }
  }

  if (active) {
    if (stds != nullptr) {
      const float lw = __frcp_rn(fmaxf(__fmul_rn(__ldg(stds + s), 2.0f * lev.scale), 1.0f));
#pragma unroll
      for (int j = 0; j < F; ++j) acc[j] = __fmul_rn(acc[j], lw);
    }
    sts_vec<F>(ostage + (grp * 32 + lane) * os + l * F, acc);
  }
  __syncthreads();
  // the block's output rows, whole and coalesced
  const int rows = (int)min((int64_t)per_block, n - s0);
  float* dst = out + s0 * ow;
  if ((ow & 3) == 0) {
    const int q = ow >> 2;  // float4s a row
    for (int e = threadIdx.x; e < rows * q; e += blockDim.x) {
      const int r = e / q, col = (e - r * q) * 4;
      __stcs(reinterpret_cast<float4*>(dst + r * ow + col), *reinterpret_cast<const float4*>(ostage + r * os + col));
    }
  } else {
    for (int e = threadIdx.x; e < rows * ow; e += blockDim.x) {
      const int r = e / ow;
      __stcs(dst + e, ostage[r * os + e - r * ow]);
    }
  }
}

template <int D, int F, bool BF16, bool CELL, typename T>
cudaError_t launch_fwd_kernel(const float* positions, const float* stds, const Levels& lv, int n_levels, int64_t n,
                              float* out, cudaStream_t stream) {
  const int groups = n_levels <= WARPS ? WARPS / n_levels : 1;
  const int per_block = 32 * groups, threads = per_block * n_levels, warps = threads / 32;
  const size_t smem = (size_t)fwd_smem_floats<D, F, CELL, BF16 && F % 2 == 0>(warps, per_block, n_levels) *
                      sizeof(float);
  auto kernel = hash_grid_fwd_kernel<D, F, BF16, CELL, T>;
  static size_t smem_allowed = 48 * 1024;  // raised once a size needs it (not again inside a graph capture)
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  kernel<<<blocks, threads, smem, stream>>>(positions, stds, lv, n_levels, groups, n, out);
  return cudaGetLastError();
}

// Read modes: fp32 reads of the master, bf16 reads of the master (rounded at
// the read), bf16 reads of the bf16 copy.
template <int D, int F>
cudaError_t launch_fwd(const float* positions, const float* stds, const Levels& lv, int n_levels, int64_t n,
                       float* out, bool bf16, bool bf16_copy, bool cell, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  if (bf16_copy && cell)
    return launch_fwd_kernel<D, F, true, true, __nv_bfloat16>(positions, stds, lv, n_levels, n, out, stream);
  if (bf16_copy) return launch_fwd_kernel<D, F, true, false, __nv_bfloat16>(positions, stds, lv, n_levels, n, out, stream);
  if (bf16 && cell) return launch_fwd_kernel<D, F, true, true, float>(positions, stds, lv, n_levels, n, out, stream);
  if (bf16) return launch_fwd_kernel<D, F, true, false, float>(positions, stds, lv, n_levels, n, out, stream);
  if (cell) return launch_fwd_kernel<D, F, false, true, float>(positions, stds, lv, n_levels, n, out, stream);
  return launch_fwd_kernel<D, F, false, false, float>(positions, stds, lv, n_levels, n, out, stream);
}

// ---------------------------------------------------------------------------
// backward (K1b)
// ---------------------------------------------------------------------------

struct LevelGrads {
  float* dtable[MAX_LEVELS];  // null: the level's table needs no gradient
};

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
  add_corner<F, BF16>(c, v, corner_weight<D, BF16>(off, c), o);
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

// Level l's table gradient, read like level_params (indexed at run time, ptxas
// copied the gradients' pointer array into a 128-byte local-memory frame).
__device__ __forceinline__ float* dtable_of(const LevelGrads& gr, int l) {
  float* r = gr.dtable[0];
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i) {
    if (l == i) r = gr.dtable[i];
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
__global__ void __launch_bounds__(MAX_THREADS) hash_grid_bwd_kernel(
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
  const LevelParams lev = level_params(lv, l);
  float* dtable = dtable_of(gr, l);

  // the forward's cell, offsets and level weight, and g' = g * level weight
  const float scale = lev.scale;
  int cell[D];
  float off[D];
  cell_of<D>(positions, s, active, scale, cell, off);
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
  const int groups = n_levels <= WARPS ? WARPS / n_levels : 1;
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
// scale); out [n, n_levels * f] fp32. tables_bf16: the tables are bf16 copies
// of the fp32 masters (read_bf16 must be set). Cell-packed tables start on a
// 16-byte boundary (their rows are read in 16-byte pieces). Returns the
// launch's cudaError_t, or -1 for arguments no kernel was built for.
extern "C" int hash_grid_fwd(const float* positions, const float* stds, const void* const* tables, const int* buckets,
                             const int* dense_res, const float* scales, float* out, long long n, int n_levels, int d,
                             int f, int read_bf16, int cell_packed, int tables_bf16, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || n < 0) return -1;
  if (tables_bf16 && !read_bf16) return -1;
  if ((n + 31) / 32 > 2147483647LL) return -1;
  Levels lv;
  for (int l = 0; l < n_levels; ++l) {
    lv.table[l] = static_cast<const float*>(tables[l]);
    lv.buckets[l] = (uint32_t)buckets[l];
    lv.dense_res[l] = dense_res[l];
    lv.scale[l] = scales[l];
    if (buckets[l] < 1) return -1;
    if (cell_packed && ((uintptr_t)tables[l] & 15) != 0) return -1;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool b = read_bf16 != 0, cp = tables_bf16 != 0, c = cell_packed != 0;
  cudaError_t err;
  if (d == 3 && f == 1) err = launch_fwd<3, 1>(positions, stds, lv, n_levels, n, out, b, cp, c, st);
  else if (d == 3 && f == 2) err = launch_fwd<3, 2>(positions, stds, lv, n_levels, n, out, b, cp, c, st);
  else if (d == 3 && f == 4) err = launch_fwd<3, 4>(positions, stds, lv, n_levels, n, out, b, cp, c, st);
  else if (d == 4 && f == 1) err = launch_fwd<4, 1>(positions, stds, lv, n_levels, n, out, b, cp, c, st);
  else if (d == 4 && f == 2) err = launch_fwd<4, 2>(positions, stds, lv, n_levels, n, out, b, cp, c, st);
  else if (d == 4 && f == 4) err = launch_fwd<4, 4>(positions, stds, lv, n_levels, n, out, b, cp, c, st);
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
