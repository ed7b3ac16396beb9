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
//    sectors they touch and stores are coalesced. Measured by device time (a
//    CUDA graph of calls) at 71% of its bytes bound at N = 2^20, T = 131072,
//    F = 32 on an H100 (NVIDIA H100 80GB HBM3, 700 W), it is left as it was.
//  * P5 (one query at a time): one thread owns one query's whole row, as the
//    TPU kernel's scalar loop copies one row at a time. The first form (a
//    thread copying its row piece by piece straight to its output row) reached
//    38% of the bound: a warp's store touched 32 rows 64 bytes apart, half a
//    sector each; the piece loop had a run-time count, so a row's loads did not
//    all issue before its stores; and the 64 MB output stream, larger than the
//    50 MB L2, pushed the table out of L2, so rows came again from device
//    memory. Now (`gather_serial_kernel<CHUNK>`): a persistent grid of 6 blocks
//    an SM (4 for 8-piece rows) walks blocks of 256 queries; a thread loads its
//    query's index (the owners of neighbouring queries load neighbouring
//    indices: one coalesced load a warp, so no staging is needed for them),
//    issues all CHUNK 16-byte loads of its row at once (CHUNK = F / 8 up to 8,
//    a template, unrolled) with an L2 evict-last cache policy, so the table
//    stays in L2 as the TPU probe keeps it in VMEM, and copies them into the
//    block's stage in shared memory (rotated by row: no bank conflicts); the
//    block then writes its [256, F] output tile whole, neighbouring threads on
//    neighbouring 16-byte pieces, with streaming evict-first stores (st.cs),
//    so the output does not displace the table.
//  * P2 and P3 (the matrix unit): a one-hot product on the tensor cores, bf16
//    inputs and fp32 sums (mma.sync m16n8k16), as the TPU kernels multiply a
//    one-hot block with the table (P2) or its transpose with the updates (P3).
//    The TPU kernels multiply every block of queries with every block of the
//    table, 2 * N * T * F operations, because the TPU has no cheap sort and its
//    matrix unit is idle anyway. Here a counting sort of the indices by row
//    range comes first, and each range of R = 128 rows is multiplied only with
//    the queries (or updates) that name it: 2 * N * R * F operations. The
//    products over rows that no query names, all zero, are what is left out.
//    - The bucketing pass (shared with P4, three launches): `bucket_count_kernel`
//      counts each block's chunk of indices per bucket (idx / R) with shared
//      atomics and writes its column of a [buckets x blocks] table;
//      `bucket_scan_kernel` scans the table in bucket-major order, a tile a
//      block, the tiles' sums meeting through scratch (at most 64 blocks, all
//      resident), so each (bucket, block) pair gets its first slot;
//      `bucket_place_kernel` counts again per warp, gives each (bucket, warp)
//      its first slot, and walks its indices again in order
//      (__match_any_sync, the popcount of the lower lanes of the same bucket,
//      a running counter per warp and bucket). It writes perm[slot] = update
//      << 7 | row within the bucket. Within a bucket the order is the
//      indices' own order, so both products are deterministic.
//      `bucket_place_kernel` is the slowest of the three: it reads its indices
//      twice and writes the permutation in scattered 4-byte pieces.
//    - P2 (`gather_onehot_kernel`): a block stages its bucket's R table rows
//      in shared memory once with cp.async (zeros past the table's end). Its
//      warps take the bucket's queries 16 at a time, build the one-hot A
//      fragment in registers (a lane knows which (query, row) elements of the
//      fragment it holds), multiply over the R/16 row tiles with B fragments
//      read by ldmatrix, and write each fp32 row to out[update]. The sum has
//      one non-zero term, so the result equals the bf16 row exactly. A small
//      table (fewer buckets than 4 blocks an SM) splits each bucket's queries
//      over up to 8 blocks.
//    - P3 (`scatter_onehot_kernel`): a block owns its bucket's R output rows,
//      a warp 16 of them. It stages the bucket's updates CH at a time with
//      cp.async (their permutation entries two chunks ahead, their fp32 g rows
//      one chunk ahead in two buffers), rounds them to bf16 as the TPU kernel
//      does, and per 16 updates each warp builds onehot^T [16 rows x 16
//      updates] in registers and multiplies. A chunk's products start from
//      zero and are added to fp32 accumulators in registers with
//      round-to-nearest adds, so a hot row's long sum does not take the
//      tensor core's own rounding at every step. Every output row is written
//      once, zeros included, by its one owner: no atomics, and two launches on
//      the same inputs give the same bits. A bucket's updates are walked by
//      one block, so a hot bucket is right and slow, and a small table (128
//      buckets at T = 16384) leaves each block a long serial walk.
//  * P4 (a resident accumulator, fed only its own updates): the bucketing
//    pass above, then `scatter_blocked_kernel`. A persistent grid walks the
//    permutation in spans of SPAN = 1024 entries, split by position, not by
//    bucket, so a hot bucket, a one-row input or a small table is spread over
//    the card. Inside a span, bucket by bucket: a block zeroes an R x F fp32
//    accumulator in shared memory (4-16 KB), its warps add the span's entries
//    of that bucket with shared-memory atomics (F/4 lanes an update, a float4
//    of g each, 32/(F/4) updates a warp step; every entry is a hit), then
//    flush the bucket's non-zero rows. A span finds each bucket it enters by
//    re-reading idx[update] of the bucket's first entry there (two dependent
//    4-byte reads, then its start and end in the offsets table), not by a
//    binary search over the buckets' starts (log2 of the buckets, up to 16
//    dependent reads), and skips empty buckets for free. A bucket that lies
//    wholly inside one span has one owner and is stored with plain float4
//    stores; the parts of a bucket cut by a span's edge meet through vector
//    global reductions (red.global.add.v4.f32) into the output, which the
//    call zero-fills first. A flushed row had at least one update in its
//    segment, so the flush never moves more than the updates' own bytes.
//    Shared fp32 atomicAdd is a compare-and-swap loop on this card (SASS
//    ATOMS.CAST.SPIN), which serialises lanes that meet on one address: each
//    group of lanes keeps a running float4 while its entries name the same
//    row (a hot row's run) and adds it when the row changes, and the four
//    scalar adds of a float4 start at a column rotated by the group, so the
//    groups of a warp step meet distinct banks. Results are fp32 sums in an
//    order that changes from launch to launch (atomics), as index_add_'s do.
//  * P6 (one update at a time): F/4 neighbouring lanes own one update; each
//    loads 16 bytes of its g row and adds them with one vector reduction
//    (red.global.add.v4.f32, SASS REDG.E.ADD.F32x4): a 128-byte row is one
//    coalesced group of 8 reductions, 32/(F/4) updates a warp step. Nothing
//    combines updates. F is a multiple of 4, g and out 16-byte aligned.
//
// What bounds them. The functions are a gather and a scatter-add whatever the
// mechanism. A gather reads the indices and the rows they name once and writes
// the result once; a scatter-add reads the indices and the updates once and
// writes the output once (N * 4 + N * F * 4 + T * F * 4 bytes).
// All six are bound by bytes. P1 and P5 move 80 MB (bf16 rows; 0.024 ms at
// N = 2^20, T = 131072, F = 32 on an H100 SXM); P2 writes fp32 (147 MB,
// 0.0438 ms); P3, P4 and P6 move 155 MB (0.0463 ms). The bucketing pass (P2,
// P3, P4) adds about 20-30 MB of index traffic of its own (the indices read
// three times, the count table, the permutation written and read); P4 adds
// its zero-fill of the output (T * F * 4 bytes), its span's re-reads of idx
// (a few a span) and its flush (at most the updates' own bytes, reductions
// only where a span's edge cuts a bucket). The bucketed products do
// 2 * N * R * F operations (8.6e9 at that shape: 0.009 ms at the bf16
// tensor-core peak), so wgmma and TMA would buy nothing: mma.sync with
// cp.async is enough. That cost is reported apart from the bound. By count
// (not measured apart), the products' cost beside their bytes is building the
// one-hot fragments: every warp does it for every 16 queries or updates of
// its bucket.
// Limits of the bucketed probes (P2, P3, P4): N < 2^25 (a permutation entry
// packs the update with its 7-bit row), T <= 51200 * R rows (the count's
// shared histogram); indices outside [0, T) are skipped (their gather rows
// are left unset, their updates dropped); an Inf or a NaN in a table row (P2)
// or an update (P3) spreads a NaN over its bucket's results, as in any
// one-hot product. P6 skips indices outside [0, T) too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMS = 132;  // streaming multiprocessors of an H100 SXM: the persistent grids' width

// P1: thread -> (query, 16-byte piece); pieces = row bytes / 16.
__global__ void __launch_bounds__(THREADS) gather_coalesced_kernel(
    const uint4* __restrict__ table, const int* __restrict__ idx, uint4* __restrict__ out, int64_t n, int pieces) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n * pieces) return;
  const int64_t q = t / pieces;
  const int piece = (int)(t - q * pieces);
  out[t] = __ldg(table + (int64_t)__ldg(idx + q) * pieces + piece);
}

// P5: a thread owns one query's whole row. A block takes THREADS queries at a
// time (a persistent grid walks the blocks of queries); each thread loads its
// query's index (a warp's indices are one coalesced load), then its row's
// CHUNK pieces, all issued before any is used, with an L2 evict-last policy,
// and copies them into the block's stage in shared memory; the block then
// writes its [queries, CHUNK pieces] tile of the output whole, neighbouring
// threads on neighbouring 16-byte pieces, with streaming (evict-first) stores.
// A row wider than CHUNK pieces takes pieces / CHUNK such passes.
constexpr int SERIAL_MAX_CHUNK = 8;  // pieces a thread holds at once (F = 64 bf16)

__host__ __device__ constexpr int serial_blocks_per_sm(int chunk) { return chunk >= 8 ? 4 : 6; }

__device__ __forceinline__ uint64_t l2_evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint4 load_keep(const uint4* ptr, uint64_t policy) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(ptr), "l"(policy));
  return v;
}

// Where piece p of the tile's row r lies in the stage: rotated by the row so
// that any 8 consecutive (row, piece) chunks, written by the rows' owners or
// read in tile order, fall in 8 distinct 16-byte bank groups.
template <int CHUNK>
__device__ __forceinline__ int stage_slot(int r, int p) {
  return r * CHUNK + (p + r / (8 / CHUNK)) % CHUNK;
}

template <int CHUNK>
__global__ void __launch_bounds__(THREADS, serial_blocks_per_sm(CHUNK)) gather_serial_kernel(
    const uint4* __restrict__ table, const int* __restrict__ idx, uint4* __restrict__ out, int64_t n, int pieces) {
  static_assert(CHUNK >= 1 && CHUNK <= SERIAL_MAX_CHUNK && (CHUNK & (CHUNK - 1)) == 0, "CHUNK: 1, 2, 4 or 8");
  __shared__ uint4 stage[THREADS * CHUNK];
  const uint64_t keep = l2_evict_last_policy();
  const int t = threadIdx.x;
  for (int64_t base = (int64_t)blockIdx.x * THREADS; base < n; base += (int64_t)gridDim.x * THREADS) {
    const int rows = (int)(n - base < THREADS ? n - base : THREADS);
    const uint4* src = t < rows ? table + (int64_t)__ldcs(idx + base + t) * pieces : table;
    for (int pass = 0; pass < pieces; pass += CHUNK) {
      if (t < rows) {
        uint4 v[CHUNK];
#pragma unroll
        for (int p = 0; p < CHUNK; ++p) v[p] = load_keep(src + pass + p, keep);
#pragma unroll
        for (int p = 0; p < CHUNK; ++p) stage[stage_slot<CHUNK>(t, p)] = v[p];
      }
      __syncthreads();
      for (int j = t; j < rows * CHUNK; j += THREADS) {
        const int r = j / CHUNK, p = j % CHUNK;
        __stcs(out + (base + r) * pieces + pass + p, stage[stage_slot<CHUNK>(r, p)]);
      }
      __syncthreads();
    }
  }
}

template <int CHUNK>
void launch_serial(const uint4* table, const int* idx, uint4* out, int64_t n, int pieces, cudaStream_t st) {
  const int64_t blocks_of_queries = (n + THREADS - 1) / THREADS;
  const int grid = (int)std::min<int64_t>(blocks_of_queries, (int64_t)serial_blocks_per_sm(CHUNK) * SMS);
  gather_serial_kernel<CHUNK><<<grid, THREADS, 0, st>>>(table, idx, out, n, pieces);
}

// ---------------------------------------------------------------------------
// The bucketing pass of P2 and P3: a stable counting sort of the indices by
// bucket (idx / R).
constexpr int R_SHIFT = 7;
constexpr int R = 1 << R_SHIFT;               // rows a bucket
constexpr int BATCH = 16;                     // indices a lane loads at once
constexpr int64_t UNIT = WARPS * 32 * BATCH;  // 4096: a count or place block's chunk is a multiple of it
constexpr int64_t MAX_TABLE = 1 << 18;        // entries of the [buckets x blocks] table
constexpr int SMEM_CAP = 200 * 1024;          // dynamic shared memory of the count and place kernels
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_TILE = SCAN_THREADS * 16;  // table entries a scan block
constexpr int SCAN_CTRL = 68;                 // ints before the table: [0] arrivals, [4, 68) the tiles' sums

// n indices from `first` on, one a lane every 32, -1 past `end`; loaded together.
__device__ __forceinline__ void load_batch(const int* __restrict__ idx, int64_t first, int64_t end, int (&raw)[BATCH]) {
#pragma unroll
  for (int k = 0; k < BATCH; ++k) {
    const int64_t u = first + k * 32;
    raw[k] = u < end ? __ldg(idx + u) : -1;
  }
}

// block -> chunk of updates; its counts per bucket go to column blockIdx.x of
// the bucket-major table counts[bucket * nblk + block]. Block 0 also zeroes
// the scan's arrival count.
__global__ void __launch_bounds__(THREADS) bucket_count_kernel(
    const int* __restrict__ idx, int64_t n, int t_rows, int nb, int nblk, int64_t chunk, int* __restrict__ scratch) {
  extern __shared__ int hist[];
  if (blockIdx.x == 0 && threadIdx.x == 0) scratch[0] = 0;
  int* counts = scratch + SCAN_CTRL;
  for (int b = threadIdx.x; b < nb; b += THREADS) hist[b] = 0;
  __syncthreads();
  const int64_t u0 = (int64_t)blockIdx.x * chunk, u1 = min(n, u0 + chunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int64_t base = u0 + warp * 32 * BATCH; base < u1; base += WARPS * 32 * BATCH) {
    int raw[BATCH];
    load_batch(idx, base + lane, u1, raw);
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if ((unsigned)raw[k] < (unsigned)t_rows) atomicAdd(hist + (raw[k] >> R_SHIFT), 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += THREADS) counts[(int64_t)b * nblk + blockIdx.x] = hist[b];
}

// Block -> a tile of SCAN_TILE entries of the table a[0..m): its exclusive
// prefix sums in place, a[m] = the total. The tiles' sums meet through
// scratch: each block publishes its own, counts itself in, and waits for all
// (grid <= 64 blocks: all resident at once).
__global__ void __launch_bounds__(SCAN_THREADS) bucket_scan_kernel(int* __restrict__ scratch, int m) {
  __shared__ int warp_sum[SCAN_THREADS / 32];
  __shared__ int tile_carry;
  unsigned* arrived = reinterpret_cast<unsigned*>(scratch);
  volatile int* tile_sum = scratch + 4;
  int* a = scratch + SCAN_CTRL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lo = blockIdx.x * SCAN_TILE + threadIdx.x * 16;
  int v[16];
  if (lo + 16 <= m) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 x = reinterpret_cast<const int4*>(a + lo)[q];
      v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z, v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = lo + k < m ? a[lo + k] : 0;
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) s += v[k];
  int incl = s;  // inclusive scan of the threads' sums within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int before = incl - s, block_total = 0;
#pragma unroll
  for (int w = 0; w < SCAN_THREADS / 32; ++w) {
    before += w < warp ? warp_sum[w] : 0;
    block_total += warp_sum[w];
  }
  if (threadIdx.x == 0) {
    tile_sum[blockIdx.x] = block_total;
    __threadfence();
    atomicAdd(arrived, 1u);
    while (atomicAdd(arrived, 0u) < gridDim.x) {
    }
    __threadfence();
    int carry = 0;
    for (int t = 0; t < (int)blockIdx.x; ++t) carry += tile_sum[t];
    tile_carry = carry;
    if (blockIdx.x == gridDim.x - 1) a[m] = carry + block_total;
  }
  __syncthreads();
  int run = tile_carry + before;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int x = v[k];
    v[k] = run;
    run += x;
  }
  if (lo + 16 <= m) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      reinterpret_cast<int4*>(a + lo)[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (lo + k < m) a[lo + k] = v[k];
  }
}

// block -> the count kernel's chunk, warp -> a contiguous part of it. Each
// update's slot: its (bucket, block) offset, plus the bucket's updates in the
// block's earlier warps, in the warp's earlier steps and in its lower lanes.
__global__ void __launch_bounds__(THREADS) bucket_place_kernel(
    const int* __restrict__ idx, int64_t n, int t_rows, int nb, int nblk, int64_t chunk,
    const int* __restrict__ offsets, unsigned* __restrict__ perm) {
  extern __shared__ int slot[];  // [warps][nb]: counts, then each (warp, bucket)'s next slot
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < warps * nb; e += blockDim.x) slot[e] = 0;
  __syncthreads();
  const int64_t u0 = (int64_t)blockIdx.x * chunk, u1 = min(n, u0 + chunk);
  const int64_t part = chunk / warps;  // a multiple of 32 * BATCH
  const int64_t s0 = min(u1, u0 + warp * part), s1 = min(u1, s0 + part);
  int* mine = slot + warp * nb;
  for (int64_t base = s0; base < s1; base += 32 * BATCH) {  // the warp's counts (in any order)
    int raw[BATCH];
    load_batch(idx, base + lane, s1, raw);
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if ((unsigned)raw[k] < (unsigned)t_rows) atomicAdd(mine + (raw[k] >> R_SHIFT), 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int at = offsets[(int64_t)b * nblk + blockIdx.x];
    for (int w = 0; w < warps; ++w) {
      const int c = slot[w * nb + b];
      slot[w * nb + b] = at;
      at += c;
    }
  }
  __syncthreads();
  const unsigned lower = (1u << lane) - 1u;
  for (int64_t base = s0; base < s1; base += 32 * BATCH) {  // the slots, in order
    int raw[BATCH];
    load_batch(idx, base + lane, s1, raw);
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      // an index outside the table gets a key no bucket equals, distinct per lane
      const int key = (unsigned)raw[k] < (unsigned)t_rows ? raw[k] >> R_SHIFT : (int)(0x80000000u | (unsigned)lane);
      const unsigned same = __match_any_sync(FULL, key);
      if (key >= 0)
        perm[mine[key] + __popc(same & lower)] =
            ((unsigned)(base + k * 32 + lane) << R_SHIFT) | (unsigned)(raw[k] & (R - 1));
      __syncwarp();
      if (key >= 0 && lane == __ffs(same) - 1) mine[key] += __popc(same);
      __syncwarp();
    }
  }
}

struct Buckets {
  int nb;         // buckets of R rows
  int nblk;       // count and place blocks
  int warps;      // warps of a place block
  int scan_blk;   // scan blocks
  int64_t chunk;  // updates a count or place block: a multiple of UNIT
  int64_t table;  // entries of the offsets table: nb * nblk, then the total
  int64_t ints;   // the scratch: SCAN_CTRL ints, the table and its total, the permutation
};

bool bucket_layout(int64_t n, int t_rows, Buckets* L) {
  if (n < 1 || n >= (int64_t(1) << (32 - R_SHIFT)) || t_rows < 1) return false;
  L->nb = (t_rows + R - 1) / R;
  if ((int64_t)L->nb * 4 > SMEM_CAP) return false;
  const int64_t units = (n + UNIT - 1) / UNIT;
  const int64_t most = std::max<int64_t>(1, MAX_TABLE / L->nb);  // blocks the table allows
  L->chunk = UNIT * ((units + most - 1) / most);
  L->nblk = (int)((n + L->chunk - 1) / L->chunk);
  L->warps = WARPS;
  while (L->warps > 1 && L->warps * L->nb * 4 > SMEM_CAP) L->warps /= 2;
  L->table = (int64_t)L->nb * L->nblk;
  L->scan_blk = (int)((L->table + SCAN_TILE - 1) / SCAN_TILE);
  if (L->scan_blk > SCAN_CTRL - 4) return false;
  L->ints = SCAN_CTRL + L->table + 1 + n;
  return true;
}

// scratch: SCAN_CTRL control ints, the offsets table and its total, the permutation.
cudaError_t bucket_indices(const int* idx, int64_t n, int t_rows, const Buckets& L, int* scratch, cudaStream_t st) {
  int* offsets = scratch + SCAN_CTRL;
  unsigned* perm = reinterpret_cast<unsigned*>(offsets + L.table + 1);
  const int hist_bytes = L.nb * 4, slot_bytes = L.warps * L.nb * 4;
  static const cudaError_t allowed = [] {  // once: both may use up to SMEM_CAP bytes
    const cudaError_t e = cudaFuncSetAttribute(bucket_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               SMEM_CAP);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(bucket_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   SMEM_CAP);
  }();
  cudaError_t err = allowed;
  if (err != cudaSuccess) return err;
  bucket_count_kernel<<<L.nblk, THREADS, hist_bytes, st>>>(idx, n, t_rows, L.nb, L.nblk, L.chunk, scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bucket_scan_kernel<<<L.scan_blk, SCAN_THREADS, 0, st>>>(scratch, (int)L.table);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bucket_place_kernel<<<L.nblk, L.warps * 32, slot_bytes, st>>>(idx, n, t_rows, L.nb, L.nblk, L.chunk, offsets, perm);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The products. Fragments of mma.sync m16n8k16 (bf16 in, fp32 sum), lane =
// 4 * gq + tq: A (row-major 16 x 16) holds (gq, 2tq..+1), (gq + 8, 2tq..+1),
// (gq, 2tq + 8..+9), (gq + 8, 2tq + 8..+9); B (16 x 8, column-major) holds
// (2tq..+1, gq), (2tq + 8..+9, gq); C holds (gq, 2tq..+1), (gq + 8, 2tq..+1).
// A register packs two bf16 values, the lower column (or k) in the low half.
// B comes from a row-major [k][n] bf16 tile in shared memory through
// ldmatrix.trans, whose rows (SB(F) bf16 apart) fall in distinct banks.

template <int F>
struct Sb {
  static constexpr int value = F == 8 ? 24 : F + 8;  // 48 or 80 bytes: 8 rows' 16-byte pieces in distinct banks
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1, const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// B fragments of n-tiles 2p and 2p + 1 (b[0], b[1] and b[2], b[3]) of the k-step
// whose first row is `rows`, from a tile with SB bf16 a row; F = 8 has one n-tile.
template <int F>
__device__ __forceinline__ void load_b(const __nv_bfloat16* rows, int p, int lane, unsigned (&b)[4]) {
  constexpr int SB = Sb<F>::value;
  const int mat = (F == 8 ? lane & 15 : lane) >> 3;  // matrix: (k 0-7 | k 8-15) x (n-tile 2p | 2p + 1)
  const __nv_bfloat16* at = rows + ((mat & 1) * 8 + (lane & 7)) * SB + (2 * p + (mat >> 1)) * 8;
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(at));
  if constexpr (F == 8) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(b[0]), "=r"(b[1]) : "r"(s));
    b[2] = b[3] = 0u;
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3]) : "r"(s));
  }
}

constexpr unsigned BF16_ONE = 0x3F80u;

// Two one-hot entries: (lo, hi) as bf16 1 or 0.
__device__ __forceinline__ unsigned onehot2(bool lo, bool hi) { return (lo ? BF16_ONE : 0u) | (hi ? BF16_ONE << 16 : 0u); }

// P2: block (bucket, split) stages the bucket's rows; a warp multiplies 16
// queries at a time with them.
template <int F>
__global__ void __launch_bounds__(THREADS) gather_onehot_kernel(
    const __nv_bfloat16* __restrict__ table, const unsigned* __restrict__ perm, const int* __restrict__ offsets,
    int nblk, int t_rows, float* __restrict__ out) {
  constexpr int NT = F / 8;      // n-tiles of 8 columns
  constexpr int PIECES = F / 8;  // 16-byte pieces of a bf16 row
  constexpr int SB = Sb<F>::value;
  __shared__ __align__(16) __nv_bfloat16 rows[R * SB];
  const int b = blockIdx.x, r0 = b * R;
  for (int e = threadIdx.x; e < R * PIECES; e += THREADS) {
    const int r = e / PIECES, piece = e - r * PIECES;
    const bool in = r0 + r < t_rows;
    const __nv_bfloat16* src = in ? table + (int64_t)(r0 + r) * F + piece * 8 : table;
    cp_async16(rows + r * SB + piece * 8, src, in ? 16 : 0);  // zeros past the table's end
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  const int start = offsets[(int64_t)b * nblk];
  const int count = offsets[(int64_t)(b + 1) * nblk] - start;
  for (int grp = blockIdx.y * WARPS + warp; grp * 16 < count; grp += gridDim.y * WARPS) {
    const int qa = grp * 16 + (lane >> 2), qb = qa + 8;
    const unsigned pa = qa < count ? __ldg(perm + start + qa) : 0u;
    const unsigned pb = qb < count ? __ldg(perm + start + qb) : 0u;
    const int ra = qa < count ? (int)(pa & (R - 1)) : -1;  // the query's row within the bucket
    const int rb = qb < count ? (int)(pb & (R - 1)) : -1;
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < R / 16; ++ks) {
      const int k = ks * 16 + 2 * tq;
      const unsigned a0 = onehot2(ra == k, ra == k + 1), a1 = onehot2(rb == k, rb == k + 1);
      const unsigned a2 = onehot2(ra == k + 8, ra == k + 9), a3 = onehot2(rb == k + 8, rb == k + 9);
#pragma unroll
      for (int p = 0; p < (NT + 1) / 2; ++p) {
        unsigned bf[4];
        load_b<F>(rows + ks * 16 * SB, p, lane, bf);
        mma_bf16(acc[2 * p], a0, a1, a2, a3, bf[0], bf[1], acc[2 * p]);
        if (2 * p + 1 < NT) mma_bf16(acc[2 * p + 1], a0, a1, a2, a3, bf[2], bf[3], acc[2 * p + 1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (qa < count)
        *reinterpret_cast<float2*>(out + (int64_t)(pa >> R_SHIFT) * F + nt * 8 + 2 * tq) =
            make_float2(acc[nt][0], acc[nt][1]);
      if (qb < count)
        *reinterpret_cast<float2*>(out + (int64_t)(pb >> R_SHIFT) * F + nt * 8 + 2 * tq) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// P3: block -> bucket, warp -> 16 of its output rows. The bucket's updates
// are staged CH at a time: their permutation entries two chunks ahead, their
// fp32 g rows one chunk ahead (two buffers), then rounded to bf16 into one
// tile and multiplied.
template <int F>
struct Ch {
  static constexpr int value = F == 8 ? 256 : 128;  // updates a stage: 8-16 KB of fp32 rows
};

template <int F>
__global__ void __launch_bounds__(THREADS) scatter_onehot_kernel(
    const float* __restrict__ g, const unsigned* __restrict__ perm, const int* __restrict__ offsets, int nblk,
    int t_rows, float* __restrict__ out) {
  constexpr int NT = F / 8;      // n-tiles of 8 columns
  constexpr int PIECES = F / 4;  // 16-byte pieces of an fp32 row
  constexpr int CH = Ch<F>::value;
  constexpr int SB = Sb<F>::value;
  __shared__ __align__(16) float sg[2][CH * F];
  __shared__ __align__(16) __nv_bfloat16 sb[CH * SB];
  __shared__ unsigned sp[3][CH];  // the chunks' permutation entries (update << 7 | row within the bucket)
  const int b = blockIdx.x;
  const int start = offsets[(int64_t)b * nblk];
  const int count = offsets[(int64_t)(b + 1) * nblk] - start;
  const int chunks = (count + CH - 1) / CH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int ma = warp * 16 + gq, mb = ma + 8;  // the lane's two output rows within the bucket

  auto stage_perm = [&](int c) {  // zeros past the bucket's end
    for (int j = threadIdx.x; j < CH; j += THREADS) {
      const bool in = c * CH + j < count;
      cp_async4(&sp[c % 3][j], in ? perm + start + c * CH + j : perm, in ? 4 : 0);
    }
  };
  auto stage_rows = [&](int c) {  // zeros past the bucket's end
    for (int e = threadIdx.x; e < CH * PIECES; e += THREADS) {
      const int j = e / PIECES, piece = e - j * PIECES;
      const bool in = c * CH + j < count;
      const float* src = in ? g + (int64_t)(sp[c % 3][j] >> R_SHIFT) * F + piece * 4 : g;
      cp_async16(&sg[c & 1][j * F + piece * 4], src, in ? 16 : 0);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  if (chunks > 0) {
    stage_perm(0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    stage_rows(0);
    if (chunks > 1) stage_perm(1);
    cp_async_commit();  // every thread commits a group, even an empty one
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<0>();  // rows of chunk c, entries of chunk c + 1
    __syncthreads();
    if (c + 1 < chunks) stage_rows(c + 1);
    if (c + 2 < chunks) stage_perm(c + 2);
    cp_async_commit();
    for (int e = threadIdx.x; e < CH * F / 4; e += THREADS) {  // fp32 -> bf16, as the TPU kernel rounds g
      const float4 x = reinterpret_cast<const float4*>(sg[c & 1])[e];
      const int j = e / (F / 4), col = (e - j * (F / 4)) * 4;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
      uint2 packed;
      packed.x = *reinterpret_cast<const unsigned*>(&lo);
      packed.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(sb + j * SB + col) = packed;
    }
    __syncthreads();
    // Past the bucket's end an entry is 0 (row 0) and its staged row is 0: it adds nothing.
    const unsigned* pc = sp[c % 3];
    float part[NT][4];  // the chunk's products start from zero and are added to acc with round-to-nearest:
#pragma unroll        // a hot row's long sum keeps fp32 rounding
    for (int nt = 0; nt < NT; ++nt) part[nt][0] = part[nt][1] = part[nt][2] = part[nt][3] = 0.0f;
    const int valid = min(CH, count - c * CH);
    for (int ks = 0; ks * 16 < valid; ++ks) {
      const int j = ks * 16 + 2 * tq;
      const int q0 = pc[j] & (R - 1), q1 = pc[j + 1] & (R - 1), q2 = pc[j + 8] & (R - 1), q3 = pc[j + 9] & (R - 1);
      const unsigned a0 = onehot2(q0 == ma, q1 == ma), a1 = onehot2(q0 == mb, q1 == mb);
      const unsigned a2 = onehot2(q2 == ma, q3 == ma), a3 = onehot2(q2 == mb, q3 == mb);
#pragma unroll
      for (int p = 0; p < (NT + 1) / 2; ++p) {
        unsigned bf[4];
        load_b<F>(sb + ks * 16 * SB, p, lane, bf);
        mma_bf16(part[2 * p], a0, a1, a2, a3, bf[0], bf[1], part[2 * p]);
        if (2 * p + 1 < NT) mma_bf16(part[2 * p + 1], a0, a1, a2, a3, bf[2], bf[3], part[2 * p + 1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = __fadd_rn(acc[nt][i], part[nt][i]);
    __syncthreads();
  }
  const int64_t row_a = (int64_t)b * R + ma, row_b = row_a + 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (row_a < t_rows)
      *reinterpret_cast<float2*>(out + row_a * F + nt * 8 + 2 * tq) = make_float2(acc[nt][0], acc[nt][1]);
    if (row_b < t_rows)
      *reinterpret_cast<float2*>(out + row_b * F + nt * 8 + 2 * tq) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// P4: a persistent grid walks the permutation in spans of SPAN entries; per
// bucket a span meets, an R x F accumulator in shared memory.
constexpr int SPAN = 1024;
constexpr int BLOCKED_BLOCKS_PER_SM = 6;  // the accumulate's register cap (no spill) and its grid: 6 blocks an SM

__device__ __forceinline__ void red_add4(float* p, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ bool nonzero4(float4 v) { return v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f; }

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// acc[0..3] += v with four shared atomics, starting at column `rot` mod 4.
__device__ __forceinline__ void shared_add4(float* acc, float4 v, int rot) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = (j + rot) & 3;
    atomicAdd(acc + c, c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w);
  }
}

template <int F>
__global__ void __launch_bounds__(THREADS, BLOCKED_BLOCKS_PER_SM) scatter_blocked_kernel(
    const float4* __restrict__ g, const int* __restrict__ idx, const unsigned* __restrict__ perm,
    const int* __restrict__ offsets, int nblk, int nb, int t_rows, float* __restrict__ out) {
  constexpr int L = F / 4;           // lanes an update, a float4 each
  constexpr int STEP = THREADS / L;  // entries a block step
  constexpr int UNROLL = 2;          // entries a lane loads at once (4 cost registers, hence occupancy)
  __shared__ __align__(16) float acc[R * F];
  __shared__ int seg[3];  // the bucket of the segment, its start and its end in the permutation
  const int lane = threadIdx.x & 31, grp = threadIdx.x / L, piece = threadIdx.x % L;
  const int total = offsets[(int64_t)nb * nblk];  // entries of in-range indices
  float4* acc4 = reinterpret_cast<float4*>(acc);
  for (int64_t s0 = (int64_t)blockIdx.x * SPAN; s0 < total; s0 += (int64_t)gridDim.x * SPAN) {
    const int p0 = (int)s0, p1 = min(total, p0 + SPAN);
    for (int p = p0; p < p1;) {  // bucket by bucket: the permutation is sorted by bucket
      for (int e = threadIdx.x; e < R * L; e += THREADS) acc4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (threadIdx.x == 0) {  // the bucket of entry p, from its update's index, re-read
        const int b = __ldg(idx + (__ldg(perm + p) >> R_SHIFT)) >> R_SHIFT;
        seg[0] = b;
        seg[1] = __ldg(offsets + (int64_t)b * nblk);
        seg[2] = __ldg(offsets + (int64_t)(b + 1) * nblk);
      }
      __syncthreads();
      const int b = seg[0], q = min(p1, seg[2]);
      const bool whole = seg[1] >= p0 && seg[2] <= p1;
      int run_row = -1;  // the row of the running sum, -1 before the first entry
      float4 run = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int e0 = p + grp; e0 < q; e0 += UNROLL * STEP) {
        unsigned ent[UNROLL];
        float4 v[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) ent[k] = e0 + k * STEP < q ? __ldg(perm + e0 + k * STEP) : 0u;
#pragma unroll
        for (int k = 0; k < UNROLL; ++k)
          v[k] = e0 + k * STEP < q ? __ldg(g + (int64_t)(ent[k] >> R_SHIFT) * L + piece)
                                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          if (e0 + k * STEP >= q) continue;
          const int row = (int)(ent[k] & (R - 1));
          if (row == run_row) {
            run = add4(run, v[k]);
          } else {
            if (run_row >= 0) shared_add4(acc + run_row * F + piece * 4, run, lane / L);
            run_row = row;
            run = v[k];
          }
        }
      }
      if (run_row >= 0) shared_add4(acc + run_row * F + piece * 4, run, lane / L);
      __syncthreads();
      for (int e = threadIdx.x; e < R * L; e += THREADS) {
        const int64_t row = (int64_t)b * R + e / L;
        const float4 x = acc4[e];
        if (row < t_rows && nonzero4(x)) {
          float* dst = out + row * F + (e % L) * 4;
          if (whole) *reinterpret_cast<float4*>(dst) = x;  // the bucket's one owner
          else red_add4(dst, x);                           // a part of a bucket cut by a span's edge
        }
      }
      p = q;
      __syncthreads();  // before the next segment zeroes acc and rewrites seg
    }
  }
}

// P6: thread -> (update, 16-byte piece of its row); one vector reduction each.
__global__ void __launch_bounds__(THREADS) scatter_serial_kernel(
    const int* __restrict__ idx, const float4* __restrict__ g, float* __restrict__ out, int64_t n, int pieces,
    int t_rows) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n * pieces) return;
  const int64_t u = t / pieces;
  const int r = __ldg(idx + u);
  if ((unsigned)r < (unsigned)t_rows) red_add4(out + ((int64_t)r * pieces + (t - u * pieces)) * 4, __ldg(g + t));
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
  const int pieces = f / 8;
  const uint4* tbl = static_cast<const uint4*>(table);
  uint4* dst = static_cast<uint4*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pieces % 8 == 0) launch_serial<8>(tbl, idx, dst, n, pieces, st);
  else if (pieces % 4 == 0) launch_serial<4>(tbl, idx, dst, n, pieces, st);
  else if (pieces % 2 == 0) launch_serial<2>(tbl, idx, dst, n, pieces, st);
  else launch_serial<1>(tbl, idx, dst, n, pieces, st);
  return (int)cudaGetLastError();
}

// The one-hot probes' scratch in int32s (the bucketing pass's offsets table
// and permutation), or -1 for a shape they do not take. The caller allocates
// it and passes it to gather_rows_onehot or scatter_rows_onehot.
extern "C" int onehot_scratch_ints(long long n, int t_rows) {
  Buckets L;
  if (!bucket_layout(n, t_rows, &L)) return -1;
  return (int)L.ints;
}

// out [n, f] fp32; f in {8, 16, 32}; n >= 1; table 16-byte aligned.
extern "C" int gather_rows_onehot(const void* table, const int* idx, float* out, long long n, int t_rows, int f,
                                  void* scratch, void* stream) {
  Buckets L;
  if (!bucket_layout(n, t_rows, &L) || (f != 8 && f != 16 && f != 32)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bucket_indices(idx, n, t_rows, L, static_cast<int*>(scratch), st);
  if (err != cudaSuccess) return (int)err;
  const int* offsets = static_cast<const int*>(scratch) + SCAN_CTRL;
  const unsigned* perm = reinterpret_cast<const unsigned*>(offsets + L.table + 1);
  // a few buckets (a small table) split their queries over blocks, to fill the card
  const dim3 grid(L.nb, std::max(1, std::min(8, (4 * SMS + L.nb - 1) / L.nb)));
  const __nv_bfloat16* tbl = static_cast<const __nv_bfloat16*>(table);
  if (f == 8) gather_onehot_kernel<8><<<grid, THREADS, 0, st>>>(tbl, perm, offsets, L.nblk, t_rows, out);
  else if (f == 16) gather_onehot_kernel<16><<<grid, THREADS, 0, st>>>(tbl, perm, offsets, L.nblk, t_rows, out);
  else gather_onehot_kernel<32><<<grid, THREADS, 0, st>>>(tbl, perm, offsets, L.nblk, t_rows, out);
  return (int)cudaGetLastError();
}

// Scatter-adds: idx [n] int32 in [0, t_rows), g [n, f] fp32, out [t_rows, f]
// fp32. Return the launch's cudaError_t, or -1 for arguments no kernel takes.
// scatter_rows_onehot: every entry of out written (no zero-fill needed); f in
// {8, 16, 32}; n >= 1; g 16-byte aligned; no float atomics.
extern "C" int scatter_rows_onehot(const int* idx, const float* g, float* out, long long n, int t_rows, int f,
                                   void* scratch, void* stream) {
  Buckets L;
  if (!bucket_layout(n, t_rows, &L) || (f != 8 && f != 16 && f != 32)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bucket_indices(idx, n, t_rows, L, static_cast<int*>(scratch), st);
  if (err != cudaSuccess) return (int)err;
  const int* offsets = static_cast<const int*>(scratch) + SCAN_CTRL;
  const unsigned* perm = reinterpret_cast<const unsigned*>(offsets + L.table + 1);
  if (f == 8) scatter_onehot_kernel<8><<<L.nb, THREADS, 0, st>>>(g, perm, offsets, L.nblk, t_rows, out);
  else if (f == 16) scatter_onehot_kernel<16><<<L.nb, THREADS, 0, st>>>(g, perm, offsets, L.nblk, t_rows, out);
  else scatter_onehot_kernel<32><<<L.nb, THREADS, 0, st>>>(g, perm, offsets, L.nblk, t_rows, out);
  return (int)cudaGetLastError();
}

template <int F>
void launch_blocked(const float* g, const int* idx, int64_t n, const int* scratch, const Buckets& L, int t_rows,
                    float* out, cudaStream_t st) {
  const int* offsets = scratch + SCAN_CTRL;
  const unsigned* perm = reinterpret_cast<const unsigned*>(offsets + L.table + 1);
  const int blocks = (int)std::min<int64_t>((n + SPAN - 1) / SPAN, BLOCKED_BLOCKS_PER_SM * SMS);
  scatter_blocked_kernel<F><<<blocks, THREADS, 0, st>>>(reinterpret_cast<const float4*>(g), idx, perm, offsets,
                                                        L.nblk, L.nb, t_rows, out);
}

// out [t_rows, f] fp32, zero-filled here; f in {8, 16, 32}; n >= 1; g and out
// 16-byte aligned. Five launches: the fill, the bucketing pass, the accumulate.
extern "C" int scatter_rows_blocked(const int* idx, const float* g, float* out, long long n, int t_rows, int f,
                                    void* scratch, void* stream) {
  Buckets L;
  if (!bucket_layout(n, t_rows, &L) || (f != 8 && f != 16 && f != 32) || (((uintptr_t)g | (uintptr_t)out) & 15))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)t_rows * f * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  int* sc = static_cast<int*>(scratch);
  if ((err = bucket_indices(idx, n, t_rows, L, sc, st)) != cudaSuccess) return (int)err;
  if (f == 8) launch_blocked<8>(g, idx, n, sc, L, t_rows, out, st);
  else if (f == 16) launch_blocked<16>(g, idx, n, sc, L, t_rows, out, st);
  else launch_blocked<32>(g, idx, n, sc, L, t_rows, out, st);
  return (int)cudaGetLastError();
}

// out [t_rows, f] fp32, zero-filled here; f a multiple of 4; g and out 16-byte
// aligned; indices outside [0, t_rows) are skipped.
extern "C" int scatter_rows_serial(const int* idx, const float* g, float* out, long long n, int t_rows, int f,
                                   void* stream) {
  if (n < 0 || t_rows < 1 || f < 4 || f % 4 || (((uintptr_t)g | (uintptr_t)out) & 15)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)t_rows * f * sizeof(float), st);
  if (err != cudaSuccess || n == 0) return (int)err;
  scatter_serial_kernel<<<blocks_for(n * (f / 4)), THREADS, 0, st>>>(idx, reinterpret_cast<const float4*>(g), out,
                                                                      n, f / 4, t_rows);
  return (int)cudaGetLastError();
}
