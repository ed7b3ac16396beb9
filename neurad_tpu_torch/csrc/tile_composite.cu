// Per-tile front-to-back gaussian compositing for Hopper (sm_90a).
//
// Replaces the two forward TPU kernels of neurad_tpu/ops/pallas_composite.py:
//   tile_composite_camera_fwd <- _composite_fwd_kernel (K2, launched by _run_fwd)
//   tile_composite_lidar_fwd  <- _make_lidar_fwd_kernel (K4, launched by run_lidar_fwd)
// Plain PyTorch versions of the same functions: neurad_tpu_torch/ops/tile_composite.py.
// The backward composites are in tile_composite_bwd.cu; the gated alpha they all
// share, and the lidar kernels' stage and its loader, are in
// tile_composite_common.cuh.
//
// Inputs. Unlike the TPU kernels, which take pre-gathered [T, K, ...] arrays,
// these read the per-gaussian packed table [N, 10 + C] (mean xy, vel xy,
// conic abc, opacity, depth, depth velocity, C features) through the tile's
// index list tile_gauss [T, K], so the gathered [T, K, 10 + C] copy never
// exists in device memory. Index entries are clamped into [0, N).
//
// What bounds them. K2 at full width (1920x1080, T = 8160 tiles, P = 256
// pixels, K = 256 slots, C = 16) has T*P*K = 5.35e8 (pixel, slot) pairs. A
// pair whose slot is valid needs its quadratic form, 15 fp32 operations; where
// that lies beyond kFarSigma (about three fifths of the valid pairs at the
// `splatad` preset's full width) alpha is zero whatever follows, and one
// comparison settles it. Any other valid pair needs about 32 operations for its
// gated alpha (the exp on the special-function units), and one whose alpha
// passes the gate (about a third of the valid pairs: gaussians are binned to
// tiles by their footprint's bounding box) 2 (C + 2) more for the feature,
// depth and alpha sums and the transmittance. That is about 1.8e10
// operations, 0.27 ms at the H100 SXM's 67 TFLOP/s fp32 rate outside the
// tensor cores (the run's own count is in chip_smoke.py). It must move about
// 0.2 GB (index lists, pixel coordinates, the table rows it uses, the
// outputs): about 0.06 ms at 3.35 TB/s. So fp32 issue binds. The alpha is
// rounded op by op (no FMA may join its products and sums), so each of its
// operations takes an issue slot, where the 67 TFLOP/s rate counts an FMA as
// two operations in one slot: a kernel reaches at most about half of that
// bound. Below, the far cut is taken a patch of 32 pixels at a time, which
// holds for about half of the valid patch-slot pairs, so a pair beyond the cut
// in a patch that is not wholly beyond it still pays for its exp.
//
// K4 at full width (T = 3780 tiles of 2 x 2 degrees, P = 128 query slots, K =
// 128 gaussian slots, C = 16; a 64 x 1024-beam scan) has 127 valid gaussian
// slots a tile but only 17 valid query slots on average (at most 24: 14% of
// P), filled from slot 0. Its least work is small: 8.3e6 valid (query, slot)
// pairs, 57% of them beyond the far cut and 38% past the gate, 3.5e8
// operations; the bytes bind (every query slot's outputs, the valid ones'
// inputs, the rows the slots use: 52 MB, 0.016 ms at 3.35 TB/s). What holds a
// kernel back is the work it issues for each (tile, slot) step: each query's
// K slot steps depend on each other, and a tile has few queries to spread
// over lanes.
//
// K2's design. An earlier version ran one thread a pixel over a 256-slot stage
// loaded between two barriers with nothing overlapping the load, read the 10
// attributes and C features of every pair as 4-byte broadcast loads from
// shared memory (as many shared loads as feature FMAs: the shared-memory pipe,
// not the fp32 units, set its pace), and accumulated every pair, gated or not.
// Now:
//  * a thread owns two pixels, so a slot's attributes and features are read
//    from shared memory once for both; they are staged as float4s (mean and
//    velocity; conic and opacity; depth, depth velocity and validity; the
//    features), 3 + C / 4 vector loads a slot. A warp's 32 lanes cover an 8x4
//    patch of a 16x16 tile for each of its two pixels (the upper and the
//    lower half of an 8x8 quarter), so that its votes below cover compact
//    patches;
//  * where every pixel of a patch lies beyond kFarSigma of a slot (about half
//    of the valid patch-slot pairs at full width), the warp skips the exp and
//    the clips: their alpha is zero whatever they would compute;
//  * where the gate zeroes alpha for every pixel of a patch (__any_sync), the
//    warp skips the slot's feature, depth and alpha sums for it; within a lane
//    a zero alpha adds zero weight, which for finite features leaves the sums
//    bit-identical to accumulating it (w = 0 adds +-0, 1 - 0 leaves the
//    transmittance);
//  * the slots stream through two shared-memory buffers of 64 slots: the next
//    chunk's rows, validity and index entries are copied with cp.async while
//    the current chunk is composited (as in K3);
//  * each pixel's sums run in slot order with the earlier version's
//    contraction, now written out (w = alpha * T; feature and depth sums are
//    FMAs; alpha and T plain products and sums), so K2's outputs, from which
//    K3 takes its G, are unchanged to the last bit.
//
// K4's design. The first version ran a block a tile and a thread a query slot:
// of its four warps one held the tile's 17 queries and three only loaded the
// stage and waited at its barriers; it loaded a 256-slot stage with 4-byte
// loads between two barriers, and walked the slots a second time, recomputing
// every alpha up to the median. Now:
//  * a warp owns a tile (four a block, no block barrier) and gives its lanes
//    to the tile's valid query slots only, compacted by a ballot over vmask
//    (any pattern; rounds of 32 where a tile holds more);
//  * the tile's valid gaussian slots, compacted, stream through two stage
//    buffers of 16 slots as float4s (the lane that finds a slot valid copies
//    its row with cp.async) while the previous 16 are composited;
//  * a slot that lies beyond kFarSigma of every query skips the exp, one whose
//    alpha no query passes the gate skips the sums (a zero weight would leave
//    them bit-equal anyway);
//  * no second walk for the median: at each slot it composites, the warp
//    writes every lane's running weight sum (and the slot's depth) to a
//    scratch in device memory; the sums only grow, so a binary search finds
//    the first that reaches half of acc, the slot the second walk stopped at.
//    Kept in shared memory (17 KB a warp) those sums held an SM to 8 warps and
//    the grid to 3.6 waves; in device memory (they stay in L2) 32 warps fit,
//    the whole full-width grid at once, and the kernel took two thirds of the
//    time (NVIDIA H100 80GB HBM3);
//  * the sums keep the first version's order and contraction (w = T alpha;
//    FMAs for the features and depth; plain sums for acc and the line-of-sight
//    sum; the running sum an FMA of alpha and T, as its second walk's), so
//    K4's outputs are bit-equal to it.
// At full width it is bound by the SMs' instruction issue, not by a warp's
// latency: four tiles an SM take a third of the full grid's time, which grows
// in proportion to the tiles beyond that (chip_smoke.py); a composited slot
// costs about 100 instructions (alpha rounded op by op), issued for warps
// whose lanes are half idle (17 queries on 32 lanes). Independent FMAs added
// to a composited slot cost about a cycle each, more shared loads almost
// nothing, and taking two slots a step (to overlap their chains) did not help.
//
// Semantics kept from the TPU kernels, each of which changes numbers:
//  * no early termination: every slot is composited whatever the transmittance;
//  * gating: sigma clipped to [0, 50], alpha clipped to [0, 0.999], then alpha
//    zeroed where valid <= 0 or alpha < 1/255 (and, for lidar, vmask <= 0);
//  * azimuth wrap is a floored modulo computed as jnp.mod computes it: fmodf
//    (exact), then +360 where the remainder is negative (torch.remainder
//    rounds differently near 360, so the plain version uses the same recipe);
//  * the 1/255 gate is a step: a pair on the other side of it moves a pixel's
//    features by up to 1/255 of a feature and its depth by centimetres, so
//    alpha is rounded op by op, in the plain version's order, up to the gate;
//  * lidar median depth is the depth of the first slot whose inclusive weight
//    sum reaches half the total; where the total is 0 (every masked query
//    slot, for one) it is raw slot 0's depth, valid or not;
//  * the lidar line-of-sight sum is always computed (the backward takes it
//    from the saved outputs); the wrapper hands the caller zeros where it did
//    not ask for it.

#include "tile_composite_common.cuh"

namespace {

using namespace tile_composite;


constexpr int CAM_WARPS = 4;    // K2's warps a block: 64 pixels each, two a lane
constexpr int CAM_CHUNK = 64;   // slots in each of K2's two stage buffers
constexpr int CAM_ATTR4 = 3;    // float4s of a slot's attributes in K2's stage

// CAM_CHUNK slots of one tile in shared memory, as float4s: (mean x, mean y,
// vel x, vel y), (conic a, b, c, opacity), (depth, depth vel, valid, -), then
// the CMAX features (columns c .. CMAX - 1 zero).
template <int CMAX>
struct CamStage {
  float4 attr[CAM_CHUNK * CAM_ATTR4];
  float4 feat[CAM_CHUNK * (CMAX / 4)];
};

// Start the copy of slots [k0, k0 + n) of the tile whose index list starts at
// `base` into s: every thread issues its share and commits one group.
template <int CMAX>
__device__ __forceinline__ void issue_cam_chunk(CamStage<CMAX>& s, const float* __restrict__ table, int n_gauss, int c,
                                                const int* __restrict__ tile_gauss,
                                                const float* __restrict__ tile_valid, int64_t base, int k0, int n) {
  const int width = ATTR + c;
  float* attr = reinterpret_cast<float*>(s.attr);
  float* feat = reinterpret_cast<float*>(s.feat);
  for (int j = threadIdx.x; j < n; j += blockDim.x) cp_async4(attr + j * 12 + 10, tile_valid + base + k0 + j);
  for (int e = threadIdx.x; e < n * width; e += blockDim.x) {
    const int j = e / width;
    const int col = e - j * width;
    const int g = min(max(__ldg(tile_gauss + base + k0 + j), 0), n_gauss - 1);
    cp_async4(col < ATTR ? attr + j * 12 + col : feat + j * CMAX + col - ATTR, table + (int64_t)g * width + col);
  }
  cp_async_commit();
}

// The pixel of lane `lane`'s half h in warp `warp`, within a round of the
// block's pixels. A full block's lanes lie in 8x4 patches of a row-major 16x16
// tile (warp w: rows 8 (w / 2) .. + 7, columns 8 (w % 2) .. + 7; h: the upper
// or the lower four rows), so that a warp's vote covers a compact patch; any
// other tile shape is still covered once.
__device__ __forceinline__ int cam_pixel(int warp, int h, int lane) {
  return blockDim.x == CAM_WARPS * 32 ? ((warp >> 1) * 8 + h * 4 + (lane >> 3)) * 16 + (warp & 1) * 8 + (lane & 7)
                                      : warp * 64 + h * 32 + lane;
}

template <int CMAX>
__global__ void __launch_bounds__(CAM_WARPS * 32) camera_fwd_kernel(
    const float* __restrict__ table, int n_gauss, int c, const int* __restrict__ tile_gauss,
    const float* __restrict__ tile_valid, const float* __restrict__ pix, const float* __restrict__ times,
    int p, int k, float* __restrict__ feat_out, float* __restrict__ depth_out, float* __restrict__ alpha_out) {
  constexpr int G = CMAX / 4;  // float4s of a slot's features
  __shared__ CamStage<CMAX> stage[2];
  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t base = (int64_t)tile * k;
  const int n_chunks = (k + CAM_CHUNK - 1) / CAM_CHUNK;

  // feature columns c .. CMAX - 1 stay zero in both buffers: the copies never write them (made visible to
  // every thread by the first chunk's barrier)
  const int pad = CMAX - c;
  for (int e = threadIdx.x; e < 2 * CAM_CHUNK * pad; e += blockDim.x) {
    const int b = e / (CAM_CHUNK * pad);
    const int r = e - b * (CAM_CHUNK * pad);
    const int j = r / pad;
    reinterpret_cast<float*>(stage[b].feat)[j * CMAX + c + (r - j * pad)] = 0.f;
  }

  for (int q0 = 0; q0 < p; q0 += 2 * blockDim.x) {  // a tile with more pixels is walked in rounds
    if (n_chunks > 0) issue_cam_chunk<CMAX>(stage[0], table, n_gauss, c, tile_gauss, tile_valid, base, 0, min(CAM_CHUNK, k));
    bool on[2];
    float x[2], y[2], t[2], trans[2], acc_d[2], acc_a[2], acc_f[2][CMAX];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + cam_pixel(warp, h, lane);
      on[h] = q < p;
      const int64_t slot = (int64_t)tile * p + q;
      x[h] = on[h] ? pix[slot * 2] : 0.f;
      y[h] = on[h] ? pix[slot * 2 + 1] : 0.f;
      t[h] = on[h] ? times[slot] : 0.f;
      trans[h] = 1.f;
      acc_d[h] = acc_a[h] = 0.f;
#pragma unroll
      for (int ci = 0; ci < CMAX; ++ci) acc_f[h][ci] = 0.f;
    }

    for (int r = 0; r < n_chunks; ++r) {
      if (r + 1 < n_chunks) {
        const int k1 = (r + 1) * CAM_CHUNK;
        issue_cam_chunk<CMAX>(stage[(r + 1) & 1], table, n_gauss, c, tile_gauss, tile_valid, base, k1,
                              min(CAM_CHUNK, k - k1));
        cp_async_wait<1>();  // this thread's copies of chunk r have landed ...
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // ... and every thread's
      const CamStage<CMAX>& s = stage[r & 1];
      const int n = min(CAM_CHUNK, k - r * CAM_CHUNK);
      for (int j = 0; j < n; ++j) {
        const float4 a2 = s.attr[j * CAM_ATTR4 + 2];
        if (!(a2.z > 0.f)) continue;  // an invalid slot: alpha 0 (same j in every thread)
        const float4 a0 = s.attr[j * CAM_ATTR4], a1 = s.attr[j * CAM_ATTR4 + 1];
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        // a patch whose pixels all lie beyond kFarSigma of the slot gates it to zero without the exp
        const bool cull = a1.w <= 1.f;
        float alpha[2];
        bool any[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const SlotSigma sg = slot_sigma(a, x[h], y[h], t[h], false);
          alpha[h] = 0.f;
          any[h] = __any_sync(0xffffffffu, on[h] && !(cull && sg.sigma_raw > kFarSigma));
          if (any[h]) {
            alpha[h] = gate_terms(a, sg, true, on[h]).alpha;
            any[h] = __any_sync(0xffffffffu, alpha[h] > 0.f);
          }
        }
        if (!any[0] && !any[1]) continue;  // every pixel of the warp gates this slot to zero
        float w[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) w[h] = __fmul_rn(alpha[h], trans[h]);
#pragma unroll
        for (int g4 = 0; g4 < G; ++g4) {
          const float4 f = s.feat[j * G + g4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (any[h]) {
              acc_f[h][4 * g4] = __fmaf_rn(w[h], f.x, acc_f[h][4 * g4]);
              acc_f[h][4 * g4 + 1] = __fmaf_rn(w[h], f.y, acc_f[h][4 * g4 + 1]);
              acc_f[h][4 * g4 + 2] = __fmaf_rn(w[h], f.z, acc_f[h][4 * g4 + 2]);
              acc_f[h][4 * g4 + 3] = __fmaf_rn(w[h], f.w, acc_f[h][4 * g4 + 3]);
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (any[h]) {
            acc_d[h] = __fmaf_rn(w[h], __fadd_rn(a2.x, __fmul_rn(a2.y, t[h])), acc_d[h]);
            acc_a[h] = __fadd_rn(acc_a[h], w[h]);
            trans[h] = __fmul_rn(trans[h], __fsub_rn(1.f, alpha[h]));
          }
        }
      }
      __syncthreads();  // buffer r & 1 is free for chunk r + 2
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!on[h]) continue;
      const int64_t slot = (int64_t)tile * p + q0 + cam_pixel(warp, h, lane);
      float* fo = feat_out + slot * c;
      if ((c & 3) == 0) {
#pragma unroll
        for (int g4 = 0; g4 < G; ++g4) {
          if (4 * g4 < c)
            __stcs(reinterpret_cast<float4*>(fo) + g4, make_float4(acc_f[h][4 * g4], acc_f[h][4 * g4 + 1],
                                                                  acc_f[h][4 * g4 + 2], acc_f[h][4 * g4 + 3]));
        }
      } else {
#pragma unroll
        for (int ci = 0; ci < CMAX; ++ci) {
          if (ci < c) fo[ci] = acc_f[h][ci];
        }
      }
      depth_out[slot] = acc_d[h];
      alpha_out[slot] = acc_a[h];
    }
  }
}

// K4: a warp a tile, over its valid query slots (rounds of 32) and its valid
// gaussian slots (staged LID_CHUNK at a time, compacted, double-buffered).
// records [n_tiles, k, 34]: scratch for each composited slot's running sums
// (32 floats, a lane's each) and (depth, depth velocity).
template <int CMAX>
__global__ void __launch_bounds__(LID_WARPS * 32) lidar_fwd_kernel(
    const float* __restrict__ table, int n_gauss, int c, const int* __restrict__ tile_gauss,
    const float* __restrict__ tile_valid, const float* __restrict__ pts, const float* __restrict__ vmask,
    int n_tiles, int p, int k, int wrap, float depth_eps, float* __restrict__ feat_out, float* __restrict__ depth_out,
    float* __restrict__ acc_out, float* __restrict__ until_out, float* __restrict__ med_out,
    float* __restrict__ records) {
  constexpr int G = CMAX / 4;  // float4s of a slot's features
  __shared__ LidarWarp<CMAX> warps[LID_WARPS];
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * LID_WARPS + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;  // a whole warp: the kernel has no block barrier
  LidarWarp<CMAX>& w = warps[threadIdx.x >> 5];
  const int64_t base = (int64_t)tile * k, row = (int64_t)tile * p;
  float* rec_sum = records + base * 34;                                 // [k][32]
  float2* rec_depth = reinterpret_cast<float2*>(rec_sum + (int64_t)k * 32);  // [k]
  const int width = ATTR + c;
  const int n_raw = (k + LID_CHUNK - 1) / LID_CHUNK;
  zero_feature_padding<CMAX>(w, c, lane);

  // where a query's weights sum to zero (a masked query slot, or every alpha
  // gated), its median is the depth of raw slot 0, valid or not
  float d0 = 0.f, dv0 = 0.f;
  if (k > 0) {
    const int64_t g0 = min(max(tile_gauss[base], 0), n_gauss - 1);
    d0 = table[g0 * width + 8];
    dv0 = table[g0 * width + 9];
  }
  auto write = [&](int64_t slot, const float* f, float depth, float acc, float until, float med) {
    float* fo = feat_out + slot * c;
    if ((c & 3) == 0) {
#pragma unroll
      for (int g4 = 0; g4 < G; ++g4) {
        if (4 * g4 < c) __stcs(reinterpret_cast<float4*>(fo) + g4, make_float4(f[4 * g4], f[4 * g4 + 1],
                                                                               f[4 * g4 + 2], f[4 * g4 + 3]));
      }
    } else {
#pragma unroll
      for (int ci = 0; ci < CMAX; ++ci) {
        if (ci < c) fo[ci] = f[ci];
      }
    }
    depth_out[slot] = depth;
    acc_out[slot] = acc;
    until_out[slot] = until;
    med_out[slot] = med;
  };
  const int n_q = round_queries(w, vmask, row, p, 0, lane, [&](int q) {
    float zero[CMAX];
#pragma unroll
    for (int ci = 0; ci < CMAX; ++ci) zero[ci] = 0.f;
    write(row + q, zero, 0.f, 0.f, 0.f, k > 0 ? slot_depth(make_float2(d0, dv0), pts[(row + q) * 4 + 3]) : 0.f);
  });

  for (int q0 = 0; q0 < n_q; q0 += 32) {
    if (q0 > 0) round_queries(w, vmask, row, p, q0, lane, [](int) {});
    const bool on = q0 + lane < n_q;
    const int64_t slot = row + (on ? w.round[lane] : 0);
    float az = 0.f, el = 0.f, gt = 0.f, t = 0.f;
    if (on) {
      az = pts[slot * 4];
      el = pts[slot * 4 + 1];
      gt = pts[slot * 4 + 2];
      t = pts[slot * 4 + 3];
    }
    const float before_depth = __fsub_rn(gt, depth_eps);
    // the first version's sums, in its order and contraction: w = T alpha,
    // FMAs for the feature and depth sums, plain sums for acc and until; the
    // running sum for the median an FMA of alpha and T (its second walk's)
    float trans = 1.f, acc_d = 0.f, acc_a = 0.f, acc_u = 0.f, run = 0.f;
    float acc_f[CMAX];
#pragma unroll
    for (int ci = 0; ci < CMAX; ++ci) acc_f[ci] = 0.f;
    int steps = 0;  // slots composited (some lane's alpha positive): one record each

    SlotEntry next = fetch_slot(tile_gauss, tile_valid, base, k, 0, lane);
    int n_cur = n_raw > 0 ? issue_lidar_chunk<CMAX>(w.stage[0], table, n_gauss, c, next, lane) : 0;
    next = fetch_slot(tile_gauss, tile_valid, base, k, 1, lane);
    for (int r = 0; r < n_raw; ++r) {
      int n_next = 0;
      if (r + 1 < n_raw) {
        n_next = issue_lidar_chunk<CMAX>(w.stage[(r + 1) & 1], table, n_gauss, c, next, lane);
        next = fetch_slot(tile_gauss, tile_valid, base, k, r + 2, lane);
        cp_async_wait<1>();  // this lane's copies of chunk r have landed ...
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();  // ... and every lane's
      const LidarStage<CMAX>& s = w.stage[r & 1];
      for (int j = 0; j < n_cur; ++j) {
        const float4 a0 = s.attr[j * LID_ATTR4], a1 = s.attr[j * LID_ATTR4 + 1], a2 = s.attr[j * LID_ATTR4 + 2];
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const SlotSigma sg = slot_sigma(a, az, el, t, wrap != 0);
        // beyond kFarSigma of every query, the slot gates to zero without the exp
        if (!__any_sync(kFullMask, on && !(a1.w <= 1.f && sg.sigma_raw > kFarSigma))) continue;
        const float alpha = gate_terms(a, sg, true, on).alpha;
        if (!__any_sync(kFullMask, alpha > 0.f)) continue;  // a zero alpha adds nothing to any sum
        const float wt = __fmul_rn(trans, alpha);
#pragma unroll
        for (int g4 = 0; g4 < G; ++g4) {
          const float4 f = s.feat[j * G + g4];
          acc_f[4 * g4] = __fmaf_rn(wt, f.x, acc_f[4 * g4]);
          acc_f[4 * g4 + 1] = __fmaf_rn(wt, f.y, acc_f[4 * g4 + 1]);
          acc_f[4 * g4 + 2] = __fmaf_rn(wt, f.z, acc_f[4 * g4 + 2]);
          acc_f[4 * g4 + 3] = __fmaf_rn(wt, f.w, acc_f[4 * g4 + 3]);
        }
        const float d = slot_depth(make_float2(a2.x, a2.y), t);
        acc_d = __fmaf_rn(wt, d, acc_d);
        acc_a = __fadd_rn(acc_a, wt);
        if (d < before_depth) acc_u = __fadd_rn(acc_u, wt);
        run = __fmaf_rn(alpha, trans, run);
        trans = __fmul_rn(trans, __fsub_rn(1.f, alpha));
        rec_sum[steps * 32 + lane] = run;
        if (lane == 0) rec_depth[steps] = make_float2(a2.x, a2.y);
        ++steps;
      }
      __syncwarp();  // buffer r & 1 is free for chunk r + 2, the records are visible
      n_cur = n_next;
    }

    // the median: the first slot whose running sum reaches half of acc. The
    // sums only grow, so a binary search over the records finds it; a slot
    // that was not composited changed no sum, so it is never the first.
    const float half = __fmul_rn(0.5f, acc_a);
    float med = 0.f;
    if (!(half > 0.f)) {
      med = k > 0 ? slot_depth(make_float2(d0, dv0), t) : 0.f;
    } else {
      int lo = 0, hi = steps;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (rec_sum[mid * 32 + lane] >= half) hi = mid;
        else lo = mid + 1;
      }
      if (lo < steps) med = slot_depth(rec_depth[lo], t);
    }
    if (on) write(slot, acc_f, acc_d, acc_a, acc_u, med);
    __syncwarp();  // the round's list and records are read before the next round writes them
  }
}

}  // namespace

// C interface (loaded with ctypes). Shapes: table [n_gauss, 10 + c],
// tile_gauss/tile_valid [n_tiles, k], pix [n_tiles, p, 2], times [n_tiles, p],
// outputs feat [n_tiles, p, c], depth/alpha [n_tiles, p]. c <= 32, p <= 1024.
// Returns cudaGetLastError() after the launch; the caller raises on non-zero.
extern "C" int tile_composite_camera_fwd(const float* table, int n_gauss, int c, const int* tile_gauss,
                                         const float* tile_valid, const float* pix, const float* times,
                                         int n_tiles, int p, int k, float* feat_out, float* depth_out,
                                         float* alpha_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(n_tiles), block(32 * min(CAM_WARPS, (p + 63) / 64));
  if (c <= 8) {
    camera_fwd_kernel<8><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, pix, times, p, k,
                                                 feat_out, depth_out, alpha_out);
  } else if (c <= 16) {
    camera_fwd_kernel<16><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, pix, times, p, k,
                                                  feat_out, depth_out, alpha_out);
  } else {
    camera_fwd_kernel<32><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, pix, times, p, k,
                                                  feat_out, depth_out, alpha_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// pts [n_tiles, p, 4] (azimuth, elevation, gt depth, time), vmask [n_tiles, p];
// outputs feat [n_tiles, p, c], depth/acc/until/median [n_tiles, p] (until:
// the line-of-sight sum, always computed); records: scratch of n_tiles * k *
// 34 floats. c <= 32, p <= 1024.
extern "C" int tile_composite_lidar_fwd(const float* table, int n_gauss, int c, const int* tile_gauss,
                                        const float* tile_valid, const float* pts, const float* vmask,
                                        int n_tiles, int p, int k, int wrap, float depth_eps, float* feat_out,
                                        float* depth_out, float* acc_out, float* until_out, float* med_out,
                                        float* records, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((n_tiles + LID_WARPS - 1) / LID_WARPS), block(32 * LID_WARPS);
  if (c <= 8) {
    lidar_fwd_kernel<8><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, pts, vmask, n_tiles, p, k,
                                                wrap, depth_eps, feat_out, depth_out, acc_out, until_out, med_out,
                                                records);
  } else if (c <= 16) {
    lidar_fwd_kernel<16><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, pts, vmask, n_tiles, p,
                                                 k, wrap, depth_eps, feat_out, depth_out, acc_out, until_out, med_out,
                                                 records);
  } else {
    lidar_fwd_kernel<32><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, pts, vmask, n_tiles, p,
                                                 k, wrap, depth_eps, feat_out, depth_out, acc_out, until_out, med_out,
                                                 records);
  }
  return static_cast<int>(cudaGetLastError());
}
