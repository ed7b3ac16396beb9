// Per-tile front-to-back gaussian compositing for Hopper (sm_90a).
//
// Replaces the two forward TPU kernels of neurad_tpu/ops/pallas_composite.py:
//   tile_composite_camera_fwd <- _composite_fwd_kernel (K2, launched by _run_fwd)
//   tile_composite_lidar_fwd  <- _make_lidar_fwd_kernel (K4, launched by run_lidar_fwd)
// Plain PyTorch versions of the same functions: neurad_tpu_torch/ops/tile_composite.py.
// The backward composites are in tile_composite_bwd.cu; the stage, its loader and
// the gated alpha they share are in tile_composite_common.cuh.
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
// in a patch that is not wholly beyond it still pays for its exp. K4 at full
// width (T = 3780, P = 128, K = 128) is the same loop plus the azimuth wrap,
// the line-of-sight sum and the median pass; it is smaller and also
// compute-bound.
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
// K4 keeps one thread a query slot over a 256-slot stage.
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
//    sum reaches half the total (slot 0 where the total is 0); a second pass
//    recomputes the weights and stops at that crossing.

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

template <int CMAX>
__global__ void __launch_bounds__(1024) lidar_fwd_kernel(
    const float* __restrict__ table, int n_gauss, int c, const int* __restrict__ tile_gauss,
    const float* __restrict__ tile_valid, const float* __restrict__ pts, const float* __restrict__ vmask,
    int p, int k, int wrap, float depth_eps, int compute_until, float* __restrict__ feat_out,
    float* __restrict__ depth_out, float* __restrict__ acc_out, float* __restrict__ until_out,
    float* __restrict__ med_out) {
  __shared__ Stage<CMAX> s;
  const int tile = blockIdx.x;
  const int q = threadIdx.x;
  const bool active = q < p;
  const int64_t slot = (int64_t)tile * p + q;
  float az = 0.f, el = 0.f, gt = 0.f, t = 0.f;
  bool slot_ok = false;
  if (active) {
    az = pts[slot * 4];
    el = pts[slot * 4 + 1];
    gt = pts[slot * 4 + 2];
    t = pts[slot * 4 + 3];
    slot_ok = vmask[slot] > 0.f;
  }
  const float before_depth = __fsub_rn(gt, depth_eps);
  float trans = 1.f, acc_d = 0.f, acc_a = 0.f, acc_u = 0.f;
  float acc_f[CMAX];
#pragma unroll
  for (int ci = 0; ci < CMAX; ++ci) acc_f[ci] = 0.f;

  for (int k0 = 0; k0 < k; k0 += CHUNK) {
    const int n = min(CHUNK, k - k0);
    __syncthreads();
    load_chunk<CMAX>(s, table, n_gauss, c, tile_gauss, tile_valid, tile, k, k0, n);
    if (!active || !slot_ok) continue;  // a masked query slot composites nothing
    for (int j = 0; j < n; ++j) {
      if (!(s.valid[j] > 0.f)) continue;
      float alpha = slot_alpha<CMAX>(s, j, az, el, t, wrap != 0, slot_ok);
      float w = alpha * trans;
      const float* f = &s.feat[j * CMAX];
#pragma unroll
      for (int ci = 0; ci < CMAX; ++ci) acc_f[ci] += w * f[ci];
      float gd = slot_depth<CMAX>(s, j, t);
      acc_d += w * gd;
      acc_a += w;
      if (compute_until && gd < before_depth) acc_u += w;
      trans *= (1.f - alpha);
    }
  }

  // median pass: recompute the weights in the same order (so the running sum
  // ends at exactly acc_a) and stop at the first slot reaching half of it
  const float half = 0.5f * acc_a;
  float med = 0.f, cum = 0.f;
  bool found = !active || k == 0;
  trans = 1.f;
  for (int k0 = 0; k0 < k; k0 += CHUNK) {
    if (!__syncthreads_or(!found)) break;
    const int n = min(CHUNK, k - k0);
    if (k > CHUNK) load_chunk<CMAX>(s, table, n_gauss, c, tile_gauss, tile_valid, tile, k, k0, n);
    for (int j = 0; j < n && !found; ++j) {
      float alpha = slot_alpha<CMAX>(s, j, az, el, t, wrap != 0, slot_ok);
      cum += alpha * trans;
      trans *= (1.f - alpha);
      if (cum >= half) {
        med = slot_depth<CMAX>(s, j, t);
        found = true;
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int ci = 0; ci < CMAX; ++ci) {
    if (ci < c) feat_out[slot * c + ci] = acc_f[ci];
  }
  depth_out[slot] = acc_d;
  acc_out[slot] = acc_a;
  until_out[slot] = compute_until ? acc_u : 0.f;
  med_out[slot] = med;
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
// outputs feat [n_tiles, p, c], depth/acc/until/median [n_tiles, p].
extern "C" int tile_composite_lidar_fwd(const float* table, int n_gauss, int c, const int* tile_gauss,
                                        const float* tile_valid, const float* pts, const float* vmask,
                                        int n_tiles, int p, int k, int wrap, float depth_eps, int compute_until,
                                        float* feat_out, float* depth_out, float* acc_out, float* until_out,
                                        float* med_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(n_tiles), block(round_up_to_warp(p));
  if (c <= 8) {
    lidar_fwd_kernel<8><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, pts, vmask, p, k, wrap,
                                                depth_eps, compute_until, feat_out, depth_out, acc_out, until_out,
                                                med_out);
  } else if (c <= 16) {
    lidar_fwd_kernel<16><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, pts, vmask, p, k, wrap,
                                                 depth_eps, compute_until, feat_out, depth_out, acc_out, until_out,
                                                 med_out);
  } else {
    lidar_fwd_kernel<32><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, pts, vmask, p, k, wrap,
                                                 depth_eps, compute_until, feat_out, depth_out, acc_out, until_out,
                                                 med_out);
  }
  return static_cast<int>(cudaGetLastError());
}
