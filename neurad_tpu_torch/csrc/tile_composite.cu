// Per-tile front-to-back gaussian compositing for Hopper (sm_90a).
//
// Replaces the two forward TPU kernels of neurad_tpu/ops/pallas_composite.py:
//   tile_composite_camera_fwd <- _composite_fwd_kernel (K2, launched by _run_fwd)
//   tile_composite_lidar_fwd  <- _make_lidar_fwd_kernel (K4, launched by run_lidar_fwd)
// Plain PyTorch versions of the same functions: neurad_tpu_torch/ops/tile_composite.py.
//
// Inputs. Unlike the TPU kernels, which take pre-gathered [T, K, ...] arrays,
// these read the per-gaussian packed table [N, 10 + C] (mean xy, vel xy,
// conic abc, opacity, depth, depth velocity, C features) through the tile's
// index list tile_gauss [T, K], so the gathered [T, K, 10 + C] copy never
// exists in device memory. Index entries are clamped into [0, N).
//
// What bounds it. K2 at full width (1920x1080, T = 8160 tiles, P = 256
// pixels, K = 256 slots, C = 16) evaluates T*P*K = 5.35e8 gaussian-pixel pairs
// of about 64 fp32 operations each (FMA counted as two): 3.4e10 operations,
// 0.51 ms at the H100 SXM's 67 TFLOP/s fp32 rate outside the tensor cores.
// It must move about 0.2 GB (index lists, pixel coordinates, the table rows it
// uses, the outputs): about 0.06 ms at 3.35 TB/s. So fp32 issue binds, and
// the one exp per pair runs on the special-function units. K4 at full width
// (T = 3780, P = 128, K = 128) is the same loop plus the azimuth wrap, the
// line-of-sight sum and the median pass; it is smaller and also compute-bound.
//
// What the design does about it. One thread block per tile and one thread per
// pixel (camera) or per query slot (lidar). The block copies the tile's
// gaussians into shared memory in chunks of CHUNK slots; every thread then
// reads the same slot at the same time (a broadcast) and walks the slots front
// to back carrying transmittance, the C feature sums, depth and alpha in
// registers. No per-pair value touches device memory and there is no prefix
// scan: the serial loop is the scan. Transcendentals use expf (not __expf) and
// all arithmetic is fp32, as in the TPU kernels.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ATTR = 10;    // mean xy, vel xy, conic abc, opacity, depth, depth velocity
constexpr int CHUNK = 256;  // slots staged in shared memory at a time
constexpr float kMinAlpha = 1.0f / 255.0f;

template <int CMAX>
struct Stage {
  float attr[CHUNK * ATTR];
  float feat[CHUNK * CMAX];
  float valid[CHUNK];
  int idx[CHUNK];
};

// Copy slots [k0, k0 + n) of `tile` into shared memory (all threads call it).
template <int CMAX>
__device__ void load_chunk(Stage<CMAX>& s, const float* __restrict__ table, int n_gauss, int c,
                           const int* __restrict__ tile_gauss, const float* __restrict__ tile_valid,
                           int tile, int k, int k0, int n) {
  const int width = ATTR + c;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    int g = tile_gauss[(int64_t)tile * k + k0 + j];
    s.idx[j] = min(max(g, 0), n_gauss - 1);
    s.valid[j] = tile_valid[(int64_t)tile * k + k0 + j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n * width; e += blockDim.x) {
    int j = e / width;
    int col = e - j * width;
    float v = table[(int64_t)s.idx[j] * width + col];
    if (col < ATTR) {
      s.attr[j * ATTR + col] = v;
    } else {
      s.feat[j * CMAX + col - ATTR] = v;
    }
  }
  for (int e = threadIdx.x; e < n * (CMAX - c); e += blockDim.x) {
    int j = e / (CMAX - c);
    s.feat[j * CMAX + c + (e - j * (CMAX - c))] = 0.f;
  }
  __syncthreads();
}

// alpha of slot j at (x, y, t) with the TPU kernels' clipping and gating.
// The gate is a discontinuity (alpha >= 1/255 or 0), so everything up to it is
// rounded op by op in the plain version's order (__f*_rn: no FMA contraction)
// and the kernel takes the same side of the gate as the plain version.
template <int CMAX>
__device__ __forceinline__ float slot_alpha(const Stage<CMAX>& s, int j, float x, float y, float t,
                                            bool wrap, bool slot_ok) {
  const float* a = &s.attr[j * ATTR];
  float dx = __fsub_rn(x, __fadd_rn(a[0], __fmul_rn(a[2], t)));
  if (wrap) {
    float m = fmodf(__fadd_rn(dx, 180.f), 360.f);  // exact
    if (m < 0.f) m = __fadd_rn(m, 360.f);
    dx = __fsub_rn(m, 180.f);
  }
  float dy = __fsub_rn(y, __fadd_rn(a[1], __fmul_rn(a[3], t)));
  float quad = __fadd_rn(__fmul_rn(__fmul_rn(a[4], dx), dx), __fmul_rn(__fmul_rn(a[6], dy), dy));
  float sigma = __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(a[5], dx), dy));
  sigma = fminf(fmaxf(sigma, 0.f), 50.f);
  float alpha = fminf(fmaxf(__fmul_rn(a[7], expf(-sigma)), 0.f), 0.999f);
  if (!(s.valid[j] > 0.f) || !(alpha >= kMinAlpha) || !slot_ok) alpha = 0.f;
  return alpha;
}

// rolling-shutter-corrected depth of slot j, rounded like the plain version
// (it meets a comparison in the lidar line-of-sight sum)
template <int CMAX>
__device__ __forceinline__ float slot_depth(const Stage<CMAX>& s, int j, float t) {
  const float* a = &s.attr[j * ATTR];
  return __fadd_rn(a[8], __fmul_rn(a[9], t));
}

template <int CMAX>
__global__ void __launch_bounds__(1024) camera_fwd_kernel(
    const float* __restrict__ table, int n_gauss, int c, const int* __restrict__ tile_gauss,
    const float* __restrict__ tile_valid, const float* __restrict__ pix, const float* __restrict__ times,
    int p, int k, float* __restrict__ feat_out, float* __restrict__ depth_out, float* __restrict__ alpha_out) {
  __shared__ Stage<CMAX> s;
  const int tile = blockIdx.x;
  const int q = threadIdx.x;
  const bool active = q < p;
  const int64_t slot = (int64_t)tile * p + q;
  float x = 0.f, y = 0.f, t = 0.f;
  if (active) {
    x = pix[slot * 2];
    y = pix[slot * 2 + 1];
    t = times[slot];
  }
  float trans = 1.f, acc_d = 0.f, acc_a = 0.f;
  float acc_f[CMAX];
#pragma unroll
  for (int ci = 0; ci < CMAX; ++ci) acc_f[ci] = 0.f;

  for (int k0 = 0; k0 < k; k0 += CHUNK) {
    const int n = min(CHUNK, k - k0);
    __syncthreads();  // the previous chunk is no longer read
    load_chunk<CMAX>(s, table, n_gauss, c, tile_gauss, tile_valid, tile, k, k0, n);
    if (!active) continue;
    for (int j = 0; j < n; ++j) {
      if (!(s.valid[j] > 0.f)) continue;  // alpha 0: adds nothing (same j in every thread)
      float alpha = slot_alpha<CMAX>(s, j, x, y, t, false, true);
      float w = alpha * trans;
      const float* f = &s.feat[j * CMAX];
#pragma unroll
      for (int ci = 0; ci < CMAX; ++ci) acc_f[ci] += w * f[ci];
      acc_d += w * slot_depth<CMAX>(s, j, t);
      acc_a += w;
      trans *= (1.f - alpha);
    }
  }
  if (!active) return;
#pragma unroll
  for (int ci = 0; ci < CMAX; ++ci) {
    if (ci < c) feat_out[slot * c + ci] = acc_f[ci];
  }
  depth_out[slot] = acc_d;
  alpha_out[slot] = acc_a;
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

int block_threads(int p) { return ((p + 31) / 32) * 32; }

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
  dim3 grid(n_tiles), block(block_threads(p));
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
  dim3 grid(n_tiles), block(block_threads(p));
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
