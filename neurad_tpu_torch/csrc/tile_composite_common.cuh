// Shared pieces of the per-tile gaussian composites (forward:
// tile_composite.cu, backward: tile_composite_bwd.cu): the shared-memory stage
// of a tile's gaussians, its loader, the per-pair alpha with the TPU kernels'
// clipping and gating, and the cp.async copies that double-buffer K2's and
// K3's stages. Forward and backward must take the same side
// of the 1/255 alpha gate, so both evaluate alpha with `slot_terms`.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_composite {

constexpr int ATTR = 10;  // mean xy, vel xy, conic abc, opacity, depth, depth velocity
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr int CHUNK = 256;  // slots staged in shared memory at a time

// CHUNK slots of one tile, staged in shared memory
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

// What one (slot, pixel) pair evaluates on the way to its alpha.
struct SlotTerms {
  float dx, dy;      // pixel minus rolling-shutter-warped mean (dx after the azimuth wrap)
  float sigma_raw;   // quadratic form before the [0, 50] clip
  float exp_neg;     // exp(-clipped sigma)
  float alpha_pre;   // opacity * exp_neg, before the [0, 0.999] clip and the gate
  float alpha;       // clipped and gated
};

// The pixel's offset from the slot's rolling-shutter-warped mean and the
// quadratic form before its clip: the first half of slot_terms.
struct SlotSigma {
  float dx, dy, sigma_raw;
};

// The gate is a discontinuity (alpha >= 1/255 or 0), so everything up to it is
// rounded op by op in the plain version's order (__f*_rn: no FMA contraction)
// and the kernels take the same side of the gate as the plain versions.
__device__ __forceinline__ SlotSigma slot_sigma(const float* __restrict__ a, float x, float y, float t, bool wrap) {
  float dx = __fsub_rn(x, __fadd_rn(a[0], __fmul_rn(a[2], t)));
  if (wrap) {
    float m = fmodf(__fadd_rn(dx, 180.f), 360.f);  // exact
    if (m < 0.f) m = __fadd_rn(m, 360.f);
    dx = __fsub_rn(m, 180.f);
  }
  float dy = __fsub_rn(y, __fadd_rn(a[1], __fmul_rn(a[3], t)));
  float quad = __fadd_rn(__fmul_rn(__fmul_rn(a[4], dx), dx), __fmul_rn(__fmul_rn(a[6], dy), dy));
  return SlotSigma{dx, dy, __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(a[5], dx), dy))};
}

// The clips and the gate: the second half of slot_terms.
__device__ __forceinline__ SlotTerms gate_terms(const float* __restrict__ a, const SlotSigma& sg, bool valid,
                                                bool slot_ok) {
  SlotTerms r;
  r.dx = sg.dx;
  r.dy = sg.dy;
  r.sigma_raw = sg.sigma_raw;
  float sigma = fminf(fmaxf(r.sigma_raw, 0.f), 50.f);
  r.exp_neg = expf(-sigma);
  r.alpha_pre = __fmul_rn(a[7], r.exp_neg);
  float alpha = fminf(fmaxf(r.alpha_pre, 0.f), 0.999f);
  if (!valid || !(alpha >= kMinAlpha) || !slot_ok) alpha = 0.f;
  r.alpha = alpha;
  return r;
}

__device__ __forceinline__ SlotTerms slot_terms(const float* __restrict__ a, bool valid, float x, float y, float t,
                                                bool wrap, bool slot_ok) {
  return gate_terms(a, slot_sigma(a, x, y, t, wrap), valid, slot_ok);
}

// A pair whose sigma_raw exceeds kFarSigma, of a slot whose opacity is at most
// 1, gates to alpha 0: exp(-5.6) = 0.00370 < 1/255 = 0.00392, a margin far
// beyond expf's rounding. (A NaN sigma_raw or opacity fails the comparisons.)
constexpr float kFarSigma = 5.6f;

// alpha of slot j at (x, y, t) with the TPU kernels' clipping and gating
template <int CMAX>
__device__ __forceinline__ float slot_alpha(const Stage<CMAX>& s, int j, float x, float y, float t,
                                            bool wrap, bool slot_ok) {
  return slot_terms(&s.attr[j * ATTR], s.valid[j] > 0.f, x, y, t, wrap, slot_ok).alpha;
}

// rolling-shutter-corrected depth of the slot whose packed attributes are at
// a, rounded like the plain version (it meets a comparison in the lidar
// line-of-sight sum)
__device__ __forceinline__ float slot_depth(const float* __restrict__ a, float t) {
  return __fadd_rn(a[8], __fmul_rn(a[9], t));
}

template <int CMAX>
__device__ __forceinline__ float slot_depth(const Stage<CMAX>& s, int j, float t) {
  return slot_depth(&s.attr[j * ATTR], t);
}

// cp.async: a 4-byte copy from global to shared memory that the thread does
// not wait for; commit closes the thread's group of copies, wait_group<N>
// waits until at most N of its groups are in flight.
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

inline int round_up_to_warp(int p) { return ((p + 31) / 32) * 32; }

}  // namespace tile_composite
