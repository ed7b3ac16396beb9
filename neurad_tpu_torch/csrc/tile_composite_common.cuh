// Shared pieces of the per-tile gaussian composites (forward:
// tile_composite.cu, backward: tile_composite_bwd.cu): the per-pair alpha with
// the TPU kernels' clipping and gating, the cp.async copies that double-buffer
// the stages, and the lidar kernels' (K4, K5) warp-per-tile stage, its loader
// and their query rounds. Forward and backward must take the same side of the
// 1/255 alpha gate, so both evaluate alpha with `slot_terms`.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace tile_composite {

constexpr int ATTR = 10;  // mean xy, vel xy, conic abc, opacity, depth, depth velocity
constexpr float kMinAlpha = 1.0f / 255.0f;

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
    const float v = __fadd_rn(dx, 180.f);
    // fmodf is exact, and the identity on [0, 360): called only for the pairs across the seam
    float m = (v >= 0.f && v < 360.f) ? v : fmodf(v, 360.f);
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

// rolling-shutter-corrected depth of the slot whose packed attributes are at
// a, rounded like the plain version (it meets a comparison in the lidar
// line-of-sight sum)
__device__ __forceinline__ float slot_depth(const float* __restrict__ a, float t) {
  return __fadd_rn(a[8], __fmul_rn(a[9], t));
}

// the same from the slot's (depth, depth velocity)
__device__ __forceinline__ float slot_depth(float2 d, float t) { return __fadd_rn(d.x, __fmul_rn(d.y, t)); }

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

// ---------------------------------------------------------------------------
// The lidar composites (K4, K5): a warp owns a tile. It walks the tile's valid
// query slots 32 at a time (one a lane, compacted) over the tile's valid
// gaussian slots, compacted and staged LID_CHUNK at a time in two buffers of
// its own.
// ---------------------------------------------------------------------------

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int LID_WARPS = 4;   // warps a block: one tile each
constexpr int LID_CHUNK = 16;  // gaussian slots in each of a warp's two stage buffers
constexpr int LID_ATTR4 = 3;   // float4s of a slot's attributes

// Up to LID_CHUNK valid slots of one tile, compacted, as float4s: (mean x,
// mean y, vel x, vel y), (conic a, b, c, opacity), (depth, depth vel, index
// entry as given (int bits), -), then the CMAX features (columns c .. CMAX - 1
// zero).
template <int CMAX>
struct LidarStage {
  float4 attr[LID_CHUNK * LID_ATTR4];
  float4 feat[LID_CHUNK * (CMAX / 4)];
};

// A warp's shared memory: its two stage buffers and the query slots of its round.
template <int CMAX>
struct LidarWarp {
  LidarStage<CMAX> stage[2];
  int round[32];
};

// Zero feature columns c .. CMAX - 1 of both stage buffers (the copies never write them).
template <int CMAX>
__device__ __forceinline__ void zero_feature_padding(LidarWarp<CMAX>& w, int c, int lane) {
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    for (int e = lane; e < LID_CHUNK * CMAX; e += 32) {
      if ((e % CMAX) >= c) reinterpret_cast<float*>(w.stage[b].feat)[e] = 0.f;
    }
  }
}

// Lane `lane`'s raw gaussian slot in chunk r (slots LID_CHUNK r .. + LID_CHUNK - 1)
// of the tile whose index list starts at `base` (lanes LID_CHUNK .. 31 hold
// none): whether it is valid, and its index entry. Plain loads, issued a chunk
// before their use.
struct SlotEntry {
  bool valid;
  int gauss;
};

__device__ __forceinline__ SlotEntry fetch_slot(const int* __restrict__ tile_gauss,
                                                const float* __restrict__ tile_valid, int64_t base, int k, int r,
                                                int lane) {
  const int j = r * LID_CHUNK + lane;
  SlotEntry e{false, 0};
  if (lane < LID_CHUNK && j < k) {
    e.valid = tile_valid[base + j] > 0.f;
    e.gauss = tile_gauss[base + j];
  }
  return e;
}

// Start the copy of a chunk's valid slots into s, compacted in slot order:
// the lane of each valid slot copies the slot's row (cp.async) and writes its
// index entry; every lane commits one group. Returns the number of slots
// staged. (Spreading a row's columns over the lanes, a row at a time, took
// more instructions and was slower in both kernels on an NVIDIA H100.)
template <int CMAX>
__device__ __forceinline__ int issue_lidar_chunk(LidarStage<CMAX>& s, const float* __restrict__ table, int n_gauss,
                                                 int c, SlotEntry e, int lane) {
  const unsigned staged = __ballot_sync(kFullMask, e.valid);
  if (e.valid) {
    const int j = __popc(staged & ((1u << lane) - 1u));
    const int width = ATTR + c;
    const float* row = table + (int64_t)min(max(e.gauss, 0), n_gauss - 1) * width;
    float* attr = reinterpret_cast<float*>(s.attr + j * LID_ATTR4);
    float* feat = reinterpret_cast<float*>(s.feat + j * (CMAX / 4));
#pragma unroll
    for (int col = 0; col < ATTR; ++col) cp_async4(attr + col, row + col);
    for (int col = 0; col < c; ++col) cp_async4(feat + col, row + ATTR + col);
    attr[10] = __int_as_float(e.gauss);
  }
  cp_async_commit();
  return __popc(staged);
}

// Fill w.round with the tile's valid query slots (vmask > 0) of ranks q0 ..
// q0 + 31 in slot order; returns the number of valid query slots. `masked(q)`
// is called by the lane of each masked slot q.
template <int CMAX, typename Masked>
__device__ __forceinline__ int round_queries(LidarWarp<CMAX>& w, const float* __restrict__ vmask, int64_t row, int p,
                                             int q0, int lane, Masked masked) {
  int n = 0;
  for (int c0 = 0; c0 < p; c0 += 32) {
    const int q = c0 + lane;
    const bool in = q < p;
    const bool valid = in && vmask[row + q] > 0.f;
    const unsigned m = __ballot_sync(kFullMask, valid);
    const int rank = n + __popc(m & ((1u << lane) - 1u));
    if (valid && rank >= q0 && rank < q0 + 32) w.round[rank - q0] = q;
    if (in && !valid) masked(q);
    n += __popc(m);
  }
  __syncwarp();
  return n;
}

}  // namespace tile_composite
