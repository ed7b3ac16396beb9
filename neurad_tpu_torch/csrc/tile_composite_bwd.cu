// Fused backward of the per-tile gaussian composites for Hopper (sm_90a).
//
// Replaces the two backward TPU kernels of neurad_tpu/ops/pallas_composite.py:
//   tile_composite_camera_bwd <- _composite_bwd_kernel (K3, launched by _run_bwd)
//   tile_composite_lidar_bwd  <- _make_lidar_bwd_kernel (K5, launched by run_lidar_bwd)
// Plain PyTorch versions of the same functions: neurad_tpu_torch/ops/tile_composite.py
// (tile_composite_camera_bwd_plain, tile_composite_lidar_bwd_plain).
//
// What it computes. With w_k = a_k T_k (T_k the transmittance in front of slot
// k) and the per-pixel payload gradient
//   g_k = <gF, f_k> + gD d_k + gA (+ [d_k < gt - eps] gU for the lidar's
//         line-of-sight sum),
// the gradient of alpha is
//   dL/da_k = T_k g_k - (G - P_k) / (1 - a_k),
// P_k the inclusive prefix of w_j g_j in depth order and G its total. It is
// zero where the forward's clips and gate are flat: slot invalid, query slot
// masked, alpha_pre < 1/255, alpha_pre >= 0.999, sigma_raw <= 0 or >= 50.
// (1 - a_k) >= 0.001 always. From it follow the gradients of the ten packed
// attributes (mean xy, vel xy, conic abc, opacity, depth, depth velocity) and
// w_k gF for the C features, each summed over the tile's pixels. The lidar's
// median depth gets no gradient, nor do pixel coordinates, times, query
// points or masks.
//
// Output. Unlike the TPU kernels, which write per-tile [T, K, 10] and
// [T, K, C] gradients that XLA then scatter-adds, these add straight into the
// gradient of the packed table d_table [N, 10 + C] at tile_gauss[tile, k]: the
// backward of the gather is fused as the forward fused the gather, and the
// [T, K, 10 + C] per-tile gradient never exists. The caller zero-fills
// d_table. Invalid slots add nothing, and neither does an index entry outside
// [0, N) (the forward reads the clamped row for it).
//
// What bounds it. K3 at full width (T = 8160, P = 256, K = 256, C = 16) has
// up to T*P*K = 5.35e8 (pixel, slot) pairs. The function needs roughly 150
// fp32 operations a pair (alpha ~30, the payload gradient 2C + 4, the gradient
// terms ~45 + C, the 26-column sum over pixels): 8e10 operations, 1.2 ms at
// 67 TFLOP/s. Bytes are small beside that: the forward's 0.2 GB plus the
// cotangents (0.15 GB) plus the atomic traffic into d_table (up to
// T*K*26*4 B = 0.22 GB, read and written), about 0.25 ms at 3.35 TB/s. So
// fp32 arithmetic binds, and after it the reduction over a block's pixels
// (shuffles) and the atomics on hot rows. K5 at full width (T = 3780, P = 128,
// K = 128, C = 16) has 127 valid gaussian slots a tile but 17 valid query
// slots (at most 24, filled from slot 0): 8.3e6 valid pairs, 38% past the
// gate, 6e8 operations of least work. Bytes bind there (the valid queries'
// inputs, the forward's outputs and cotangents, the rows the slots use, the
// table's gradient written once: 73 MB, 0.022 ms); what holds a kernel back
// is the work it issues for each (tile, slot) step: each query's K slot steps
// depend on each other, and a tile has few queries to spread over lanes.
//
// What the designs share. A thread holds a pixel's or query's cotangents in
// registers and walks the slots front to back, carrying T_k and
// P_k; for each slot a warp whose 32 pixels all have alpha 0 skips it (every
// term is then zero), the others reduce their 10 + C per-pixel terms over the
// warp with a transposing butterfly (31 shuffles for 32 columns instead of 5
// each: after it lane l holds column l's sum), and lane l adds column l to
// d_table with one global atomicAdd (a reduction at the L2: the warp's 10 + C
// lanes hit consecutive addresses of one row). So a row receives one add per
// warp that touches it. The gated alpha is the
// forward's `slot_terms`, so both take the same side of the 1/255 step. A
// first version summed the warps of a block in shared memory before going to
// global memory; shared-memory float atomics on addresses that eight warps
// share took most of the kernel's time. Atomics make the order of these fp32
// sums vary from run to run.
//
// K3 (camera): one block per tile, one thread per pixel (a tile with more is
// walked in rounds of 256), one walk of the pairs. G is not recomputed: the forward kernel
// writes the raw sums feat = sum_k w_k f_k, depth = sum_k w_k d_k and
// alpha = sum_k w_k (no early termination, no normalisation), so
//   G = <gF, feat> + gD depth + gA alpha
// per pixel, and the autograd function hands the forward's outputs to the
// backward. That removes a second walk of every pair (the forward loop again,
// about 70 of the ~220 operations a pair). The slots stream through two
// shared-memory buffers of CAM_CHUNK slots: the next chunk's packed
// attributes, validity and index entries are copied with cp.async while the
// current chunk is composited. The carry stays front to back: a back-to-front
// walk (gsplat's order) needs T_k = T_{k+1} / (1 - a_k) from T_final =
// 1 - alpha, which is lost once T_final underflows (0.001^13 is below fp32's
// normal range); front to back, the cancellation in G - P_k is rounding of
// sums of the same |w_j g_j| terms the tolerance is stated in.
//
// K5 (lidar): one walk too, a warp a tile, as K4. Its first version ran a
// block a tile and a thread a query slot (one busy warp of four), over a
// 256-slot stage loaded with 4-byte loads between barriers, and walked the
// slots twice: the first walk was the forward loop again, only for G. Now:
//  * G from K4's outputs, the line-of-sight sum's included:
//      G = <gF, feat> + gD depth + gA acc + gU until,
//    since K4 writes raw sums and until = sum_k w_k [d_k < gt - eps]. The
//    autograd function saves that sum even where the caller asked for none
//    (K4 always computes it): the until cotangent enters g_k either way, as
//    in JAX's backward;
//  * a warp owns a tile (four a block) and gives its lanes to the valid query
//    slots only, compacted by a ballot over vmask (rounds of 32 where a tile
//    holds more); the valid gaussian slots, compacted, stream through two
//    16-slot float4 stage buffers filled with cp.async (K4's loader);
//  * a slot beyond kFarSigma of every query skips the exp, one whose alpha
//    no query passes the gate the whole pair work and the butterfly.
// Like K4 it is bound at full width by the SMs' instruction issue (four tiles
// an SM take two fifths of the full grid's time, chip_smoke.py): a composited
// slot costs the alpha, the gradient terms and a 31-shuffle butterfly on
// warps whose lanes are half idle. Its 76 registers a thread give the grid
// 1.2 waves; 64 spilled, and keeping the feature cotangents in shared memory
// to fit them gained nothing measurable on an NVIDIA H100.

#include "tile_composite_common.cuh"

namespace {

using namespace tile_composite;

constexpr int MAX_THREADS = 256;  // a tile with more pixels is walked in rounds of 256
constexpr int CAM_CHUNK = 128;    // slots in each of K3's two stage buffers

// One step of the transposing butterfly: lanes whose bit S is set keep the
// upper S of the 2 S remaining columns and send the lower S, the others the
// reverse. (A template, so that every index into v is a constant and v stays
// in registers.)
template <int S>
__device__ __forceinline__ void fold(float (&v)[32], int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    float send = upper ? v[i] : v[i + S];
    float keep = upper ? v[i + S] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

// Sum each of the 32 columns v[0..31] over the warp's 32 lanes; returns, in
// lane l, the sum of column l: 16 + 8 + 4 + 2 + 1 shuffles.
__device__ __forceinline__ float warp_sum_columns(float (&v)[32], int lane) {
  fold<16>(v, lane);
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  return v[0];
}

// The 10 + C column terms of one (pixel, slot) pair whose alpha passed the
// gate, given the pair's payload gradient g; carries the pixel's P_k (prefix)
// and T_k (trans) past the slot.
template <int CMAX, int ROUNDS>
__device__ __forceinline__ void pair_terms(const float* __restrict__ a, const SlotTerms& st, float g, float t,
                                           float gd, const float (&gf)[CMAX], float total, float& prefix,
                                           float& trans, float (&v)[ROUNDS][32]) {
  const float w = st.alpha * trans;
  prefix += w * g;
  const bool flat = !(st.alpha_pre < 0.999f) || !(st.sigma_raw > 0.f) || !(st.sigma_raw < 50.f);
  const float d_alpha = flat ? 0.f : trans * g - (total - prefix) / (1.f - st.alpha);
  const float d_sigma = -st.alpha * d_alpha;
  const float ddx = d_sigma * (a[4] * st.dx + a[5] * st.dy);
  const float ddy = d_sigma * (a[6] * st.dy + a[5] * st.dx);
  const float w_gd = w * gd;
  v[0][0] = -ddx;
  v[0][1] = -ddy;
  v[0][2] = -ddx * t;
  v[0][3] = -ddy * t;
  v[0][4] = 0.5f * st.dx * st.dx * d_sigma;
  v[0][5] = st.dx * st.dy * d_sigma;
  v[0][6] = 0.5f * st.dy * st.dy * d_sigma;
  v[0][7] = d_alpha * st.exp_neg;
  v[0][8] = w_gd;
  v[0][9] = w_gd * t;
#pragma unroll
  for (int ci = 0; ci < CMAX; ++ci) v[(ATTR + ci) / 32][(ATTR + ci) % 32] = w * gf[ci];
  trans *= (1.f - st.alpha);
}

// Sum the pair terms over the warp and add column l (lane l) to the slot's row.
template <int ROUNDS>
__device__ __forceinline__ void add_columns(float (&v)[ROUNDS][32], int lane, int width, int row,
                                            float* __restrict__ d_table) {
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    float sum = warp_sum_columns(v[r], lane);
    const int col = r * 32 + lane;
    if (col < width && row >= 0 && sum != 0.f) atomicAdd(&d_table[(int64_t)row * width + col], sum);
  }
}

// ---------------------------------------------------------------------------
// K3: camera, one pass, the stage double-buffered with cp.async
// ---------------------------------------------------------------------------

// CAM_CHUNK slots of one tile in shared memory
template <int CMAX>
struct CamStage {
  float attr[CAM_CHUNK * ATTR];
  float feat[CAM_CHUNK * CMAX];
  float valid[CAM_CHUNK];
  int gauss[CAM_CHUNK];  // the index list's entries as given (unclamped)
};

// Start the copy of slots [k0, k0 + n) of the tile whose index list starts at
// `base` into s: every thread issues its share and commits one group.
template <int CMAX>
__device__ __forceinline__ void issue_chunk(CamStage<CMAX>& s, const float* __restrict__ table, int n_gauss, int c,
                                            const int* __restrict__ tile_gauss, const float* __restrict__ tile_valid,
                                            int64_t base, int k0, int n) {
  const int width = ATTR + c;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    cp_async4(&s.gauss[j], tile_gauss + base + k0 + j);
    cp_async4(&s.valid[j], tile_valid + base + k0 + j);
  }
  for (int e = threadIdx.x; e < n * width; e += blockDim.x) {
    const int j = e / width;
    const int col = e - j * width;
    const int g = min(max(__ldg(tile_gauss + base + k0 + j), 0), n_gauss - 1);
    float* dst = col < ATTR ? &s.attr[j * ATTR + col] : &s.feat[j * CMAX + col - ATTR];
    cp_async4(dst, table + (int64_t)g * width + col);
  }
  cp_async_commit();
}

template <int CMAX>
__global__ void __launch_bounds__(MAX_THREADS) camera_bwd_kernel(
    const float* __restrict__ table, int n_gauss, int c, const int* __restrict__ tile_gauss,
    const float* __restrict__ tile_valid, const float* __restrict__ pix, const float* __restrict__ times, int p,
    int k, const float* __restrict__ feat_out, const float* __restrict__ depth_out,
    const float* __restrict__ alpha_out, const float* __restrict__ g_feat, const float* __restrict__ g_depth,
    const float* __restrict__ g_alpha, float* __restrict__ d_table) {
  constexpr int ROUNDS = (ATTR + CMAX + 31) / 32;  // 32-column groups of the 10 + C terms
  __shared__ CamStage<CMAX> stage[2];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int width = ATTR + c;
  const int64_t base = (int64_t)tile * k;
  const int n_chunks = (k + CAM_CHUNK - 1) / CAM_CHUNK;

  // feature columns c .. CMAX - 1 stay zero in both buffers: the copies never write them (made visible to
  // every thread by the first chunk's barrier)
  const int pad = CMAX - c;
  for (int e = threadIdx.x; e < 2 * CAM_CHUNK * pad; e += blockDim.x) {
    const int b = e / (CAM_CHUNK * pad);
    const int r = e - b * (CAM_CHUNK * pad);
    const int j = r / pad;
    stage[b].feat[j * CMAX + c + (r - j * pad)] = 0.f;
  }

  for (int q0 = 0; q0 < p; q0 += blockDim.x) {
    issue_chunk<CMAX>(stage[0], table, n_gauss, c, tile_gauss, tile_valid, base, 0, min(CAM_CHUNK, k));
    const int q = q0 + threadIdx.x;
    const bool active = q < p;
    const int64_t slot = (int64_t)tile * p + q;
    float x = 0.f, y = 0.f, t = 0.f, gd = 0.f, ga = 0.f, total = 0.f;
    float gf[CMAX];
#pragma unroll
    for (int ci = 0; ci < CMAX; ++ci) gf[ci] = 0.f;
    if (active) {
      x = pix[slot * 2];
      y = pix[slot * 2 + 1];
      t = times[slot];
      gd = g_depth[slot];
      ga = g_alpha[slot];
      // G = sum_k w_k g_k from the forward's raw sums
      total = ga * alpha_out[slot] + gd * depth_out[slot];
#pragma unroll
      for (int ci = 0; ci < CMAX; ++ci) {
        if (ci < c) {
          gf[ci] = g_feat[slot * c + ci];
          total += gf[ci] * feat_out[slot * c + ci];
        }
      }
    }

    float prefix = 0.f, trans = 1.f;
    for (int r = 0; r < n_chunks; ++r) {
      if (r + 1 < n_chunks) {
        const int k1 = (r + 1) * CAM_CHUNK;
        issue_chunk<CMAX>(stage[(r + 1) & 1], table, n_gauss, c, tile_gauss, tile_valid, base, k1,
                          min(CAM_CHUNK, k - k1));
        cp_async_wait<1>();  // this thread's copies of chunk r have landed ...
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // ... and every thread's
      const CamStage<CMAX>& s = stage[r & 1];
      const int n = min(CAM_CHUNK, k - r * CAM_CHUNK);
      for (int j = 0; j < n; ++j) {
        if (!(s.valid[j] > 0.f)) continue;  // same j in every thread
        const float* a = &s.attr[j * ATTR];
        SlotTerms st = slot_terms(a, true, x, y, t, false, active);
        if (!__any_sync(0xffffffffu, st.alpha > 0.f)) continue;  // every term of this warp is zero
        float v[ROUNDS][32];
#pragma unroll
        for (int rr = 0; rr < ROUNDS; ++rr) {
#pragma unroll
          for (int i = 0; i < 32; ++i) v[rr][i] = 0.f;
        }
        if (st.alpha > 0.f) {
          const float* f = &s.feat[j * CMAX];
          float g = ga + gd * slot_depth(a, t);
#pragma unroll
          for (int ci = 0; ci < CMAX; ++ci) g += gf[ci] * f[ci];
          pair_terms<CMAX, ROUNDS>(a, st, g, t, gd, gf, total, prefix, trans, v);
        }
        const int gauss = s.gauss[j];
        add_columns<ROUNDS>(v, lane, width, (gauss >= 0 && gauss < n_gauss) ? gauss : -1, d_table);
      }
      __syncthreads();  // buffer r & 1 is free for chunk r + 2
    }
  }
}

// ---------------------------------------------------------------------------
// K5: lidar, one pass, a warp a tile over its valid query and gaussian slots
// ---------------------------------------------------------------------------

// coords = pts [T, P, 4] (azimuth, elevation, gt depth, time), aux = vmask [T, P];
// feat_out .. until_out: the forward's outputs on the same inputs (G follows from them).
template <int CMAX>
__global__ void __launch_bounds__(LID_WARPS * 32) lidar_bwd_kernel(
    const float* __restrict__ table, int n_gauss, int c, const int* __restrict__ tile_gauss,
    const float* __restrict__ tile_valid, const float* __restrict__ coords, const float* __restrict__ aux,
    int n_tiles, int p, int k, int wrap, float depth_eps, const float* __restrict__ feat_out,
    const float* __restrict__ depth_out, const float* __restrict__ acc_out, const float* __restrict__ until_out,
    const float* __restrict__ g_feat, const float* __restrict__ g_depth, const float* __restrict__ g_alpha,
    const float* __restrict__ g_until, float* __restrict__ d_table) {
  constexpr int ROUNDS = (ATTR + CMAX + 31) / 32;  // 32-column groups of the 10 + C terms
  constexpr int G = CMAX / 4;                      // float4s of a slot's features
  __shared__ LidarWarp<CMAX> warps[LID_WARPS];
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * LID_WARPS + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;  // a whole warp: the kernel has no block barrier
  LidarWarp<CMAX>& w = warps[threadIdx.x >> 5];
  const int64_t base = (int64_t)tile * k, row = (int64_t)tile * p;
  const int width = ATTR + c;
  const int n_raw = (k + LID_CHUNK - 1) / LID_CHUNK;
  zero_feature_padding<CMAX>(w, c, lane);
  auto none = [](int) {};  // a masked query slot adds nothing
  const int n_q = round_queries(w, aux, row, p, 0, lane, none);

  for (int q0 = 0; q0 < n_q; q0 += 32) {
    if (q0 > 0) round_queries(w, aux, row, p, q0, lane, none);
    const bool on = q0 + lane < n_q;
    const int64_t slot = row + (on ? w.round[lane] : 0);
    float x = 0.f, y = 0.f, gt = 0.f, t = 0.f, gd = 0.f, ga = 0.f, gu = 0.f, total = 0.f;
    float gf[CMAX];
#pragma unroll
    for (int ci = 0; ci < CMAX; ++ci) gf[ci] = 0.f;
    if (on) {
      x = coords[slot * 4];
      y = coords[slot * 4 + 1];
      gt = coords[slot * 4 + 2];
      t = coords[slot * 4 + 3];
      gd = g_depth[slot];
      ga = g_alpha[slot];
      gu = g_until[slot];
      // G = sum_k w_k g_k from the forward's raw sums, the line-of-sight sum's included (its cotangent
      // enters g_k whether or not the caller asked for that sum)
      total = ga * acc_out[slot] + gd * depth_out[slot] + gu * until_out[slot];
#pragma unroll
      for (int ci = 0; ci < CMAX; ++ci) {
        if (ci < c) {
          gf[ci] = g_feat[slot * c + ci];
          total += gf[ci] * feat_out[slot * c + ci];
        }
      }
    }
    const float before_depth = __fsub_rn(gt, depth_eps);
    float prefix = 0.f, trans = 1.f;

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
        const SlotSigma sg = slot_sigma(a, x, y, t, wrap != 0);
        // beyond kFarSigma of every query the slot's alpha is zero: every term is zero
        if (!__any_sync(kFullMask, on && !(a1.w <= 1.f && sg.sigma_raw > kFarSigma))) continue;
        const SlotTerms st = gate_terms(a, sg, true, on);
        if (!__any_sync(kFullMask, st.alpha > 0.f)) continue;  // every term of this warp is zero
        float v[ROUNDS][32];
#pragma unroll
        for (int rr = 0; rr < ROUNDS; ++rr) {
#pragma unroll
          for (int i = 0; i < 32; ++i) v[rr][i] = 0.f;
        }
        if (st.alpha > 0.f) {
          const float d = slot_depth(make_float2(a2.x, a2.y), t);
          float g = ga + gd * d;
          if (d < before_depth) g += gu;
#pragma unroll
          for (int g4 = 0; g4 < G; ++g4) {
            const float4 f = s.feat[j * G + g4];
            g += gf[4 * g4] * f.x;
            g += gf[4 * g4 + 1] * f.y;
            g += gf[4 * g4 + 2] * f.z;
            g += gf[4 * g4 + 3] * f.w;
          }
          pair_terms<CMAX, ROUNDS>(a, st, g, t, gd, gf, total, prefix, trans, v);
        }
        const int gauss = __float_as_int(a2.z);
        add_columns<ROUNDS>(v, lane, width, (gauss >= 0 && gauss < n_gauss) ? gauss : -1, d_table);
      }
      __syncwarp();  // buffer r & 1 is free for chunk r + 2
      n_cur = n_next;
    }
    __syncwarp();  // the round's list is read before the next round writes it
  }
}

dim3 block_for(int p) { return dim3(p < MAX_THREADS ? round_up_to_warp(p) : MAX_THREADS); }

}  // namespace

// C interface (loaded with ctypes). Inputs as tile_composite_camera_fwd, its
// outputs feat [n_tiles, p, c], depth / alpha [n_tiles, p] on the same inputs,
// and the cotangents g_feat [n_tiles, p, c], g_depth / g_alpha [n_tiles, p];
// adds into d_table [n_gauss, 10 + c], which the caller has zero-filled.
// c <= 32. Returns cudaGetLastError() after the launch; the caller raises on
// non-zero.
extern "C" int tile_composite_camera_bwd(const float* table, int n_gauss, int c, const int* tile_gauss,
                                         const float* tile_valid, const float* pix, const float* times,
                                         int n_tiles, int p, int k, const float* feat, const float* depth,
                                         const float* alpha, const float* g_feat, const float* g_depth,
                                         const float* g_alpha, float* d_table, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles), block = block_for(p);
  if (c <= 8) {
    camera_bwd_kernel<8><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, pix, times, p, k, feat,
                                                 depth, alpha, g_feat, g_depth, g_alpha, d_table);
  } else if (c <= 16) {
    camera_bwd_kernel<16><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, pix, times, p, k, feat,
                                                  depth, alpha, g_feat, g_depth, g_alpha, d_table);
  } else {
    camera_bwd_kernel<32><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, pix, times, p, k, feat,
                                                  depth, alpha, g_feat, g_depth, g_alpha, d_table);
  }
  return static_cast<int>(cudaGetLastError());
}

// Inputs as tile_composite_lidar_fwd, its outputs feat [n_tiles, p, c], depth /
// acc / until [n_tiles, p] on the same inputs (until: the line-of-sight sum,
// computed whether or not the caller asked for it), and the cotangents g_feat
// [n_tiles, p, c], g_depth / g_alpha / g_until [n_tiles, p]; adds into
// d_table [n_gauss, 10 + c], which the caller has zero-filled. c <= 32, p <= 1024.
extern "C" int tile_composite_lidar_bwd(const float* table, int n_gauss, int c, const int* tile_gauss,
                                        const float* tile_valid, const float* pts, const float* vmask,
                                        int n_tiles, int p, int k, int wrap, float depth_eps, const float* feat,
                                        const float* depth, const float* acc, const float* until,
                                        const float* g_feat, const float* g_depth, const float* g_alpha,
                                        const float* g_until, float* d_table, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_tiles + LID_WARPS - 1) / LID_WARPS), block(32 * LID_WARPS);
  if (c <= 8) {
    lidar_bwd_kernel<8><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, pts, vmask, n_tiles, p, k,
                                                wrap, depth_eps, feat, depth, acc, until, g_feat, g_depth, g_alpha,
                                                g_until, d_table);
  } else if (c <= 16) {
    lidar_bwd_kernel<16><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, pts, vmask, n_tiles, p,
                                                 k, wrap, depth_eps, feat, depth, acc, until, g_feat, g_depth,
                                                 g_alpha, g_until, d_table);
  } else {
    lidar_bwd_kernel<32><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, pts, vmask, n_tiles, p,
                                                 k, wrap, depth_eps, feat, depth, acc, until, g_feat, g_depth,
                                                 g_alpha, g_until, d_table);
  }
  return static_cast<int>(cudaGetLastError());
}
