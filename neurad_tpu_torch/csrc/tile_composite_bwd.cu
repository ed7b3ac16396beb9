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
// (shuffles) and the atomics on hot rows. This kernel walks the pairs twice
// (once for G, once for the gradients), so it evaluates alpha and the payload
// gradient a second time: about 220 operations a pair, the second pass being
// its own overhead and no part of the bound.
//
// What the design does about it. One block per tile, one thread per pixel or
// query slot, 256 slots staged in shared memory at a time (the stage and the
// gated alpha are shared with the forward kernels, so both take the same side
// of the 1/255 step). The thread holds its cotangents in registers. Pass 1 is
// the forward loop again, accumulating G. Pass 2 walks the slots in the same
// order carrying T_k and P_k; for each slot a warp whose 32 pixels all have
// alpha 0 skips it (every term is then zero), the others reduce their 10 + C
// per-pixel terms over the warp with a transposing butterfly (31 shuffles for
// 32 columns instead of 5 each: after it lane l holds column l's sum), and
// lane l adds column l to d_table with one global atomicAdd (a reduction at
// the L2: the warp's 10 + C lanes hit consecutive addresses of one row). So a
// row receives one add per warp that touches it: up to P / 32 per tile. A
// first version summed the warps of a block in shared memory before going to
// global memory; shared-memory float atomics on addresses that eight warps
// share took most of the kernel's time. Atomics make the order of these fp32
// sums vary from run to run.

#include "tile_composite_common.cuh"

namespace {

using namespace tile_composite;

constexpr int MAX_THREADS = 256;  // a tile with more pixels is walked in rounds of 256

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

// LIDAR = false: coords = pix [T, P, 2], aux = times [T, P], g_until unused.
// LIDAR = true:  coords = pts [T, P, 4] (azimuth, elevation, gt depth, time),
//                aux = vmask [T, P].
template <int CMAX, bool LIDAR>
__global__ void __launch_bounds__(MAX_THREADS) composite_bwd_kernel(
    const float* __restrict__ table, int n_gauss, int c, const int* __restrict__ tile_gauss,
    const float* __restrict__ tile_valid, const float* __restrict__ coords, const float* __restrict__ aux,
    int p, int k, int wrap, float depth_eps, const float* __restrict__ g_feat, const float* __restrict__ g_depth,
    const float* __restrict__ g_alpha, const float* __restrict__ g_until, float* __restrict__ d_table) {
  constexpr int ROUNDS = (ATTR + CMAX + 31) / 32;  // 32-column groups of the 10 + C terms
  __shared__ Stage<CMAX> s;
  __shared__ int row[CHUNK];  // the slot's row of d_table, -1 where its index entry lies outside [0, N)
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int width = ATTR + c;

  for (int q0 = 0; q0 < p; q0 += blockDim.x) {
    const int q = q0 + threadIdx.x;
    const bool active = q < p;
    const int64_t slot = (int64_t)tile * p + q;
    float x = 0.f, y = 0.f, t = 0.f, gt = 0.f, gd = 0.f, ga = 0.f, gu = 0.f;
    bool slot_ok = active;
    float gf[CMAX];
#pragma unroll
    for (int ci = 0; ci < CMAX; ++ci) gf[ci] = 0.f;
    if (active) {
      if (LIDAR) {
        x = coords[slot * 4];
        y = coords[slot * 4 + 1];
        gt = coords[slot * 4 + 2];
        t = coords[slot * 4 + 3];
        slot_ok = aux[slot] > 0.f;
        gu = g_until[slot];
      } else {
        x = coords[slot * 2];
        y = coords[slot * 2 + 1];
        t = aux[slot];
      }
      gd = g_depth[slot];
      ga = g_alpha[slot];
#pragma unroll
      for (int ci = 0; ci < CMAX; ++ci) {
        if (ci < c) gf[ci] = g_feat[slot * c + ci];
      }
    }
    const float before_depth = __fsub_rn(gt, depth_eps);
    const bool do_wrap = LIDAR && wrap != 0;

    // pass 1: the forward loop again, for G = sum_k w_k g_k
    float total = 0.f, trans = 1.f;
    for (int k0 = 0; k0 < k; k0 += CHUNK) {
      const int n = min(CHUNK, k - k0);
      __syncthreads();  // the previous chunk is no longer read
      load_chunk<CMAX>(s, table, n_gauss, c, tile_gauss, tile_valid, tile, k, k0, n);
      if (!slot_ok) continue;
      for (int j = 0; j < n; ++j) {
        if (!(s.valid[j] > 0.f)) continue;  // same j in every thread
        float alpha = slot_alpha<CMAX>(s, j, x, y, t, do_wrap, slot_ok);
        if (alpha == 0.f) continue;
        float d = slot_depth<CMAX>(s, j, t);
        const float* f = &s.feat[j * CMAX];
        float g = ga + gd * d;
        if (LIDAR && d < before_depth) g += gu;
#pragma unroll
        for (int ci = 0; ci < CMAX; ++ci) g += gf[ci] * f[ci];
        total += alpha * trans * g;
        trans *= (1.f - alpha);
      }
    }

    // pass 2: the same order again, carrying T_k and the inclusive prefix P_k
    float prefix = 0.f;
    trans = 1.f;
    for (int k0 = 0; k0 < k; k0 += CHUNK) {
      const int n = min(CHUNK, k - k0);
      __syncthreads();
      load_chunk<CMAX>(s, table, n_gauss, c, tile_gauss, tile_valid, tile, k, k0, n);
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const int g = tile_gauss[(int64_t)tile * k + k0 + j];
        row[j] = (g >= 0 && g < n_gauss) ? g : -1;
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        if (!(s.valid[j] > 0.f)) continue;
        const float* a = &s.attr[j * ATTR];
        SlotTerms st = slot_terms(a, true, x, y, t, do_wrap, slot_ok);
        if (!__any_sync(0xffffffffu, st.alpha > 0.f)) continue;  // every term of this warp is zero
        float v[ROUNDS][32];
#pragma unroll
        for (int r = 0; r < ROUNDS; ++r) {
#pragma unroll
          for (int i = 0; i < 32; ++i) v[r][i] = 0.f;
        }
        if (st.alpha > 0.f) {
          float d = slot_depth<CMAX>(s, j, t);
          const float* f = &s.feat[j * CMAX];
          float g = ga + gd * d;
          if (LIDAR && d < before_depth) g += gu;
#pragma unroll
          for (int ci = 0; ci < CMAX; ++ci) g += gf[ci] * f[ci];
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
#pragma unroll
        for (int r = 0; r < ROUNDS; ++r) {
          float sum = warp_sum_columns(v[r], lane);
          const int col = r * 32 + lane;
          if (col < width && row[j] >= 0 && sum != 0.f) atomicAdd(&d_table[(int64_t)row[j] * width + col], sum);
        }
      }
    }
  }
}

template <bool LIDAR>
int launch(const float* table, int n_gauss, int c, const int* tile_gauss, const float* tile_valid,
           const float* coords, const float* aux, int n_tiles, int p, int k, int wrap, float depth_eps,
           const float* g_feat, const float* g_depth, const float* g_alpha, const float* g_until, float* d_table,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(n_tiles), block(p < MAX_THREADS ? round_up_to_warp(p) : MAX_THREADS);
  if (c <= 8) {
    composite_bwd_kernel<8, LIDAR><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, coords, aux, p,
                                                           k, wrap, depth_eps, g_feat, g_depth, g_alpha, g_until,
                                                           d_table);
  } else if (c <= 16) {
    composite_bwd_kernel<16, LIDAR><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, coords, aux,
                                                            p, k, wrap, depth_eps, g_feat, g_depth, g_alpha, g_until,
                                                            d_table);
  } else {
    composite_bwd_kernel<32, LIDAR><<<grid, block, 0, st>>>(table, n_gauss, c, tile_gauss, tile_valid, coords, aux,
                                                            p, k, wrap, depth_eps, g_feat, g_depth, g_alpha, g_until,
                                                            d_table);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes). Inputs as tile_composite_camera_fwd plus the
// cotangents g_feat [n_tiles, p, c], g_depth / g_alpha [n_tiles, p]; adds into
// d_table [n_gauss, 10 + c], which the caller has zero-filled. c <= 32.
// Returns cudaGetLastError() after the launch; the caller raises on non-zero.
extern "C" int tile_composite_camera_bwd(const float* table, int n_gauss, int c, const int* tile_gauss,
                                         const float* tile_valid, const float* pix, const float* times,
                                         int n_tiles, int p, int k, const float* g_feat, const float* g_depth,
                                         const float* g_alpha, float* d_table, void* stream) {
  return launch<false>(table, n_gauss, c, tile_gauss, tile_valid, pix, times, n_tiles, p, k, 0, 0.f, g_feat,
                       g_depth, g_alpha, nullptr, d_table, stream);
}

// Inputs as tile_composite_lidar_fwd plus g_feat [n_tiles, p, c] and g_depth /
// g_alpha / g_until [n_tiles, p] (the cotangent of the line-of-sight sum).
extern "C" int tile_composite_lidar_bwd(const float* table, int n_gauss, int c, const int* tile_gauss,
                                        const float* tile_valid, const float* pts, const float* vmask,
                                        int n_tiles, int p, int k, int wrap, float depth_eps, const float* g_feat,
                                        const float* g_depth, const float* g_alpha, const float* g_until,
                                        float* d_table, void* stream) {
  return launch<true>(table, n_gauss, c, tile_gauss, tile_valid, pts, vmask, n_tiles, p, k, wrap, depth_eps, g_feat,
                      g_depth, g_alpha, g_until, d_table, stream);
}
