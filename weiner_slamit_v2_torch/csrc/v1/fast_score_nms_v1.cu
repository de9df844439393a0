// The first design of this kernel, kept unchanged (entry point renamed to
// *_v1_launch) so that chip_smoke.py can time the current design,
// csrc/fast_score_nms.cu, against it on the same card. Nothing on the
// port's path calls it.
//
// Fused FAST-9/16 corner score + 3x3 non-max suppression for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel weiner_slamit_v2_tpu/ops/fast_pallas.py
// (fast_score_nms_pallas / _band_kernel). Plain twin: ops/fast.py
// (nms_3x3(fast_score(x, 0))); the wrapper is ops/fast_kernel.py.
//
// What bounds it on the card: memory traffic and launch overhead. The work
// is ~70 compare/min/max per pixel on data that fits in shared memory; the
// plain version materialises 16 shifted copies plus ~20 intermediate maps
// per level in device memory. Design: one CTA per 32x32 output tile loads
// the tile plus a 4-px halo (3 px ring radius + 1 px NMS support) into
// shared memory once, computes the score on the (32+2)^2 region into shared
// memory, then writes only the NMS'd tile: one read and one write of the
// level. Every operation is an exact float subtract/min/max, so the result
// equals the plain version bit for bit. The 3-px border and pixels outside
// the image score 0, exactly as the plain version's interior mask does.

#include <cfloat>

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 4;
constexpr int IN = TILE + 2 * HALO;  // 40: input tile with halo
constexpr int SC = TILE + 2;         // 34: score region (1-px NMS support)

__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__global__ void fast_score_nms_kernel(const float* __restrict__ img,
                                      float* __restrict__ out, int H, int W) {
  __shared__ float tile[IN][IN];
  __shared__ float score[SC][SC];
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int i = tid; i < IN * IN; i += nthreads) {
    const int ly = i / IN, lx = i % IN;
    const int gy = y0 - HALO + ly, gx = x0 - HALO + lx;
    tile[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[gy * W + gx] : 0.f;
  }
  __syncthreads();

  // score on the (TILE+2)^2 region: local (sy, sx) is global (y0-1+sy, x0-1+sx)
  for (int i = tid; i < SC * SC; i += nthreads) {
    const int sy = i / SC, sx = i % SC;
    const int gy = y0 - 1 + sy, gx = x0 - 1 + sx;
    float s = 0.f;
    if (gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3) {
      const int ty = sy + HALO - 1, tx = sx + HALO - 1;
      const float c = tile[ty][tx];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = tile[ty + kDy[k]][tx + kDx[k]] - c;
      float bright = -FLT_MAX, dark = -FLT_MAX;
#pragma unroll
      for (int a = 0; a < 16; ++a) {
        float mb = d[a], md = -d[a];
#pragma unroll
        for (int k = 1; k < 9; ++k) {
          mb = fminf(mb, d[(a + k) & 15]);
          md = fminf(md, -d[(a + k) & 15]);
        }
        bright = fmaxf(bright, mb);
        dark = fmaxf(dark, md);
      }
      const float m = fmaxf(bright, dark);
      s = m > 0.f ? m : 0.f;
    }
    score[sy][sx] = s;
  }
  __syncthreads();

  for (int i = tid; i < TILE * TILE; i += nthreads) {
    const int ly = i / TILE, lx = i % TILE;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    const int sy = ly + 1, sx = lx + 1;
    const float s = score[sy][sx];
    const bool keep = s > 0.f &&
        s > score[sy - 1][sx - 1] && s > score[sy - 1][sx] &&
        s > score[sy - 1][sx + 1] && s > score[sy][sx - 1] &&
        s >= score[sy][sx + 1] && s >= score[sy + 1][sx - 1] &&
        s >= score[sy + 1][sx] && s >= score[sy + 1][sx + 1];
    out[gy * W + gx] = keep ? s : 0.f;
  }
}

}  // namespace

extern "C" int fast_score_nms_v1_launch(const float* img, float* out, int H, int W,
                                     void* stream) {
  dim3 block(32, 8);
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE);
  fast_score_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
