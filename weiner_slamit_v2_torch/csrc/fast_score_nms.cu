// Fused FAST-9/16 corner score + 3x3 non-max suppression over every pyramid
// level of a frame in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel weiner_slamit_v2_tpu/ops/fast_pallas.py
// (fast_score_nms_pallas / _band_kernel). Plain twin: ops/fast.py
// (nms_3x3(fast_score(x, 0)) per level); the wrapper is ops/fast_kernel.py
// (fast_score_nms_levels).
//
// What bounds it on the card: a level is read once and written once (8
// bytes a pixel: 2.3 us for the 8 levels of a 640x480 frame at 3.35 TB/s);
// the score takes ~127 min/max/subtract operations a pixel in this design
// (1.8 us at 67 TFLOP/s; min/max issue at half the FMA rate, so the ALUs are
// the practical limit). With one launch per level, the small levels also
// left most of the 132 SMs idle and every level paid its own launch.
// What the design does about it:
//  * one launch for all levels: a by-value table of (input, output, H, W,
//    first tile) per level; each CTA finds its level from its block index, so
//    all levels' tiles fill the card together;
//  * the arc test in registers on the raw ring values: fl(x - c) is monotone
//    in x, so the min over an arc of the differences is fl(min - c), and the
//    16 subtractions per polarity become one. The 16 arc mins and maxes come
//    from van Herk / Gil-Werman blocks of 9 (57 operations per polarity)
//    rather than the doubling 2-, 4-, 8-, 9-long mins (79): on the card the
//    doubling form took 19.6 us per frame and this one 16.4 us, in one run.
//    The dark side takes the arcs' maxes, since min(c - r) = c - max(r).
//    Every step is an exact IEEE subtract, min or max, so the score equals
//    the plain version bit for bit;
//  * a 64x48 score region per CTA (output tile 62x46: 8% halo overlap), one
//    thread per column pair and vertical run of 6 scores, so the ring values
//    a run shares are loaded from shared memory once (72 loads instead of
//    102). A 640x480 frame is 388 CTAs, which fit the card in one round at 3
//    CTAs per SM; 64x32 tiles (572 CTAs, 4 per SM) left a second round of 44
//    CTAs and measured 0.01565 ms per frame against 0.0147 ms (PERF.md);
//  * the tile fill maps threads in 2D (a warp per row, a lane per 4-column
//    chunk: no div/mod per element), reads the 16-byte-aligned interior of
//    each row with one 16-byte load per chunk (the ragged ends and pixels off
//    the image one by one, or 0), and issues all of a thread's loads before
//    its first store, so the fill costs one memory round trip.
// TMA is not used: it would need one tensor map per level per frame, built
// on the host, for a ~2 us problem whose loads are a small share of its
// time. ptxas: 79 registers, 27,840 B of static shared memory, no spills: 3
// CTAs (24 warps) per SM. Pixels outside the image and the 3-px border score
// 0, exactly as the plain version's interior mask does. Inputs are finite.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int SW = 64;             // score region: 64 columns x 48 rows
constexpr int SH = 48;
constexpr int OW = SW - 2;         // output tile: 62 x 46 (1-px NMS support)
constexpr int OH = SH - 2;
constexpr int IW = SW + 6;         // input tile: 70 x 54 (3-px ring radius)
constexpr int IH = SH + 6;
constexpr int IPITCH = 72;
constexpr int RUN = 6;             // vertical run of scores per thread
constexpr int TX = 32;             // block: 32 x 8 threads
constexpr int TY = SH / RUN;
constexpr int NCHUNK = 19;         // 4-column chunks that cover a 70-wide row at any alignment

struct Level {
  const float* img;
  float* out;
  int H, W, tiles_x, first_tile, vec;  // vec: img is 16-byte aligned
};

struct Levels {
  Level l[MAX_LEVELS];
  int n;
};

// B = max over the 16 circular 9-long arcs of the ring of the arc's min,
// D = min over them of the arc's max, by van Herk / Gil-Werman blocks of 9
// over the doubled ring e[i] = r[i & 15]: arc k is the suffix of one block
// from k plus the prefix of the next, so 4 running min/max chains and one
// combine per arc give all 16 (2 x 57 operations; doubling takes 2 x 79)
__device__ __forceinline__ void arc_extremes(const float (&r)[16], float& B, float& D) {
  // s0: suffixes of e[0..8]; p1 / s1: prefixes / suffixes of e[9..17];
  // p2: prefixes of e[18..23]; n = min, x = max
  float s0n[9], s0x[9], p1n[8], p1x[8], s1n[9], s1x[9], p2n[6], p2x[6];
  s0n[8] = s0x[8] = r[8];
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    s0n[k] = fminf(r[k], s0n[k + 1]);
    s0x[k] = fmaxf(r[k], s0x[k + 1]);
  }
  p1n[0] = p1x[0] = r[9];
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    p1n[j] = fminf(p1n[j - 1], r[(9 + j) & 15]);
    p1x[j] = fmaxf(p1x[j - 1], r[(9 + j) & 15]);
  }
  s1n[8] = s1x[8] = r[1];
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    s1n[k] = fminf(r[(9 + k) & 15], s1n[k + 1]);
    s1x[k] = fmaxf(r[(9 + k) & 15], s1x[k + 1]);
  }
  p2n[0] = p2x[0] = r[2];
#pragma unroll
  for (int j = 1; j < 6; ++j) {
    p2n[j] = fminf(p2n[j - 1], r[2 + j]);
    p2x[j] = fmaxf(p2x[j - 1], r[2 + j]);
  }
  B = s0n[0];
  D = s0x[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    B = fmaxf(B, fminf(s0n[k], p1n[k - 1]));
    D = fminf(D, fmaxf(s0x[k], p1x[k - 1]));
  }
  B = fmaxf(B, s1n[0]);
  D = fminf(D, s1x[0]);
#pragma unroll
  for (int k = 10; k < 16; ++k) {
    B = fmaxf(B, fminf(s1n[k - 9], p2n[k - 10]));
    D = fminf(D, fmaxf(s1x[k - 9], p2x[k - 10]));
  }
}

__global__ void __launch_bounds__(TX * TY)
fast_score_nms_levels_kernel(const Levels L) {
  // Bresenham circle of radius 3, clockwise (ops/fast.py CIRCLE)
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  __shared__ float tile[IH][IPITCH];
  __shared__ float score[SH][SW];

  // this CTA's level: the last whose first tile is <= blockIdx.x (the loop is
  // unrolled so that the table is read with constant offsets)
  const int t = blockIdx.x;
  Level lv = L.l[0];
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i) {
    if (i < L.n && t >= L.l[i].first_tile) lv = L.l[i];
  }
  const int local = t - lv.first_tile;
  const int tyi = local / lv.tiles_x;
  const int oy0 = tyi * OH, ox0 = (local - tyi * lv.tiles_x) * OW;
  const int iy0 = oy0 - 4, ix0 = ox0 - 4;   // input tile origin (score origin - 3)
  const int H = lv.H, W = lv.W;
  const int tx = threadIdx.x, ty = threadIdx.y;

  // fill: warp ty takes rows ty, ty+8, ...; lane k < NCHUNK takes the k-th
  // 4-column chunk, aligned so that its global address is a multiple of 16 B.
  // All of a thread's loads are issued before its first store.
  constexpr int FILL_ROWS = (IH + TY - 1) / TY;
  float v[FILL_ROWS][4];
#pragma unroll
  for (int q = 0; q < FILL_ROWS; ++q) {
    const int r = ty + q * TY;
    const int gy = iy0 + r;
    const bool row_in = r < IH && tx < NCHUNK && gy >= 0 && gy < H;
    const long e = static_cast<long>(gy) * W + ix0;   // flat index of tile column 0
    const int c0 = static_cast<int>((-e) & 3) - 4 + 4 * tx;   // first tile column of the chunk
    const int gx0 = ix0 + c0;
    if (row_in && lv.vec && gx0 >= 0 && gx0 + 3 < W) {
      const float4 f = *reinterpret_cast<const float4*>(lv.img + e + c0);
      v[q][0] = f.x; v[q][1] = f.y; v[q][2] = f.z; v[q][3] = f.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int gx = gx0 + k;
        v[q][k] = (row_in && gx >= 0 && gx < W) ? lv.img[e + c0 + k] : 0.f;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < FILL_ROWS; ++q) {
    const int r = ty + q * TY;
    if (r >= IH || tx >= NCHUNK) continue;
    const long e = static_cast<long>(iy0 + r) * W + ix0;
    const int c0 = static_cast<int>((-e) & 3) - 4 + 4 * tx;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + k;
      if (c >= 0 && c < IW) tile[r][c] = v[q][k];
    }
  }
  __syncthreads();

  // scores: thread (tx, ty) owns score columns tx and tx + 32, rows
  // RUN*ty .. RUN*ty + RUN - 1; score (sr, sc) is tile (sr + 3, sc + 3) and
  // global (oy0 - 1 + sr, ox0 - 1 + sc)
  const int sr0 = RUN * ty;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int sc = tx + 32 * half;
    // tile rows sr0 .. sr0 + RUN + 5, columns sc .. sc + 6 (the unused ones
    // are never loaded)
    float w[RUN + 6][7];
#pragma unroll
    for (int i = 0; i < RUN + 6; ++i) {
#pragma unroll
      for (int j = 0; j < 7; ++j) w[i][j] = tile[sr0 + i][sc + j];
    }
    const int gx = ox0 - 1 + sc;
    const bool col_in = gx >= 3 && gx < W - 3;
#pragma unroll
    for (int p = 0; p < RUN; ++p) {
      const float c = w[p + 3][3];
      float r[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) r[k] = w[p + 3 + kDy[k]][3 + kDx[k]];
      float B, D;
      arc_extremes(r, B, D);
      // fl(x - c) is monotone in x, so min/max commute with the subtraction:
      // max_k min_arc fl(r - c) = fl(B - c), max_k min_arc fl(c - r) = fl(c - D)
      const float m = fmaxf(B - c, c - D);
      const int gy = oy0 - 1 + sr0 + p;
      const bool in = col_in && gy >= 3 && gy < H - 3;
      score[sr0 + p][sc] = (in && m > 0.f) ? m : 0.f;
    }
  }
  __syncthreads();

  // NMS on the output tile (score rows 1..OH, columns 1..OW): strict > against
  // the 4 raster-earlier neighbours, >= against the 4 later ones
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int sc = tx + 32 * half;
    const int gx = ox0 - 1 + sc;
    if (sc < 1 || sc > OW || gx >= W) continue;
    float n[RUN + 2][3];
#pragma unroll
    for (int i = 0; i < RUN + 2; ++i) {
      const int sr = min(max(sr0 - 1 + i, 0), SH - 1);
#pragma unroll
      for (int j = 0; j < 3; ++j) n[i][j] = score[sr][sc - 1 + j];
    }
#pragma unroll
    for (int p = 0; p < RUN; ++p) {
      const int sr = sr0 + p;
      const int gy = oy0 - 1 + sr;
      if (sr < 1 || sr > OH || gy >= H) continue;
      const float s = n[p + 1][1];
      const bool keep = s > 0.f &&
          s > n[p][0] && s > n[p][1] && s > n[p][2] && s > n[p + 1][0] &&
          s >= n[p + 1][2] && s >= n[p + 2][0] && s >= n[p + 2][1] && s >= n[p + 2][2];
      lv.out[static_cast<long>(gy) * W + gx] = keep ? s : 0.f;
    }
  }
}

}  // namespace

// C signature (ops/cuda_build.py SIGNATURES): n_levels, then four host arrays
// of n_levels entries (input pointers, output pointers, heights, widths), then
// the stream. Outputs are (H, W) float32, inputs contiguous (H, W) float32.
extern "C" int fast_score_nms_levels_launch(int n_levels, const float* const* imgs,
                                            float* const* outs, const int* heights,
                                            const int* widths, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
  Levels L{};
  int tiles = 0;
  for (int i = 0; i < n_levels; ++i) {
    const int H = heights[i], W = widths[i];
    const int tx = H > 0 && W > 0 ? (W + OW - 1) / OW : 0;
    const int ty = H > 0 && W > 0 ? (H + OH - 1) / OH : 0;
    L.l[i] = Level{imgs[i], outs[i], H, W, tx, tiles,
                   (reinterpret_cast<std::uintptr_t>(imgs[i]) & 15) == 0 ? 1 : 0};
    tiles += tx * ty;
  }
  L.n = n_levels;
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  fast_score_nms_levels_kernel<<<tiles, dim3(TX, TY), 0, static_cast<cudaStream_t>(stream)>>>(L);
  return static_cast<int>(cudaGetLastError());
}
