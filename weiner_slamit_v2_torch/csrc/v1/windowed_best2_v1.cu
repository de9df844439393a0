// The first design of this kernel, kept unchanged (entry point renamed to
// *_v1_launch) so that chip_smoke.py can time the current design,
// csrc/windowed_best2.cu, against it on the same card. Nothing on the
// port's path calls it.
//
// Gated Hamming matcher (best + second-best) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel weiner_slamit_v2_tpu/ops/match_pallas.py
// (windowed_best2_pallas / _match_kernel). Plain twin and wrapper:
// ops/match_kernel.py. A leading batch dimension B over target keyframes
// replaces the vmap at tracking/local_mapping.py:488; grid = (row tiles, B).
//
// Per row i of batch b, over every column j that passes every gate
//   valid1[i] && valid2[j] && |du| < win[i] && |dv| < win[i]
//   && lo[i] <= oct2[j] <= hi[i] && ((du*du + dv*dv) * w2[j] <= th || th <= 0)
// (du = x2[j] - px[i], dv = y2[j] - py[i]), the distance is
// sum_w popc(d1[i][w] ^ d2[j][w]); a failing column counts as 10000. The
// packed key dist * N2 + j breaks ties toward the smaller column. Outputs
// best_idx, best_dist and second_dist (clamped to 10000).
//
// What bounds it on the card: the integer XOR/popcount work (N1 * N2 * 8
// per target) and re-reading the column data. Design: one thread owns one
// row and keeps its 8 descriptor words and gates in registers; the CTA
// stages the target's column data (descriptors, xy, octave, validity, chi2
// weight) in shared memory in chunks of 128 columns, so each column is read
// from device memory once per 128 rows; every thread keeps a running packed
// min and second min. Nothing but the three (B, N1) vectors is written.
// The chi2 product uses __fmul_rn/__fadd_rn so that nvcc cannot contract
// it into an FMA: the gate then rounds exactly as the plain version does.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 128;   // threads (rows) per CTA
constexpr int CHUNK = 128;  // columns staged per pass
constexpr int INVALID = 10000;

__global__ void windowed_best2_kernel(
    const int* __restrict__ d1, const unsigned char* __restrict__ v1,
    const float* __restrict__ pxy, const float* __restrict__ win,
    const int* __restrict__ lo, const int* __restrict__ hi,
    const int* __restrict__ d2, const unsigned char* __restrict__ v2,
    const float* __restrict__ xy2, const int* __restrict__ oct2,
    const float* __restrict__ w2, float th,
    int* __restrict__ best_idx, int* __restrict__ best_dist,
    int* __restrict__ second_dist, int N1, int N2) {
  __shared__ unsigned sd[CHUNK][9];  // 8 words + pad (bank spread)
  __shared__ float sx[CHUNK], sy[CHUNK], sw[CHUNK];
  __shared__ int so[CHUNK];
  __shared__ unsigned char sv[CHUNK];

  const int b = blockIdx.y;
  const int i = blockIdx.x * ROWS + threadIdx.x;
  const bool row_in = i < N1;
  const long r = static_cast<long>(b) * N1 + (row_in ? i : 0);

  unsigned q[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) q[w] = row_in ? static_cast<unsigned>(d1[r * 8 + w]) : 0u;
  const bool rv = row_in && v1[r];
  const float px = row_in ? pxy[r * 2] : 0.f;
  const float py = row_in ? pxy[r * 2 + 1] : 0.f;
  const float wr = row_in ? win[r] : 0.f;
  const int olo = row_in ? lo[r] : 0;
  const int ohi = row_in ? hi[r] : 0;
  const bool chi2_on = th > 0.f;

  int m1 = INT_MAX, m2 = INT_MAX;  // running packed min / second min
  const long cb = static_cast<long>(b) * N2;
  for (int j0 = 0; j0 < N2; j0 += CHUNK) {
    const int n = min(CHUNK, N2 - j0);
    __syncthreads();
    for (int t = threadIdx.x; t < n * 8; t += ROWS) {
      sd[t / 8][t % 8] = static_cast<unsigned>(d2[(cb + j0) * 8 + t]);
    }
    for (int t = threadIdx.x; t < n; t += ROWS) {
      const long c = cb + j0 + t;
      sx[t] = xy2[c * 2];
      sy[t] = xy2[c * 2 + 1];
      so[t] = oct2[c];
      sv[t] = v2[c];
      sw[t] = w2[c];
    }
    __syncthreads();
    if (!row_in) continue;
    for (int t = 0; t < n; ++t) {
      const float du = __fsub_rn(sx[t], px);
      const float dv = __fsub_rn(sy[t], py);
      bool ok = rv && sv[t] && fabsf(du) < wr && fabsf(dv) < wr &&
                so[t] >= olo && so[t] <= ohi;
      if (ok && chi2_on) {
        const float c2 = __fmul_rn(__fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)), sw[t]);
        ok = c2 <= th;
      }
      int dist = INVALID;
      if (ok) {
        dist = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) dist += __popc(q[w] ^ sd[t][w]);
      }
      const int code = dist * N2 + j0 + t;
      if (code < m1) {
        m2 = m1;
        m1 = code;
      } else if (code < m2) {
        m2 = code;
      }
    }
  }
  if (row_in) {
    best_idx[r] = m1 % N2;
    best_dist[r] = m1 / N2;
    second_dist[r] = min(m2 / N2, INVALID);
  }
}

}  // namespace

extern "C" int windowed_best2_v1_launch(
    const int* d1, const unsigned char* v1, const float* pxy, const float* win,
    const int* lo, const int* hi, const int* d2, const unsigned char* v2,
    const float* xy2, const int* oct2, const float* w2, float th,
    int* best_idx, int* best_dist, int* second_dist, int B, int N1, int N2,
    void* stream) {
  dim3 grid((N1 + ROWS - 1) / ROWS, B);
  windowed_best2_kernel<<<grid, ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
      d1, v1, pxy, win, lo, hi, d2, v2, xy2, oct2, w2, th, best_idx, best_dist,
      second_dist, N1, N2);
  return static_cast<int>(cudaGetLastError());
}
