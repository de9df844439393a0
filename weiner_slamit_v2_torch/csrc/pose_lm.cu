// Motion-only pose optimization (optim/pose_opt.py::optimize_pose) for Hopper
// (sm_90a): the whole call, n_rounds x n_iters Levenberg-Marquardt
// iterations with the 6x6 solve and the chi2 reclassification between
// rounds, in one launch of one thread block.
//
// It replaces no TPU kernel: the JAX package's pose LM
// (weiner_slamit_v2_tpu/optim/pose_opt.py) is one jit program with no Pallas
// kernel. It was added because the plain form in PyTorch operations is
// ~8,400 launches a call, each a few us of device time on an N-vector, a 6x6
// or a 0-d tensor, enqueued one by one by the host. Plain twin and wrapper:
// optim/pose_opt.py::optimize_pose_plain and ops/pose_lm_kernel.py.
//
// Per round (robust Huber kernel in rounds 0 and 1 only) and iteration, as
// optimize_pose_plain defines them:
//   1. every observation's residuals (u, v and, with ur, the stereo row
//      u - bf/z - ur), Jacobian rows and IRLS weight at the current pose;
//   2. the 21 entries of H's lower triangle, the 6 of b and the robust cost,
//      summed per thread, then by warp shuffles, then across the warps
//      through shared memory in warp order;
//   3. one thread damps H (lam * diag(H) + H + 1e-9 I), solves with
//      solve6's unrolled Cholesky (pivots clamped at sqrt(max(s, 1e-20))) and
//      left-multiplies exp(dx) onto the pose (se3.retract);
//   4. the robust cost at the new pose, summed the same way;
//   5. that thread accepts the step if the cost fell and both the cost and
//      the step are finite, halves lam on accept and multiplies it by 4 on
//      reject, clamped to [1e-6, 1e3].
// After each round every observation is reclassified by its chi2 against
// the threshold (CHI2_STEREO for a stereo row); at the end one thread
// orthonormalizes the rotation (2 Newton-Schulz steps).
//
// Arithmetic: float32, in the plain form's roundings wherever they do not
// depend on a sum's order: the per-observation expressions as single
// roundings in the plain form's operation order (__fmul_rn / __fadd_rn, never
// contracted), IEEE division and root, and util.fma's one float64 sum
// rounded to float32 (fma_d) where the plain form fuses. Sums of H, b and
// the costs run in a fixed order (no atomics), so a launch repeats bit for
// bit; that order is not cuBLAS's, so poses part from the plain form on the
// card by ulps. sin and cos are CUDA's sincosf (the plain form emulates
// glibc's).
//
// What bounds it on the card: neither bytes (~28 KB of observations at
// N = 1024, read once) nor operations (~6.5 MFLOP a call) but the serial
// chain of 40 dependent iterations, each two block-wide reductions and one
// thread's solve and exponential. The design keeps that chain short:
//  * one block, so every step of the chain is a __syncthreads, never a
//    launch or a trip through device memory;
//  * the observations are staged once into dynamic shared memory (SoA;
//    each thread keeps the same strided observations for the whole call,
//    with their inlier flags);
//  * 256 threads: at N = 1024 four observations a thread, 8 warps to sum;
//  * one kernel for both forms: the stereo row is on where ur is given, a
//    branch uniform over the block. Two instantiations cost the build ~1 s
//    more than the slowest of the other sources.
// ptxas: 102 registers, 1,168 B static shared memory (+ 26 B, stereo 30 B, an
// observation, dynamic), a 32-byte stack frame (sincosf's reduction of a
// large argument), no spills. On the H100 at N = 1024: 0.306 ms a call
// (stereo 0.317 ms), by events around 200 launches.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_N = 6144;   // ops/pose_lm_kernel.py MAX_N
constexpr int NH = 21;        // H's lower triangle, row by row
constexpr int NSUM = NH + 6 + 1;   // + b + the robust cost
constexpr float CHI2_MONO = 5.991f;
constexpr float CHI2_STEREO = 7.815f;
constexpr float INV6 = 1.0f / 6.0f, INV24 = 1.0f / 24.0f, INV120 = 1.0f / 120.0f;

// the observations' floats per row: X (3), uv (2), inv_sigma2 and, stereo, ur
__host__ __device__ constexpr int obs_floats(bool stereo) { return stereo ? 7 : 6; }

// dynamic shared memory at n observations: their floats, valid and inlier bytes
__host__ __device__ constexpr size_t smem_bytes(int n, bool stereo) {
  return static_cast<size_t>(n) * (obs_floats(stereo) * 4 + 2);
}

// single roundings, never contracted into a fused multiply-add
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }

// util.fma: a * b + c in float64 (the product is exact), rounded to float32
__device__ __forceinline__ float fma_d(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(a, b), c));
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// one observation at a pose T (row-major 4x4): camera point, 1/z, residuals
struct Proj {
  float x, y, z, iz, iz2, ru, rv, rur;
};

__device__ __forceinline__ Proj project(const float* T, float X0, float X1, float X2, float u,
                                        float v, float ur, bool is_st, float fx, float fy,
                                        float cx, float cy, float bf) {
  Proj p;
  p.x = add(add(add(mul(T[0], X0), mul(T[1], X1)), mul(T[2], X2)), T[3]);
  p.y = add(add(add(mul(T[4], X0), mul(T[5], X1)), mul(T[6], X2)), T[7]);
  p.z = add(add(add(mul(T[8], X0), mul(T[9], X1)), mul(T[10], X2)), T[11]);
  p.iz = dv(1.0f, fabsf(p.z) < 1e-6f ? 1e-6f : p.z);
  p.iz2 = mul(p.iz, p.iz);
  const float pu = add(mul(mul(fx, p.x), p.iz), cx);
  p.ru = sub(pu, u);
  p.rv = sub(add(mul(mul(fy, p.y), p.iz), cy), v);
  p.rur = is_st ? sub(sub(pu, mul(bf, p.iz)), ur) : 0.0f;
  return p;
}

// chi2 as the iteration computes it: (ru^2 + rv^2) w (+ rur^2 w)
__device__ __forceinline__ float chi2_iter(bool stereo, const Proj& p, float w) {
  const float c = mul(add(mul(p.ru, p.ru), mul(p.rv, p.rv)), w);
  return stereo ? add(c, mul(mul(p.rur, p.rur), w)) : c;
}

// chi2 as chi2_of computes it: (ru^2 + rv^2 (+ rur^2)) w
__device__ __forceinline__ float chi2_of(bool stereo, const Proj& p, float w) {
  float c = add(mul(p.ru, p.ru), mul(p.rv, p.rv));
  if (stereo) c = add(c, mul(p.rur, p.rur));
  return mul(c, w);
}

// the (robust) cost of one observation, 0 off the mask
__device__ __forceinline__ float rho(float chi2, float d2, bool robust, bool on) {
  if (!on) return 0.0f;
  if (!robust || chi2 <= d2) return chi2;
  return sub(mul(2.0f, __fsqrt_rn(mul(d2, clamp_min(chi2, 1e-12f)))), d2);
}

// sums v[0..K) over the block: each warp by shuffles, then warp 0 adds the
// warps' sums in warp order into tot[0..K). On return tot is complete for
// warp 0; the other warps must pass a __syncthreads before reading it.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp * NSUM + k] = s;
  }
  __syncthreads();
  if (warp == 0) {
    for (int k = lane; k < K; k += 32) {
      float s = red[k];
      for (int w = 1; w < WARPS; ++w) s += red[w * NSUM + k];
      tot[k] = s;
    }
    __syncwarp();
  }
}

// C = A B for 3x3 (n = 3) or 4x4 (n = 4) row-major: each entry the first
// product, then fused terms k = 1, 2, ... (se3.matmul)
template <int n>
__device__ __forceinline__ void matmul(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < n; ++j) {
      float s = mul(A[i * n], B[j]);
#pragma unroll
      for (int k = 1; k < n; ++k) s = fma_d(A[i * n + k], B[k * n + j], s);
      C[i * n + j] = s;
    }
}

// solve6: the damped system's unrolled Cholesky (A read below its diagonal
// and overwritten), forward and back substitution
__device__ __forceinline__ void solve6(float (&S)[6][6], const float (&b)[6], float (&x)[6]) {
  float y[6], d[6], ys[6], m = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) y[i] = b[i];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    m = clamp_min(S[k][k], 1e-20f);
    d[k] = __fsqrt_rn(m);
#pragma unroll
    for (int j = k + 1; j < 6; ++j) S[j][k] = dv(S[j][k], d[k]);   // column k of L
    if (k == 5) break;
    ys[k] = dv(y[k], d[k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
#pragma unroll
      for (int j = k + 1; j <= i; ++j) S[i][j] = fma_d(-S[i][k], S[j][k], S[i][j]);
      y[i] = fma_d(-S[i][k], ys[k], y[i]);
    }
  }
  x[5] = dv(y[5], m);   // (y5 / sqrt(m)) / sqrt(m), folded to y5 / m as XLA does
#pragma unroll
  for (int i = 4; i >= 0; --i) {
    float s = ys[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = fma_d(-S[k][i], x[k], s);
    x[i] = dv(s, d[i]);
  }
}

// se3.retract: Tn = exp(xi) T, xi = [upsilon, omega], Rodrigues' forms
__device__ __forceinline__ void retract(const float* T, const float (&xi)[6], float* Tn) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float theta2 = fma_d(w2, w2, fma_d(w1, w1, mul(w0, w0)));
  const float theta = __fsqrt_rn(add(theta2, 1e-16f));
  const bool big = theta2 > 1e-8f;
  float sn, cs;
  sincosf(theta, &sn, &cs);
  const float a = big ? dv(sn, theta) : fma_d(-theta2, INV6, 1.0f);
  const float b = big ? dv(sub(1.0f, cs), theta2) : fma_d(-theta2, INV24, 0.5f);
  const float c = big ? dv(sub(theta, sn), mul(theta2, theta)) : fma_d(-theta2, INV120, INV6);
  const float K[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float KK[9];
  matmul<3>(K, K, KK);
  float E[16], V[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      E[i * 4 + j] = fma_d(b, KK[i * 3 + j], fma_d(a, K[i * 3 + j], eye));
      V[i * 3 + j] = fma_d(c, KK[i * 3 + j], fma_d(b, K[i * 3 + j], eye));
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    E[i * 4 + 3] = fma_d(V[i * 3 + 2], xi[2], fma_d(V[i * 3 + 1], xi[1], mul(V[i * 3], xi[0])));
  E[12] = E[13] = E[14] = 0.0f;
  E[15] = 1.0f;
  matmul<4>(E, T, Tn);
}

// one LM step from the block's sums (thread 0): the damped solve and the
// updated pose; returns whether the step is finite
__device__ __forceinline__ bool damped_step(const float* tot, float lam, const float* T,
                                            float* Tn) {
  float S[6][6], b[6], dx[6];
  int q = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) S[i][j] = tot[q++];
    S[i][i] = add(fma_d(lam, tot[q], tot[q]), 1e-9f);
    ++q;
    b[i] = -tot[NH + i];
  }
  solve6(S, b, dx);
  retract(T, dx, Tn);
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) finite &= isfinite(dx[i]);
  return finite;
}

__global__ void __launch_bounds__(THREADS) pose_lm_kernel(
    const float* __restrict__ T0, const float* __restrict__ X, const float* __restrict__ uv,
    const float* __restrict__ inv_sigma2, const unsigned char* __restrict__ valid,
    const float* __restrict__ K, const float* __restrict__ ur, int N, int n_rounds,
    int n_iters, float chi2_th, float lambda_init, float bf, float* __restrict__ Tcw,
    unsigned char* __restrict__ inliers, long long* __restrict__ n_inliers) {
  extern __shared__ __align__(16) float obs[];
  const bool stereo = ur != nullptr;   // uniform over the block
  float* sX0 = obs;
  float* sX1 = obs + N;
  float* sX2 = obs + 2 * N;
  float* su = obs + 3 * N;
  float* sv = obs + 4 * N;
  float* sw = obs + 5 * N;
  float* sur = obs + 6 * N;   // stereo only
  unsigned char* sval = reinterpret_cast<unsigned char*>(obs + obs_floats(stereo) * N);
  unsigned char* sinl = sval + N;
  __shared__ float red[WARPS * NSUM], tot[NSUM];
  __shared__ float T[16], Tn[16];
  __shared__ int red_i[WARPS];

  const int tid = threadIdx.x;
  for (int i = tid; i < N; i += THREADS) {
    sX0[i] = X[3 * i];
    sX1[i] = X[3 * i + 1];
    sX2[i] = X[3 * i + 2];
    su[i] = uv[2 * i];
    sv[i] = uv[2 * i + 1];
    sw[i] = inv_sigma2[i];
    if (stereo) sur[i] = ur[i];
    sval[i] = sinl[i] = valid[i] ? 1 : 0;
  }
  if (tid < 16) T[tid] = T0[tid];
  const float fx = K[0], fy = K[4], cx = K[2], cy = K[5];
  __syncthreads();

  // thread 0's state
  float lam = 0.0f, cost0 = 0.0f;
  bool finite = false;

  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    const bool robust = rnd < 2;   // robust kernel off from round 2 (Optimizer.cc:432)
    lam = lambda_init;
    for (int it = 0; it < n_iters; ++it) {
      // 1-2. the normal equations and the cost at T
      float acc[NSUM];
#pragma unroll
      for (int k = 0; k < NSUM; ++k) acc[k] = 0.0f;
      for (int i = tid; i < N; i += THREADS) {
        const bool is_st = stereo && sur[i] >= 0.0f;
        const float d2 = is_st ? CHI2_STEREO : CHI2_MONO;
        const Proj p = project(T, sX0[i], sX1[i], sX2[i], su[i], sv[i], stereo ? sur[i] : 0.0f,
                               is_st, fx, fy, cx, cy, bf);
        const float chi2 = chi2_iter(stereo, p, sw[i]);
        const bool on = sinl[i] && p.z > 0.0f;
        const float wr = chi2 <= d2 ? 1.0f : __fsqrt_rn(dv(d2, clamp_min(chi2, 1e-12f)));
        const float w = on ? (robust ? mul(sw[i], wr) : sw[i]) : 0.0f;
        const float nfx = -fx, nfy = -fy;
        const float Ju[6] = {mul(fx, p.iz), 0.0f, mul(mul(nfx, p.x), p.iz2),
                             mul(mul(mul(nfx, p.x), p.y), p.iz2),
                             mul(fx, add(1.0f, mul(mul(p.x, p.x), p.iz2))), mul(mul(nfx, p.y), p.iz)};
        const float Jv[6] = {0.0f, mul(fy, p.iz), mul(mul(nfy, p.y), p.iz2),
                             mul(nfy, add(1.0f, mul(mul(p.y, p.y), p.iz2))),
                             mul(mul(mul(fy, p.x), p.y), p.iz2), mul(mul(fy, p.x), p.iz)};
        float Juw[6], Jvw[6], Jur[6], Jurw[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          Juw[k] = mul(Ju[k], w);
          Jvw[k] = mul(Jv[k], w);
        }
        if (stereo) {
          // u_r = u - bf/z: d(u_r) = du + bf/z^2 dz, dz = [0, 0, 1, y, -x, 0]
          const float cz = mul(bf, p.iz2), ws = mul(w, is_st ? 1.0f : 0.0f);
          const float Jz[6] = {0.0f, 0.0f, 1.0f, p.y, -p.x, 0.0f};
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            Jur[k] = add(Ju[k], mul(cz, Jz[k]));
            Jurw[k] = mul(Jur[k], ws);
          }
        }
        int q = 0;
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
          for (int c = 0; c <= r; ++c, ++q) {
            float s = fmaf(Jvw[r], Jv[c], fmaf(Juw[r], Ju[c], acc[q]));
            acc[q] = stereo ? fmaf(Jurw[r], Jur[c], s) : s;
          }
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float s = fmaf(Jvw[k], p.rv, fmaf(Juw[k], p.ru, acc[NH + k]));
          acc[NH + k] = stereo ? fmaf(Jurw[k], p.rur, s) : s;
        }
        acc[NSUM - 1] += rho(chi2, d2, robust, on);
      }
      block_sum<NSUM>(acc, red, tot);
      // 3. the damped step (one thread)
      if (tid == 0) {
        cost0 = tot[NSUM - 1];
        finite = damped_step(tot, lam, T, Tn);
      }
      __syncthreads();
      // 4. the cost at the new pose
      float c1[1] = {0.0f};
      for (int i = tid; i < N; i += THREADS) {
        const bool is_st = stereo && sur[i] >= 0.0f;
        const Proj p = project(Tn, sX0[i], sX1[i], sX2[i], su[i], sv[i], stereo ? sur[i] : 0.0f,
                               is_st, fx, fy, cx, cy, bf);
        c1[0] += rho(chi2_of(stereo, p, sw[i]), is_st ? CHI2_STEREO : CHI2_MONO, robust,
                     sinl[i] && p.z > 0.0f);
      }
      block_sum<1>(c1, red, tot);
      // 5. accept or reject (one thread)
      if (tid == 0) {
        const float cost1 = tot[0];
        const bool accept = cost1 < cost0 && isfinite(cost1) && finite;
        if (accept) {
#pragma unroll
          for (int k = 0; k < 16; ++k) T[k] = Tn[k];
        }
        lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-6f), 1e3f);
      }
      __syncthreads();
    }
    // reclassify: each thread its own observations, at the round's pose
    for (int i = tid; i < N; i += THREADS) {
      const bool is_st = stereo && sur[i] >= 0.0f;
      const Proj p = project(T, sX0[i], sX1[i], sX2[i], su[i], sv[i], stereo ? sur[i] : 0.0f,
                             is_st, fx, fy, cx, cy, bf);
      sinl[i] = sval[i] && chi2_of(stereo, p, sw[i]) <= (is_st ? CHI2_STEREO : chi2_th) &&
                p.z > 0.0f;
    }
  }

  int cnt = 0;
  for (int i = tid; i < N; i += THREADS) {
    inliers[i] = sinl[i];
    cnt += sinl[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
  if ((tid & 31) == 0) red_i[tid >> 5] = cnt;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int w = 0; w < WARPS; ++w) total += red_i[w];
    *n_inliers = total;
    // se3.orthonormalize: R <- (0.5 R)(3 I - R^T R), twice
    float R[9], Rt[9], M[9], H[9], R2[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i * 3 + j] = T[i * 4 + j];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) Rt[i * 3 + j] = R[j * 3 + i];
      matmul<3>(Rt, R, M);
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        H[i] = sub(i % 4 == 0 ? 3.0f : 0.0f, M[i]);
        R2[i] = mul(0.5f, R[i]);
      }
      matmul<3>(R2, H, R);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) Tcw[i * 4 + j] = R[i * 3 + j];
      Tcw[i * 4 + 3] = T[i * 4 + 3];
    }
    Tcw[12] = Tcw[13] = Tcw[14] = 0.0f;
    Tcw[15] = 1.0f;
  }
}

}  // namespace

// C signature (ops/cuda_build.py SIGNATURES): the inputs (T0 (4,4), X (N,3),
// uv (N,2), inv_sigma2 (N,), valid (N,) bool, K (3,3), ur (N,) or NULL for a
// monocular problem), N, n_rounds, n_iters, chi2_th, lambda_init, bf, the
// outputs (Tcw (4,4) float32, inliers (N,) bool, n_inliers () int64), stream.
extern "C" int pose_lm_launch(const float* T0, const float* X, const float* uv,
                              const float* inv_sigma2, const unsigned char* valid,
                              const float* K, const float* ur, int N, int n_rounds,
                              int n_iters, float chi2_th, float lambda_init, float bf,
                              float* Tcw, unsigned char* inliers, long long* n_inliers,
                              void* stream) {
  if (N < 0 || N > MAX_N || n_rounds < 0 || n_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool stereo = ur != nullptr;
  const size_t smem = smem_bytes(N, stereo);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pose_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(MAX_N, true)));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pose_lm_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      T0, X, uv, inv_sigma2, valid, K, ur, N, n_rounds, n_iters, chi2_th, lambda_init, bf, Tcw,
      inliers, n_inliers);
  return static_cast<int>(cudaGetLastError());
}
