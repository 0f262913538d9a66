// Boundary-tail recompute for the unfused fast-MP path, for Hopper
// (sm_90a), f32 on CUDA cores (no TF32, no tensor cores).
//
// mp_boundary_update replaces mptpu/sparse/pallas_mp.py
// pallas_boundary_update (:58, kernel body _tail_kernel :37-54):
//   tail[b, n, t] = sum_k windows[b, t, k] * d[n, k]
// written in place into fm[b, :, tail_start : tail_start + A], with the
// per-block maxima tmax[b, n, j] = max_t tail[b, n, j*block + t] computed
// in the same pass.
//
// What bounds it on this card: operations. At the bench config
// (B 32, N 512, A 512) it is 2*B*N*A*A = 8.6 GFLOP, 0.13 ms at 67 TFLOP/s,
// against about 64 MiB of operands (0.02 ms at 3.35 TB/s). The design is
// a shared-memory-tiled SIMT product: a thread block owns 64 atoms x one
// table block of positions (walked 64 positions at a time), stages
// 16-deep slices of d and of the windows in shared memory, and keeps a
// 4 x 4 register tile per thread. Because a thread block covers whole
// table blocks, their maxima need no atomics and no second pass.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 64;   // atoms and positions per tile
constexpr int kDepth = 16;  // taps per shared-memory slice
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
boundary_kernel(const float* __restrict__ windows, const float* __restrict__ d, float* fm,
                float* tmax, int N, int A, int W, int tail_start, int block) {
  __shared__ float ds[kDepth][kTile + 1];
  __shared__ float ws[kDepth][kTile + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x, a0 = blockIdx.y * kTile, blk = blockIdx.z;
  const int p_end = min((blk + 1) * block, A);
  const float* win_b = windows + (size_t)b * A * A;
  float rmax[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};

  for (int p0 = blk * block; p0 < p_end; p0 += kTile) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < A; k0 += kDepth) {
      for (int e = tid; e < kTile * kDepth; e += kThreads) {
        const int i = e / kDepth, kk = e % kDepth, k = k0 + kk;
        const int a = a0 + i, p = p0 + i;
        ds[kk][i] = (a < N && k < A) ? d[(size_t)a * A + k] : 0.f;
        ws[kk][i] = (p < p_end && k < A) ? win_b[(size_t)p * A + k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        float av[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = ds[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = a0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + tx + 16 * j;
        if (a < N && p < p_end) {
          fm[((size_t)b * N + a) * W + tail_start + p] = acc[i][j];
          rmax[i] = fmaxf(rmax[i], acc[i][j]);
        }
      }
    }
  }
  // the 16 threads sharing an atom row are one half-warp: reduce there
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float m = rmax[i];
    for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const int a = a0 + ty + 16 * i;
    if (tx == 0 && a < N) tmax[((size_t)b * N + a) * (A / block) + blk] = m;
  }
}

}  // namespace

extern "C" int mp_boundary_update(void* windows, void* d, void* fm, void* tmax, int B, int N,
                                  int A, int W, int tail_start, int block, void* stream) {
  const dim3 grid(B, (N + kTile - 1) / kTile, A / block);
  boundary_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)windows, (const float*)d, (float*)fm, (float*)tmax, N, A, W, tail_start,
      block);
  return (int)cudaGetLastError();
}
