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
// against about 64 MiB of operands (0.02 ms at 3.35 TB/s). So the FMA
// pipes must not wait, neither for shared memory nor for a load:
//
//   tile     a thread block owns 128 atoms x 128 positions (one table block
//            at block = 128; other block sizes are walked 128 positions at
//            a time inside whole table blocks, so the maxima need no
//            atomics and no second pass); 256 threads keep an 8 x 8
//            register tile each, two blocks to an SM (128 registers a
//            thread, none spilled).
//   slices   both operands are contiguous in k, so a 32-tap slice of each
//            is copied as it lies (cp.async, 16 bytes a copy, whole 128-byte
//            row pieces) into rows of 36 floats: 16-byte loads along k are
//            then free of bank conflicts across the 8 rows a quarter-warp
//            reads, and one 16-byte load feeds 32 FMAs (16 loaded floats per
//            64 FMAs a tap). No thread holds a copy in registers.
//   ring     three slices deep: the copies of slice s + 2 are in flight
//            under the FMAs of slice s, with one __syncthreads() a slice.
//
// What is left: 256 of every 280 operations the inner loop issues are FMAs,
// but a 16-byte shared-memory load of a warp takes the shared-memory pipe 4
// cycles, and at 16 FMAs a thread per such load that pipe is as busy as the
// FMA pipes, so neither reaches its peak. More FMAs per load need a larger
// register tile than two blocks an SM leave room for (16 x 8 a thread, one
// block an SM, was no faster).
//
// Each output is one k-ascending FMA chain, the order of the plain version's
// product, so the result equals it bit for bit.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 128;    // atoms and positions per tile
constexpr int kDepth = 32;    // taps per slice
constexpr int kStride = kDepth + 4;   // floats per shared-memory row (4 of padding)
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kOperand = kTile * kStride;   // floats of one operand's slice
constexpr int kSmem = kStages * 2 * kOperand * (int)sizeof(float);
constexpr int kPieces = kDepth / 4;                 // 16-byte pieces per row of a slice
constexpr int kRowsPerPass = kThreads / kPieces;    // rows the block copies at once

// 16 bytes global -> shared, or 16 zero bytes where the piece lies outside
__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
boundary_kernel(const float* __restrict__ windows, const float* __restrict__ d, float* fm,
                float* tmax, int N, int A, int W, int tail_start, int block) {
  extern __shared__ __align__(16) float smem[];
  // per atom row and half of the positions, over the tiles of this table block
  __shared__ float row_max[2][kTile];
  // a warp is 4 (atom rows) x 8 (positions) threads, the block 4 x 2 warps
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7), ty = (warp >> 1) * 4 + (lane >> 3);
  const int b = blockIdx.x, a0 = blockIdx.y * kTile, blk = blockIdx.z;
  const int p_end = min((blk + 1) * block, A);
  const float* win_b = windows + (size_t)b * A * A;
  const int n_slices = (A + kDepth - 1) / kDepth;
  // the 16-byte pieces of each operand's slice that this thread copies:
  // rows tid / kPieces + kRowsPerPass * h, taps 4 * (tid % kPieces) ..
  const int crow = tid / kPieces, ck = 4 * (tid % kPieces);
  row_max[tid / kTile][tid % kTile] = -CUDART_INF_F;

  for (int p0 = blk * block; p0 < p_end; p0 += kTile) {
    auto copy_slice = [&](int slice) {
      float* ds = smem + (slice % kStages) * 2 * kOperand + crow * kStride + ck;
      float* ws = ds + kOperand;
      const int k = slice * kDepth + ck;
      const bool vk = k < A;
      const int kc = vk ? k : 0;   // a piece outside is copied from a valid address, 0 bytes of it
#pragma unroll
      for (int h = 0; h < kTile / kRowsPerPass; ++h) {
        const int a = a0 + crow + kRowsPerPass * h, p = p0 + crow + kRowsPerPass * h;
        copy16(ds + h * kRowsPerPass * kStride, d + (size_t)min(a, N - 1) * A + kc, vk && a < N);
        copy16(ws + h * kRowsPerPass * kStride, win_b + (size_t)min(p, p_end - 1) * A + kc,
               vk && p < p_end);
      }
    };
    float acc[8][8] = {};
    copy_slice(0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (n_slices > 1) copy_slice(1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int slice = 0; slice < n_slices; ++slice) {
      // slice has landed; every thread is done with slice - 1, whose stage
      // slice + 2 takes
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();
      if (slice + 2 < n_slices) copy_slice(slice + 2);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      const float* ds = smem + (slice % kStages) * 2 * kOperand;
      const float* ws = ds + kOperand;
      // not unrolled: with the loads of two groups of 4 taps in flight the
      // register tile spills
#pragma unroll 1
      for (int k4 = 0; k4 < kDepth; k4 += 4) {
        float4 av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          av[i] = *reinterpret_cast<const float4*>(ds + (ty + 16 * i) * kStride + k4);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 wv = *reinterpret_cast<const float4*>(ws + (tx + 16 * j) * kStride + k4);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][j] = fmaf(av[i].x, wv.x, acc[i][j]);
            acc[i][j] = fmaf(av[i].y, wv.y, acc[i][j]);
            acc[i][j] = fmaf(av[i].z, wv.z, acc[i][j]);
            acc[i][j] = fmaf(av[i].w, wv.w, acc[i][j]);
          }
        }
      }
    }
    __syncthreads();   // the next tile's first copies reuse the stages
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int a = a0 + ty + 16 * i;
      float m = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = p0 + tx + 16 * j;
        if (a < N && p < p_end) {
          fm[((size_t)b * N + a) * W + tail_start + p] = acc[i][j];
          m = fmaxf(m, acc[i][j]);
        }
      }
      // the 8 threads of a warp that share an atom row reduce among themselves
      for (int o = 4; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float* slot = &row_max[warp & 1][ty + 16 * i];
      if ((lane & 7) == 0) *slot = fmaxf(*slot, m);
    }
  }
  __syncthreads();
  if (tid < kTile && a0 + tid < N) {
    tmax[((size_t)b * N + a0 + tid) * (A / block) + blk] = fmaxf(row_max[0][tid], row_max[1][tid]);
  }
}

}  // namespace

// Requires A % 4 == 0 and 16-byte aligned windows and d (the 16-byte copies).
extern "C" int mp_boundary_update(void* windows, void* d, void* fm, void* tmax, int B, int N,
                                  int A, int W, int tail_start, int block, void* stream) {
  if (A % 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(boundary_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, (N + kTile - 1) / kTile, A / block);
  boundary_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const float*)windows, (const float*)d, (float*)fm, (float*)tmax, N, A, W, tail_start,
      block);
  return (int)cudaGetLastError();
}
