// The whole-encode fused kernel with a lane table (sm_90a), f32 on CUDA
// cores.
//
// mp_fused_encode_lane replaces mptpu/sparse/pallas_fused_mp.py
// pallas_fused_encode_lane (:1692, kernel body _whole_loop_lane_kernel
// :1357-1673): mp_fused_encode's loop, one thread block per item over all
// n_steps, plus an int32 table lanes (B, N, nbt) of the first lane of each
// block's maximum. The winner's value is its block-max entry and its
// position is blk * block + lanes[atom, blk] - pad, so the step never
// reads the map to select (mp_fused_encode scans the winning block). The
// window pass that rebuilds the block maxima rebuilds the lanes in the
// same sweep: per (row, block) one warp reduces (value, lane) pairs with
// the smaller lane winning among equal values, for the window blocks and,
// on a clipped event, the tail blocks, so no entry goes stale.
//
// What bounds it: bytes, as mp_fused_encode, less the refine's block read
// per step and plus the lane writes (N * upd_blocks ints per step).
#include "mp_step.cuh"

using mp::Geometry;
using mp::kTailAtoms;
using mp::kThreads;

__global__ void __launch_bounds__(kThreads, 1)
fused_encode_lane_kernel(float* fm, float* bm, int* lanes, float* residual,
                         const float* __restrict__ d2, const float* __restrict__ gram_p,
                         float* tail, int* atoms, int* positions, float* values, Geometry g,
                         int n_steps) {
  extern __shared__ float4 smem4[];
  __shared__ mp::Scratch s;
  float* ds = reinterpret_cast<float*>(smem4);
  float* res = ds + kTailAtoms * g.A;  // the item's residual row, resident
  const int b = blockIdx.x, B = gridDim.x;
  float* res_g = residual + (size_t)b * g.L;
  for (int j = threadIdx.x; j < g.L; j += kThreads) res[j] = res_g[j];
  __syncthreads();
  float* fm_b = fm + (size_t)b * g.N * g.W;
  float* bm_b = bm + (size_t)b * g.N * g.nbt;
  int* lanes_b = lanes + (size_t)b * g.N * g.nbt;
  float* tail_b = tail + (size_t)b * g.N * g.A;
  for (int step = 0; step < n_steps; ++step) {
    const mp::Event ev =
        mp::step_item_lane(fm_b, bm_b, lanes_b, res, d2, gram_p, tail_b, ds, g, s);
    if (threadIdx.x == 0) {
      atoms[step * B + b] = ev.atom;
      positions[step * B + b] = ev.position;
      values[step * B + b] = ev.value;
    }
  }
  for (int j = threadIdx.x; j < g.L; j += kThreads) res_g[j] = res[j];
}

extern "C" int mp_fused_encode_lane(void* fm, void* bm, void* lanes, void* residual, void* d2,
                                    void* gram_p, void* tail, void* atoms, void* positions,
                                    void* values, int B, int N, int A, int W, int n_samples,
                                    int block, int pad, int n_blocks, int nbt, int upd_blocks,
                                    int tail_start, int gate_tail, int n_steps, void* stream) {
  const Geometry g = mp::make_geometry(N, A, W, n_samples, block, pad, n_blocks, nbt, upd_blocks,
                                       tail_start, gate_tail);
  const int smem = (kTailAtoms * A + g.L) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_encode_lane_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_encode_lane_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (float*)fm, (float*)bm, (int*)lanes, (float*)residual, (const float*)d2,
      (const float*)gram_p, (float*)tail, (int*)atoms, (int*)positions, (float*)values, g,
      n_steps);
  return (int)cudaGetLastError();
}
