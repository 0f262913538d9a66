// Fused greedy fast-MP kernels for Hopper (sm_90a), f32 on CUDA cores.
//
// mp_fused_step replaces mptpu/sparse/pallas_fused_mp.py pallas_fused_step
// (:289, kernel body _step_kernel :69-272): one launch per greedy step,
// one thread block per batch item.
//
// mp_fused_encode replaces pallas_fused_encode (:1219, kernel body
// _whole_loop_kernel :834-1198): one launch for the whole encode. Each
// block loops over the n_steps steps of its item; items are independent,
// so blocks never synchronise with each other. The item's residual row
// stays in shared memory for the whole encode; the block-max table
// (512 KiB per item at the bench config, 16 MiB in all) stays in global
// memory and so in the 50 MB L2.
//
// What bounds them on this card: bytes. Each item-step reads one gram row
// (N x 2A floats, 2 MiB at 512 atoms x 512 taps) and reads and writes its
// update window (N x upd_blocks*block floats, 2.25 MiB each way): about
// 6.8 MB, so 3,200 item-steps move about 21.8 GB, 6.5 ms at 3.35 TB/s.
// A clipped event adds the N x A x A tail product (268 MFLOP). The design
// streams the window in one coalesced pass (one warp per atom row and
// block: subtract, tail splice and block max together, so the window is
// read once and written once) and never stages it in shared memory. With
// one block per item only B of the 132 SMs work (32 at the bench batch);
// mp_pipelined.cu splits an item's step across a thread-block cluster.
#include "mp_step.cuh"

using mp::Geometry;
using mp::kTailAtoms;
using mp::kThreads;

__global__ void __launch_bounds__(kThreads, 1)
fused_step_kernel(float* fm, float* bm, float* residual, const float* __restrict__ d2,
                  const float* __restrict__ gram_p, float* tail, int* atoms, int* positions,
                  float* values, Geometry g) {
  extern __shared__ float4 smem4[];
  __shared__ mp::Scratch s;
  float* ds = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x;
  const mp::Event ev = mp::step_item(fm + (size_t)b * g.N * g.W, bm + (size_t)b * g.N * g.nbt,
                                     residual + (size_t)b * g.L, d2, gram_p,
                                     tail + (size_t)b * g.N * g.A, ds, g, s);
  if (threadIdx.x == 0) {
    atoms[b] = ev.atom;
    positions[b] = ev.position;
    values[b] = ev.value;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_encode_kernel(float* fm, float* bm, float* residual, const float* __restrict__ d2,
                    const float* __restrict__ gram_p, float* tail, int* atoms, int* positions,
                    float* values, Geometry g, int n_steps) {
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
  float* tail_b = tail + (size_t)b * g.N * g.A;
  for (int step = 0; step < n_steps; ++step) {
    const mp::Event ev = mp::step_item(fm_b, bm_b, res, d2, gram_p, tail_b, ds, g, s);
    if (threadIdx.x == 0) {
      atoms[step * B + b] = ev.atom;
      positions[step * B + b] = ev.position;
      values[step * B + b] = ev.value;
    }
  }
  for (int j = threadIdx.x; j < g.L; j += kThreads) res_g[j] = res[j];
}

extern "C" int mp_fused_step(void* fm, void* bm, void* residual, void* d2, void* gram_p,
                             void* tail, void* atoms, void* positions, void* values, int B,
                             int N, int A, int W, int n_samples, int block, int pad,
                             int n_blocks, int nbt, int upd_blocks, int tail_start,
                             int gate_tail, void* stream) {
  const Geometry g = mp::make_geometry(N, A, W, n_samples, block, pad, n_blocks, nbt, upd_blocks,
                                   tail_start, gate_tail);
  const int smem = kTailAtoms * A * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(fused_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_step_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (float*)fm, (float*)bm, (float*)residual, (const float*)d2, (const float*)gram_p,
      (float*)tail, (int*)atoms, (int*)positions, (float*)values, g);
  return (int)cudaGetLastError();
}

extern "C" int mp_fused_encode(void* fm, void* bm, void* residual, void* d2, void* gram_p,
                               void* tail, void* atoms, void* positions, void* values, int B,
                               int N, int A, int W, int n_samples, int block, int pad,
                               int n_blocks, int nbt, int upd_blocks, int tail_start,
                               int gate_tail, int n_steps, void* stream) {
  const Geometry g = mp::make_geometry(N, A, W, n_samples, block, pad, n_blocks, nbt, upd_blocks,
                                   tail_start, gate_tail);
  const int smem = (kTailAtoms * A + g.L) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_encode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_encode_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (float*)fm, (float*)bm, (float*)residual, (const float*)d2, (const float*)gram_p,
      (float*)tail, (int*)atoms, (int*)positions, (float*)values, g, n_steps);
  return (int)cudaGetLastError();
}
