// Launch-overhead probe (sm_90a): what does one kernel launch cost on this
// card, against one iteration of a loop inside a running kernel?
//
// Replaces scripts/grid_overhead_probe.py make("grid" / "fori") (:84,
// pallas_call at :92, bodies :55-81), which set 3,200 sequential Pallas
// grid steps against one in-kernel fori_loop of 3,200. A CUDA grid is not
// sequential, so the card's counterpart of a sequential grid step is a
// launch on one stream:
//
//   probe_grid  zero the (8, 128) f32 tile, then `steps` launches of a
//               one-block kernel, each (with vpu) applying
//               acc = acc * 1.000001f + 1.f to the tile in global memory;
//               with programmatic, enqueued as the port's per-step chains
//               are (mp_window.cuh: launch_step_chain): every launch after
//               the first carries programmatic stream serialization, and
//               its kernel waits (griddepcontrol.wait) before it reads the
//               tile and then lets the next launch start;
//   probe_loop  one launch of one block that zeroes the tile in registers,
//               loops `steps` times over the same update and writes it.
//
// The update is __fadd_rn(__fmul_rn(acc, c), 1.f): product and sum round
// separately, as two PyTorch ops do, so every kind equals the plain version
// bit for bit. Nothing bounds these kernels but latency: they move 4 KiB,
// and their time is the launch cost they exist to measure.
#include <cuda_runtime.h>

constexpr int kTile = 8 * 128;

template <bool kChained>
__global__ void __launch_bounds__(kTile, 1) probe_step_kernel(float* tile, int vpu) {
  if constexpr (kChained) {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  }
  if (vpu) {
    const int i = threadIdx.x;
    tile[i] = __fadd_rn(__fmul_rn(tile[i], 1.000001f), 1.f);
  }
}

__global__ void __launch_bounds__(kTile, 1) probe_loop_kernel(float* tile, int steps, int vpu) {
  float acc = 0.f;
  for (int s = 0; s < steps; ++s) {
    if (vpu) acc = __fadd_rn(__fmul_rn(acc, 1.000001f), 1.f);
    asm volatile("" ::: "memory");   // keep the empty loop's iterations
  }
  tile[threadIdx.x] = acc;
}

extern "C" int probe_grid(void* tile, int steps, int vpu, int programmatic, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(tile, 0, kTile * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  if (!programmatic) {
    for (int s = 0; s < steps; ++s) {
      probe_step_kernel<false><<<1, kTile, 0, st>>>((float*)tile, vpu);
    }
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(1, 1, 1);
  config.blockDim = dim3(kTile, 1, 1);
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  for (int s = 0; s < steps; ++s) {
    config.numAttrs = s > 0 ? 1 : 0;
    err = cudaLaunchKernelEx(&config, probe_step_kernel<true>, (float*)tile, vpu);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" int probe_loop(void* tile, int steps, int vpu, void* stream) {
  probe_loop_kernel<<<1, kTile, 0, (cudaStream_t)stream>>>((float*)tile, steps, vpu);
  return (int)cudaGetLastError();
}
