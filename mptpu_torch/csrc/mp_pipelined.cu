// The per-step fused kernel with one item spread over a thread-block
// cluster (sm_90a), f32 on CUDA cores.
//
// mp_fused_step_pipelined replaces mptpu/sparse/pallas_fused_mp.py
// pallas_fused_step_pipelined (:727, kernel body _pipelined_step_kernel
// :381-709). Its contract is mp_fused_step's, bit for bit: the same
// events, map, block-max table and residual after the launch.
//
// The TPU kernel pipelines item g+1's argmax, refine and fetches under
// item g's update because a TPU grid runs its steps in order on one core.
// On this card items already run on different SMs, so that overlap would
// add nothing; what is serial here is one item's step on one SM, which at
// a small batch leaves the card idle (4 of 132 SMs at the multiband batch).
// So the step of one item is shared by the C blocks of a cluster, rank r
// owning atom rows [r * N / C, (r + 1) * N / C) of the map, the table, the
// gram row and the tail:
//
//   select   each rank takes the first maximum of its table rows; the C
//            (value, flat index) pairs meet through distributed shared
//            memory and every rank keeps the first flat index among equal
//            maxima; every rank reads the winner's block for the refine;
//   surgery  rank 0 updates the residual row in global memory; every rank
//            repeats it on a shared-memory copy of the last 2A samples
//            (taken before the first cluster barrier), which is all the
//            tail product reads, so no rank waits for rank 0's write;
//   update   tail product, window subtract, tail splice and block maxima
//            on the rank's own rows (mp::update_rows), each tail sum in
//            the same k-ascending FMA order as the one-block kernel.
//
// Two cluster barriers: one before the candidates are read, one after the
// refine (the winner's map row is rewritten by its owner in the update,
// and a block may not exit while another reads its shared memory).
//
// What bounds it: bytes, as mp_fused_step (one gram row, the update window
// both ways, the table); C SMs now stream them together.
#include <cooperative_groups.h>

#include "mp_step.cuh"

namespace cg = cooperative_groups;
using mp::Geometry;
using mp::kTailAtoms;
using mp::kThreads;

struct Candidate {
  float v;
  int i;
};

__global__ void __launch_bounds__(kThreads, 1)
fused_step_pipelined_kernel(float* fm, float* bm, float* residual, const float* __restrict__ d2,
                            const float* __restrict__ gram_p, float* tail, int* atoms,
                            int* positions, float* values, Geometry g) {
  extern __shared__ float4 smem4[];
  __shared__ mp::Scratch s;
  __shared__ Candidate cand;
  float* ds = reinterpret_cast<float*>(smem4);
  float* seg = ds + kTailAtoms * g.A;   // residual samples [n_samples - A, n_samples + A)
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.y, tid = threadIdx.x;
  const int nrows = g.N / C, row0 = rank * nrows;
  float* fm_b = fm + (size_t)b * g.N * g.W;
  float* bm_b = bm + (size_t)b * g.N * g.nbt;
  float* res_b = residual + (size_t)b * g.L;
  float* tail_b = tail + (size_t)b * g.N * g.A;

  // select: own rows, then the first maximum among the ranks' candidates
  for (int j = tid; j < 2 * g.A; j += kThreads) seg[j] = res_b[g.n_samples - g.A + j];
  float v;
  int idx;
  mp::table_first_max(bm_b, row0, nrows, g, s, v, idx);
  if (tid == 0) {
    cand.v = v;
    cand.i = idx;
  }
  cluster.sync();
  v = -CUDART_INF_F;
  idx = INT_MAX;
  for (int r = 0; r < C; ++r) {
    const Candidate* c = cluster.map_shared_rank(&cand, r);
    mp::keep_first_max(v, idx, c->v, c->i);
  }
  const int atom = idx / g.n_blocks;
  float value;
  int position;
  mp::refine_block(fm_b, atom, idx - atom * g.n_blocks, g, s, value, position);
  cluster.sync();

  // surgery: the row in global memory once, the tail segment in every rank
  const float* drow = d2 + (size_t)atom * g.A;
  if (rank == 0) mp::residual_surgery(res_b, drow, position, value, g);
  const bool clipped = mp::event_clipped(position, g);
  if (clipped) {
    mp::segment_surgery(seg, drow, position, value, g);
    mp::tail_product(seg, d2 + (size_t)row0 * g.A, tail_b + (size_t)row0 * g.A, ds, nrows, g.A);
  }
  mp::update_rows<false>(fm_b, bm_b, nullptr, tail_b, gram_p, atom, position, value, clipped,
                         row0, nrows, g);
  if (rank == 0 && tid == 0) {
    atoms[b] = atom;
    positions[b] = position;
    values[b] = value;
  }
}

static cudaError_t cluster_config(cudaLaunchConfig_t& config, cudaLaunchAttribute* attr, int B,
                                  int A, int cluster_size, void* stream) {
  const int smem = (kTailAtoms * A + 2 * A) * (int)sizeof(float);
  config = cudaLaunchConfig_t{};
  config.gridDim = dim3(cluster_size, B, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaFuncSetAttribute(fused_step_pipelined_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

extern "C" int mp_fused_step_pipelined(void* fm, void* bm, void* residual, void* d2,
                                       void* gram_p, void* tail, void* atoms, void* positions,
                                       void* values, int B, int N, int A, int W, int n_samples,
                                       int block, int pad, int n_blocks, int nbt,
                                       int upd_blocks, int tail_start, int gate_tail,
                                       int cluster_size, void* stream) {
  if (cluster_size < 1 || cluster_size > 8 || N % cluster_size) return (int)cudaErrorInvalidValue;
  const Geometry g = mp::make_geometry(N, A, W, n_samples, block, pad, n_blocks, nbt, upd_blocks,
                                       tail_start, gate_tail);
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config(config, attr, B, A, cluster_size, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&config, fused_step_pipelined_kernel, (float*)fm, (float*)bm,
                           (float*)residual, (const float*)d2, (const float*)gram_p,
                           (float*)tail, (int*)atoms, (int*)positions, (float*)values, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of cluster_size blocks the card can hold at once for
// this kernel at A taps (a launch of more clusters runs in waves), or minus
// the CUDA error code.
extern "C" int mp_fused_step_pipelined_max_clusters(int A, int cluster_size) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config(config, attr, 1, A, cluster_size, nullptr);
  if (err != cudaSuccess) return -(int)err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fused_step_pipelined_kernel, &config);
  return err == cudaSuccess ? clusters : -(int)err;
}
