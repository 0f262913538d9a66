// The whole-encode fused kernel with a lane table (sm_90a), f32 on CUDA
// cores.
//
// mp_fused_encode_lane replaces mptpu/sparse/pallas_fused_mp.py
// pallas_fused_encode_lane (:1692, kernel body _whole_loop_lane_kernel
// :1357-1673): mp_fused_encode's function, in place on fm, bm and the
// residual, plus an int32 table lanes (B, N, nbt) of the first lane of each
// block's maximum, kept current in place (0 in the pad columns). The
// winner's value is its block-max entry and its position blk * block +
// lanes[atom, blk] - pad, so a step selects without reading the map; events,
// map, table and residual equal mp_fused_encode's bit for bit.
//
// Design: mp_fused_encode's, the step body of mp_window.cuh
// (enc::encode_body) with kLanes: one thread-block cluster of C blocks per
// item looping over the steps, rank r owning atom rows [r * N / C,
// (r + 1) * N / C); the window of each row and its gram row arrive by bulk
// asynchronous copies in a ring of shared-memory stages; the warp that
// subtracts a window chunk takes the first lane of its maximum with one more
// redux, and writes it beside the block maximum. Each rank keeps per row the
// maximum, its first block and that block's lane in shared memory, so the
// select is a scan of N / C rows in shared memory and one cluster barrier.
// Both tables of a rank go on chip or stay in L2 together (make_plan); at
// the bench shapes they stay in L2 (32 items take clusters of 2).
//
// What bounds it on this card: bytes, as mp_fused_encode: per item-step one
// gram row (N x 2A floats) read and the update window (N x upd_blocks *
// block floats) read and written, plus the window blocks' lanes
// (N x upd_blocks ints) written and less the refine's read of the winner's
// block; a clipped event adds the N x A x A tail product.
#include "mp_window.cuh"

using enc::Geometry;

__global__ void __launch_bounds__(enc::kThreads, 1)
fused_encode_lane_kernel(float* fm, float* bm, int* lanes, float* residual,
                         const float* __restrict__ d2, const float* __restrict__ gram_p,
                         float* tail, int* atoms, int* positions, float* values, Geometry g,
                         int n_steps, int stages, int table_on_chip) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  enc::encode_body<false, true, enc::kMaxStages, enc::kRowRegs, true>(
      fm, bm, lanes, residual, d2, gram_p, tail, atoms, positions, values, g, n_steps, stages,
      table_on_chip, nullptr, 0, smem_raw);
}

// what CUDA has been told about the kernel
static enc::Setups setup;

// The whole n_steps loop in one launch, events into (n_steps, B) outputs;
// tail is scratch of B x N x A floats.
extern "C" int mp_fused_encode_lane(void* fm, void* bm, void* lanes, void* residual, void* d2,
                                    void* gram_p, void* tail, void* atoms, void* positions,
                                    void* values, int B, int N, int A, int W, int n_samples,
                                    int block, int pad, int n_blocks, int nbt, int upd_blocks,
                                    int tail_start, int gate_tail, int n_steps, int cluster_size,
                                    void* stream) {
  const Geometry g = enc::make_geometry(N, A, W, n_samples, block, pad, n_blocks, nbt, upd_blocks,
                                        tail_start, gate_tail);
  return (int)enc::launch_encode(fused_encode_lane_kernel, setup, true, B, cluster_size, g,
                                 n_steps, stream, (float*)fm, (float*)bm, (int*)lanes,
                                 (float*)residual, (const float*)d2, (const float*)gram_p,
                                 (float*)tail, (int*)atoms, (int*)positions, (float*)values);
}

// The plan of mp_fused_encode_lane at these shapes and cluster size, without
// a launch: out = {clusters of that size the card holds at once, ring
// stages, whether both tables are on chip, dynamic shared-memory bytes}, all
// 0 where the shapes admit no plan.
extern "C" int mp_fused_encode_lane_plan(int N, int A, int block, int n_blocks, int upd_blocks,
                                         int cluster_size, int* out) {
  return enc::encode_plan(fused_encode_lane_kernel, setup, true, N, A, block, n_blocks,
                          upd_blocks, cluster_size, out);
}
