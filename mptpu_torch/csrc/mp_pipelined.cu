// The per-step fused kernel with one item spread over a thread-block
// cluster (sm_90a), f32 on CUDA cores.
//
// mp_fused_step_pipelined replaces mptpu/sparse/pallas_fused_mp.py
// pallas_fused_step_pipelined (:727, kernel body _pipelined_step_kernel
// :381-709). Its contract is mp_fused_step's, bit for bit: the same
// events, map, block-max table and residual after every launch.
//
// The TPU kernel pipelines item g+1's argmax, refine and fetches under
// item g's update because a TPU grid runs its steps in order on one core.
// On this card items already run on different SMs, so that overlap would
// add nothing; what is serial here is one item's step on one SM, which at
// a small batch leaves the card idle (4 of 132 SMs at the multiband batch),
// and one step after another on the stream. So the step of one item is
// shared by the C blocks of a cluster, rank r owning atom rows
// [r * N / C, (r + 1) * N / C), and a call enqueues a chain of steps whose
// launches overlap: the step body of mp_window.cuh (enc::encode_body, which
// says what a step does and how) with kStep and kCluster.
//
// What bounds it: at the bench shapes bytes, as mp_fused_step (one gram row,
// the update window both ways); at a multiband band's shapes (a 3-block
// window of 128-tap atoms, 8 MB a step for 4 items) latency: the bytes bound
// lies below the cost of one launch. Against that: one cluster barrier on
// the step's path (every rank refines its own candidate and hands it to its
// peers before the barrier, so nobody reads a peer's shared memory after
// it), up to 16 blocks per item (a rank's rows cost instructions, not
// bytes: some 600 a row), all of a rank's rows in flight at once as bulk
// copies, the rows' maxima kept in the chain's scratch instead of a table
// scan per launch, and programmatic stream serialization, under which a
// launch's latency and preamble hide under the step before it.
#include "mp_window.cuh"

using enc::Geometry;

__global__ void __launch_bounds__(enc::kThreads, 1)
fused_step_pipelined_kernel(float* fm, float* bm, float* residual, const float* __restrict__ d2,
                            const float* __restrict__ gram_p, float* tail, int* atoms,
                            int* positions, float* values, Geometry g, int stages, float* rows,
                            int have_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  enc::encode_body<true, true, enc::kStepStages, enc::kStepRowRegs, false>(
      fm, bm, nullptr, residual, d2, gram_p, tail, atoms, positions, values, g, 1, stages, 0, rows,
      have_rows, smem_raw);
}

// what CUDA has been told about the kernel
static enc::Setups setup;

// n_steps greedy steps, one launch each, enqueued on the stream in one call:
// step s writes its events into row s of (n_steps, B) outputs. rows is
// scratch of 2 x B x N words, tail of B x N x A floats.
extern "C" int mp_fused_step_pipelined(void* fm, void* bm, void* residual, void* d2,
                                       void* gram_p, void* tail, void* rows, void* atoms,
                                       void* positions, void* values, int B, int N, int A, int W,
                                       int n_samples, int block, int pad, int n_blocks, int nbt,
                                       int upd_blocks, int tail_start, int gate_tail,
                                       int n_steps, int programmatic, int cluster_size,
                                       void* stream) {
  const Geometry g = enc::make_geometry(N, A, W, n_samples, block, pad, n_blocks, nbt, upd_blocks,
                                       tail_start, gate_tail);
  return (int)enc::launch_step_chain(fused_step_pipelined_kernel, setup, true, fm, bm,
                                     residual, d2, gram_p, tail, rows, atoms, positions, values,
                                     B, g, cluster_size, n_steps, programmatic, stream);
}

// The plan of mp_fused_step_pipelined at these shapes and cluster size,
// without a launch: out = {clusters of that size the card holds at once,
// ring stages, dynamic shared-memory bytes}, all 0 where the shapes admit no
// plan.
extern "C" int mp_fused_step_pipelined_plan(int N, int A, int block, int n_blocks,
                                            int upd_blocks, int cluster_size, int* out) {
  return enc::step_plan(fused_step_pipelined_kernel, setup, N, A, block, n_blocks,
                        upd_blocks, cluster_size, out);
}
