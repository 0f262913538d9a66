// Fused greedy fast-MP kernels for Hopper (sm_90a), f32 on CUDA cores.
//
// mp_fused_step replaces mptpu/sparse/pallas_fused_mp.py pallas_fused_step
// (:289, kernel body _step_kernel :69-272): one launch per greedy step, one
// 512-thread block per batch item, or a chain of such launches in one call.
//
// mp_fused_encode replaces pallas_fused_encode (:1219, kernel body
// _whole_loop_kernel :834-1198): one launch for the whole encode, one
// thread-block cluster per item with the step loop inside the kernel.
//
// Both run the step body of mp_window.cuh (enc::encode_body), which says
// what a step does and how; mp_pipelined.cu's cluster step kernel and
// mp_lane.cu's lane-table encode are its other users.
//
// What bounds them on this card: bytes. Each item-step reads one gram row
// (N x 2A floats, 2 MiB at 512 atoms x 512 taps) and reads and writes its
// update window (N x upd_blocks*block floats, 2.25 MiB each way): about
// 6.8 MB, so 3,200 item-steps move about 21.8 GB, 6.5 ms at 3.35 TB/s. A
// clipped event adds the N x A x A tail product (268 MFLOP). What the design
// does about it is the ring of bulk copies (some 200 KB of loads in flight
// per SM without a register spent) and, for the whole encode, C SMs per
// item: C is chosen so that all items' clusters are resident at once
// (mp_fused_encode_plan), since the kernel loops over every step and a
// second wave would double its time; a rank's share of the block-max table
// stays in shared memory for the whole encode where it fits beside a ring of
// kMinStagesWithTable stages. The per-step kernel has one block per item, so
// at most as many SMs as items stream: it is the kernel the others are held
// against bit for bit, not the fast one.
#include "mp_window.cuh"

using enc::Geometry;

__global__ void __launch_bounds__(enc::kThreads, 1)
fused_step_kernel(float* fm, float* bm, float* residual, const float* __restrict__ d2,
                  const float* __restrict__ gram_p, float* tail, int* atoms, int* positions,
                  float* values, Geometry g, int stages, float* rows, int have_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  enc::encode_body<true, false, enc::kStepStages, enc::kStepRowRegs, false>(
      fm, bm, nullptr, residual, d2, gram_p, tail, atoms, positions, values, g, 1, stages, 0, rows,
      have_rows, smem_raw);
}

// what CUDA has been told about the two kernels of this file
static enc::Setups step_setup, encode_setup;

// n_steps greedy steps, one launch each, enqueued on the stream in one call:
// step s writes its events into row s of (n_steps, B) outputs. rows is
// scratch of 2 x B x N words, tail of B x N x A floats.
extern "C" int mp_fused_step(void* fm, void* bm, void* residual, void* d2, void* gram_p,
                             void* tail, void* rows, void* atoms, void* positions, void* values,
                             int B, int N, int A, int W, int n_samples, int block, int pad,
                             int n_blocks, int nbt, int upd_blocks, int tail_start,
                             int gate_tail, int n_steps, int programmatic, void* stream) {
  const Geometry g = enc::make_geometry(N, A, W, n_samples, block, pad, n_blocks, nbt, upd_blocks,
                                       tail_start, gate_tail);
  return (int)enc::launch_step_chain(fused_step_kernel, step_setup, false, fm, bm,
                                     residual, d2, gram_p, tail, rows, atoms, positions, values,
                                     B, g, 1, n_steps, programmatic, stream);
}

// ---- the whole encode over thread-block clusters

__global__ void __launch_bounds__(enc::kThreads, 1)
fused_encode_kernel(float* fm, float* bm, float* residual, const float* __restrict__ d2,
                    const float* __restrict__ gram_p, float* tail, int* atoms, int* positions,
                    float* values, Geometry g, int n_steps, int stages, int table_on_chip) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  enc::encode_body<false, true, enc::kMaxStages, enc::kRowRegs, false>(
      fm, bm, nullptr, residual, d2, gram_p, tail, atoms, positions, values, g, n_steps, stages,
      table_on_chip, nullptr, 0, smem_raw);
}

extern "C" int mp_fused_encode(void* fm, void* bm, void* residual, void* d2, void* gram_p,
                               void* tail, void* atoms, void* positions, void* values, int B,
                               int N, int A, int W, int n_samples, int block, int pad,
                               int n_blocks, int nbt, int upd_blocks, int tail_start,
                               int gate_tail, int n_steps, int cluster_size, void* stream) {
  const Geometry g = enc::make_geometry(N, A, W, n_samples, block, pad, n_blocks, nbt, upd_blocks,
                                       tail_start, gate_tail);
  return (int)enc::launch_encode(fused_encode_kernel, encode_setup, false, B, cluster_size, g,
                                 n_steps, stream, (float*)fm, (float*)bm, (float*)residual,
                                 (const float*)d2, (const float*)gram_p, (float*)tail,
                                 (int*)atoms, (int*)positions, (float*)values);
}

// The plan of mp_fused_encode at these shapes and cluster size, without a
// launch: out = {clusters of that size the card holds at once
// (cudaOccupancyMaxActiveClusters; more items than that run in waves), ring
// stages, whether the table is on chip, dynamic shared-memory bytes}, all 0
// where the shapes admit no plan.
extern "C" int mp_fused_encode_plan(int N, int A, int block, int n_blocks, int upd_blocks,
                                    int cluster_size, int* out) {
  return enc::encode_plan(fused_encode_kernel, encode_setup, false, N, A, block, n_blocks,
                          upd_blocks, cluster_size, out);
}
