// The greedy fast-MP step body that the two whole-encode kernels
// (mp_fused.cu: mp_fused_encode, mp_lane.cu: mp_fused_encode_lane) and the
// two per-step kernels (mp_fused.cu: mp_fused_step, mp_pipelined.cu:
// mp_fused_step_pipelined) share: one function template, encode_body,
// instantiated four times.
//
// It computes what the Pallas step body computes
// (mptpu/sparse/pallas_fused_mp.py _step_kernel, :69-272), indexing directly
// where the TPU kernel rolls lanes, builds a Hankel matrix by a roll ladder,
// places block maxima by a one-hot matmul and refines from an 8-row slab.
//
// One item belongs to C thread blocks (a cluster, or one block), rank r
// owning atom rows [r * N / C, (r + 1) * N / C) of the map, the block-max
// table, the gram row and the tail. A step is
//
//   select   every rank takes the first maximum of its table rows and
//            refines it inside its own map block; it writes the candidate
//            (table value, flat index, refined value, position) into every
//            rank's shared memory (distributed shared memory), so that
//            behind ONE cluster barrier each rank finds all C candidates at
//            home and keeps the first flat index among equal maxima;
//   surgery  rank 0 updates the residual row in global memory; every rank
//            repeats it on a shared-memory copy of the last 2A samples,
//            which is all the tail product reads;
//   window   no thread loads the window. Per atom row two bulk asynchronous
//            copies (the block-aligned window of fm and the gram row) land
//            in a ring of shared-memory stages and complete on an mbarrier;
//            a warp owns every kWarps-th stage, subtracts, splices the exact
//            tail and takes the block maxima from shared memory, 16 bytes a
//            lane (the misaligned gram offset is a compile-time shift
//            between two aligned loads; a chunk wholly inside the gram's
//            span needs no range test; a warp's maximum is one redux on
//            order-preserving ints), writes the new window to the map from
//            its registers and refills the stage. The warp also takes the
//            row's maximum again: a row whose maximum lay outside the window
//            keeps it beside the window's new block maxima, and only a row
//            whose maximum lay inside reads its other table entries.
//
// kStep = false is the whole encode: the step loop runs inside the kernel,
// each rank keeps the maximum of each of its table rows (and the first block
// that holds it) in shared memory across the steps, so a step scans N / C
// pairs, and its table share stays on chip where the plan allows.
//
// kStep = true is one step per launch, for a chain of launches on one
// stream. Shared memory does not live across launches, so the rows' maxima
// live in a global scratch that the chain owns (the first launch of a chain
// scans the table to fill it; the window pass keeps it current, as it keeps
// bm itself exact); the residual tail is loaded into registers early and
// staged in shared memory only for a clipped event (atoms of more taps than
// the registers hold stage it at once); and whatever does not depend on the
// previous step (the shared-memory carve-up, the mbarriers) is done before
// griddepcontrol.wait, so that under programmatic stream serialization a
// launch's latency hides under the step before it.
//
// kLanes (whole encode only) keeps beside the block-max table an int table
// of the same layout, the first lane of each block's maximum, and beside
// each row's maximum and first block the lane of that maximum, so that the
// select reads the winner's value and position from shared memory and no
// map block: the candidate is (table value, flat index, table value, its
// lane's position). The window pass takes each block's first maximum lane
// with its maximum (float equality against the maximum, the smallest lane
// winning; an earlier chunk of a block keeps a tie), and every path that
// writes a table entry writes its lane.
//
// No rank touches a peer's shared memory after the step's one cluster
// barrier (the candidates are pushed before it), so a block may exit as soon
// as its rows are done; that every peer runs before the first push is what a
// split barrier says, arrived at in the first instruction and long complete
// where it is waited for.
//
// Numerics are those of the plain version: the window subtract is
// __fsub_rn(a, __fmul_rn(v, g)) (nvcc would otherwise contract a - v*g into
// one FMA, while the plain PyTorch version rounds the product and the
// difference separately) and each tail sum a k-ascending f32 FMA chain, so
// events, map, table and residual are the same bit for bit at any cluster
// size and in all four kernels. Ties keep the first (smallest) flat index
// among equal maxima, as torch.argmax and jnp.argmax do.
#pragma once

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <type_traits>

namespace enc {

namespace cg = cooperative_groups;

struct Geometry {
  int N;           // atoms
  int A;           // taps
  int W;           // padded correlation-map width
  int L;           // residual row length, n_samples + A
  int n_samples;
  int block;       // lanes per block of the block-max table
  int pad;         // left pad of the map
  int n_blocks;    // real blocks per map row
  int nbt;         // row stride of the block-max table (n_blocks or lane-padded)
  int upd_blocks;  // blocks an update window spans
  int tail_start;  // map offset of the last A positions
  int gate_tail;   // recompute the tail only for clipped events
};

inline Geometry make_geometry(int N, int A, int W, int n_samples, int block, int pad,
                              int n_blocks, int nbt, int upd_blocks, int tail_start,
                              int gate_tail) {
  return Geometry{N, A, W, n_samples + A, n_samples, block, pad,
                  n_blocks, nbt, upd_blocks, tail_start, gate_tail};
}

__device__ __forceinline__ void keep_first_max(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Whether the boundary tail must be recomputed for an event at position:
// only when its atom ran past the signal end (for interior events the gram
// subtract is exact), or always without the gate.
__device__ __forceinline__ bool event_clipped(int position, const Geometry g) {
  return !g.gate_tail || position > g.n_samples - g.A;
}

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTailAtoms = 8;    // atoms per shared-memory chunk of the tail product
constexpr int kMaxStages = 24;   // ring depth of the whole-encode kernel
constexpr int kStepStages = 64;  // ring depth of the per-step kernels
// blocks per item of the cluster step kernel; above 8 a cluster is one the
// CUDA model calls non-portable, which this card takes
constexpr int kMaxStepCluster = 16;
constexpr int kUnroll = 4;       // 128-float chunks of a window in flight per warp
// table entries of a row a lane keeps in registers across the row's window:
// enough for the bench map's 136 blocks, and for a 2^15-sample band's 258
constexpr int kRowRegs = 5;
constexpr int kStepRowRegs = 9;
constexpr int kSegRegs = 2;      // residual-tail samples a thread holds (per-step kernels)
// the table goes on chip only where that leaves the ring this many stages
constexpr int kMinStagesWithTable = 16;
// dynamic shared memory of a block: the card's 227 KB less the static part
constexpr int kSmemBudget = 232448 - 768;
constexpr int kStepSmemBudget = 232448 - 1024;

struct Candidate {
  float v;       // table value the ranks compare
  int idx;       // flat index atom * n_blocks + blk
  float value;   // the map's value there, refined
  int position;
};

struct Scratch {
  float v[kWarps];
  int i[kWarps];
  float rv;
  int ri;
};

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> shared, completing bytes on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// orders this thread's accesses through the generic proxy (its stores to the
// map) with those of the asynchronous proxy (the next step's bulk loads)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// The two halves of a cluster barrier. Every thread of the block runs both.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Under programmatic stream serialization: block until the launch before
// this one on the stream has completed and its writes are visible (returns
// at once in a launch without the attribute), and let the launch after this
// one start its own preamble.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// An int whose order is the float's (no NaN), and back: a warp's float
// maximum is then one redux operation instead of five shuffles.
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float ordered_back(int i) {
  return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
}

// Block-wide (value, index) of the first maximum; every thread gets it.
__device__ __forceinline__ void block_first_max(float& v, int& i, Scratch& s) {
  const unsigned full = 0xffffffffu;
  for (int o = 16; o > 0; o >>= 1) {
    keep_first_max(v, i, __shfl_down_sync(full, v, o), __shfl_down_sync(full, i, o));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s.v[warp] = v;
    s.i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? s.v[lane] : -CUDART_INF_F;
    i = lane < kWarps ? s.i[lane] : INT_MAX;
    for (int o = 16; o > 0; o >>= 1) {
      keep_first_max(v, i, __shfl_down_sync(full, v, o), __shfl_down_sync(full, i, o));
    }
    if (lane == 0) {
      s.rv = v;
      s.ri = i;
    }
  }
  __syncthreads();
  v = s.rv;
  i = s.ri;
}

// tail[a, p] = sum_k d2[a, k] * seg[p + k] for a < nrows, p < A: one
// k-ascending FMA chain each, kTailAtoms rows of d2 staged in ds at a time.
// Ends with __syncthreads().
static __device__ void tail_rows(const float* seg, const float* __restrict__ d2, float* tail,
                                 float* ds, int nrows, int A) {
  for (int a0 = 0; a0 < nrows; a0 += kTailAtoms) {
    for (int e = threadIdx.x; e < kTailAtoms * A; e += kThreads) {
      ds[e] = a0 + e / A < nrows ? d2[(size_t)a0 * A + e] : 0.f;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < A; p += kThreads) {
      const float* r = seg + p;
      float acc[kTailAtoms] = {};
      for (int k = 0; k < A; k += 4) {
        const float r0 = r[k], r1 = r[k + 1], r2 = r[k + 2], r3 = r[k + 3];
#pragma unroll
        for (int i = 0; i < kTailAtoms; ++i) {
          const float4 wv = *reinterpret_cast<const float4*>(ds + i * A + k);
          acc[i] = fmaf(wv.x, r0, acc[i]);
          acc[i] = fmaf(wv.y, r1, acc[i]);
          acc[i] = fmaf(wv.z, r2, acc[i]);
          acc[i] = fmaf(wv.w, r3, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kTailAtoms; ++i) {
        if (a0 + i < nrows) tail[(size_t)(a0 + i) * A + p] = acc[i];
      }
    }
    __syncthreads();
  }
}

// (value, column) of the first maximum over a warp's lanes, each holding the
// first maximum of its own ascending columns; every lane gets it.
__device__ __forceinline__ void warp_first_max(float& v, int& c) {
  const float m = ordered_back(__reduce_max_sync(0xffffffffu, ordered(v)));
  c = __reduce_min_sync(0xffffffffu, v == m ? c : INT_MAX);
  v = m;
}

// The greedy loop of one item's rank: n_steps steps in place on fm, bm and
// the residual, the events of step s into row s of atoms / positions / values
// (rows of gridDim.y items). The grid is (C, items); with kCluster its x
// dimension is one thread-block cluster, without it C is 1. With kStep,
// n_steps is 1 and table_on_chip 0, and rows is the chain's scratch of
// 2 x items x N words (the rows' maxima as floats, then their first blocks
// as ints), which this launch fills first unless have_rows; without kStep
// both are unused. smem is the block's dynamic shared memory, laid out as
// make_plan counts it. kStages bounds stages. With kLanes, lanes is the lane
// table (bm's layout), kept current in place; without it, unused.
template <bool kStep, bool kCluster, int kStages, int kRegs, bool kLanes>
__device__ __forceinline__ void encode_body(float* fm, float* bm, int* lanes, float* residual,
                                            const float* __restrict__ d2,
                                            const float* __restrict__ gram_p, float* tail,
                                            int* atoms, int* positions, float* values,
                                            const Geometry g, int n_steps, int stages,
                                            int table_on_chip, float* rows, int have_rows,
                                            unsigned char* smem) {
  static_assert(!(kStep && kLanes), "the lane table is the whole encode's");
  __shared__ Scratch s;
  // every rank's candidate of a step, written here by the ranks themselves
  // (double-buffered where the step loop is inside the kernel)
  __shared__ Candidate cand[kStep ? 1 : 2][kStep ? kMaxStepCluster : 8];
  __shared__ __align__(8) uint64_t full[kStages];
  cg::cluster_group cluster = cg::this_cluster();
  // a rank may write into a peer's shared memory only once that peer runs:
  // arrive here, wait just before the first candidate is handed out
  if constexpr (kCluster) cluster_arrive();
  const int C = kCluster ? (int)cluster.num_blocks() : 1;
  const int rank = kCluster ? (int)cluster.block_rank() : 0;
  const int b = blockIdx.y, B = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nrows = g.N / C, row0 = rank * nrows;
  const int upd_w = g.upd_blocks * g.block, stage_floats = upd_w + 2 * g.A;
  const uint32_t win_bytes = upd_w * sizeof(float), gram_bytes = 2 * g.A * sizeof(float);

  float* ds = reinterpret_cast<float*>(smem);
  float* seg = ds + kTailAtoms * g.A;   // residual samples [n_samples - A, n_samples + A)
  float* ring = seg + 2 * g.A;
  // per table row of the rank: its maximum and the first block that holds it
  float* rmax = ring + (size_t)stages * stage_floats;
  int* rarg = reinterpret_cast<int*>(rmax + nrows);
  int* rlane = rarg + nrows;   // kLanes: the lane of each row's maximum in block rarg
  if constexpr (kStep) {
    rmax = rows + (size_t)b * g.N + row0;
    rarg = reinterpret_cast<int*>(rows + (size_t)B * g.N) + (size_t)b * g.N + row0;
  }
  float* fm_b = fm + (size_t)b * g.N * g.W;
  float* bm_b = bm + (size_t)b * g.N * g.nbt;
  float* res_b = residual + (size_t)b * g.L;
  float* tail_b = tail + (size_t)b * g.N * g.A;

  // the rank's table rows, tbl[r * tstride + blk] for its r-th row, and with
  // kLanes its lane-table rows ltbl alike
  float* tbl = bm_b + (size_t)row0 * g.nbt;
  int* ltbl = kLanes ? lanes + ((size_t)b * g.N + row0) * g.nbt : nullptr;
  int tstride = g.nbt;
  auto summarise_rows = [&]() {
    for (int r = warp; r < nrows; r += kWarps) {
      float v = -CUDART_INF_F;
      int c_first = INT_MAX;
      for (int c = lane; c < g.n_blocks; c += 32) {
        const float x = tbl[r * tstride + c];
        if (x > v) {
          v = x;
          c_first = c;
        }
      }
      warp_first_max(v, c_first);
      if (lane == 0) {
        rmax[r] = v;
        rarg[r] = c_first == INT_MAX ? 0 : c_first;
        if constexpr (kLanes) rlane[r] = c_first == INT_MAX ? 0 : ltbl[r * tstride + c_first];
      }
    }
  };
  float tail_regs[kSegRegs];   // kStep: residual samples n_samples - A + tid + q * kThreads
  // kStep: more taps than that go to the shared-memory segment straight away
  const bool seg_staged = g.A > kSegRegs * kThreads;
  if constexpr (kStep) {
    if (tid == 0) {
      for (int st = 0; st < stages; ++st) mbar_init(&full[st], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    grid_dependency_wait();
    launch_dependents();
    if (seg_staged) {   // read behind the select's block barriers
      for (int j = tid; j < 2 * g.A; j += kThreads) {
        seg[j] = j < g.A ? __ldcg(res_b + g.n_samples - g.A + j) : 0.f;
      }
    } else {
#pragma unroll
      for (int q = 0; q < kSegRegs; ++q) {
        const int j = tid + q * kThreads;
        tail_regs[q] = j < g.A ? __ldcg(res_b + g.n_samples - g.A + j) : 0.f;
      }
    }
    if (rank == 0) {
      for (int j = g.n_samples + tid; j < g.L; j += kThreads) res_b[j] = 0.f;
    }
    if (!have_rows) {
      summarise_rows();
      __syncthreads();
    }
  } else {
    if (table_on_chip) {
      tbl = rmax + (kLanes ? 3 : 2) * nrows;
      tstride = g.n_blocks;
      int* const lanes_g = ltbl;
      if constexpr (kLanes) ltbl = reinterpret_cast<int*>(tbl + (size_t)nrows * g.n_blocks);
      for (int r = warp; r < nrows; r += kWarps) {
        for (int c = lane; c < g.n_blocks; c += 32) {
          tbl[r * tstride + c] = bm_b[(size_t)(row0 + r) * g.nbt + c];
          if constexpr (kLanes) ltbl[r * tstride + c] = lanes_g[(size_t)r * g.nbt + c];
        }
      }
      __syncthreads();
    }
    summarise_rows();
    for (int j = tid; j < 2 * g.A; j += kThreads) {
      seg[j] = j < g.A ? res_b[g.n_samples - g.A + j] : 0.f;
    }
    if (rank == 0 && n_steps > 0) {
      for (int j = g.n_samples + tid; j < g.L; j += kThreads) res_b[j] = 0.f;
    }
    if (tid == 0) {
      for (int st = 0; st < stages; ++st) mbar_init(&full[st], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if constexpr (kCluster) cluster_wait();
  }

  uint32_t phases = 0;   // bit k: parity of the next fill of this warp's k-th stage
  for (int step = 0; step < (kStep ? 1 : n_steps); ++step) {
    // select: first maximum of the rank's rows, refined in its map block
    float v = -CUDART_INF_F;
    int idx = INT_MAX;
    for (int r = tid; r < nrows; r += kThreads) {
      keep_first_max(v, idx, rmax[r], (row0 + r) * g.n_blocks + rarg[r]);
    }
    block_first_max(v, idx, s);
    if constexpr (kStep && kCluster) cluster_wait();   // every peer runs by now
    if (warp == 0) {
      const int row = idx / g.n_blocks, blk = idx - row * g.n_blocks;
      float fv;
      int fl;
      if constexpr (kLanes) {
        // the table entry is the value, the row's lane the lane: no map read
        fv = v;
        fl = rlane[row - row0];
      } else {
        // straight from L2, where the window pass's stores to the map land
        const float* p = fm_b + (size_t)row * g.W + (size_t)blk * g.block;
        fv = -CUDART_INF_F;
        fl = INT_MAX;
        for (int l = lane; l < g.block; l += 32) {
          const float x = __ldcg(p + l);
          if (x > fv) {
            fv = x;
            fl = l;
          }
        }
        warp_first_max(fv, fl);
        if (fl == INT_MAX) fl = 0;
      }
      // lane l hands the candidate to rank l, so that after the barrier
      // every rank reads its own shared memory only
      if (lane < C) {
        Candidate* mine = &cand[step & 1][rank];
        if constexpr (kCluster) mine = cluster.map_shared_rank(mine, lane);
        *mine = Candidate{v, idx, fv, blk * g.block + fl - g.pad};
      }
    }
    if constexpr (kCluster) {
      cluster.sync();
    } else {
      __syncthreads();
    }
    // lane l takes rank l % C's candidate (C is a power of two), and a
    // butterfly over C lanes leaves the first maximum in every lane
    Candidate won = cand[step & 1][lane & (C - 1)];
    for (int o = C >> 1; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, won.v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, won.idx, o);
      const float oval = __shfl_xor_sync(0xffffffffu, won.value, o);
      const int opos = __shfl_xor_sync(0xffffffffu, won.position, o);
      if (ov > won.v || (ov == won.v && oi < won.idx)) won = Candidate{ov, oi, oval, opos};
    }
    idx = won.idx;
    const float value = won.value;
    const int position = won.position;
    const int atom = idx / g.n_blocks;

    // the ring's first fills need only the winner: start them now
    const int ustart = position + g.pad - (g.A - 1);
    const int ws_blk = min(ustart / g.block, g.n_blocks - g.upd_blocks);
    const int off = ustart - ws_blk * g.block;
    float* fwin = fm_b + (size_t)row0 * g.W + (size_t)ws_blk * g.block;
    const float* grow = gram_p + ((size_t)atom * g.N + row0) * 2 * g.A;
    auto fill = [&](int i, int st) {
      float* stage = ring + (size_t)st * stage_floats;
      mbar_expect_tx(&full[st], win_bytes + gram_bytes);
      bulk_load(stage, fwin + (size_t)i * g.W, win_bytes, &full[st]);
      bulk_load(stage + upd_w, grow + (size_t)i * 2 * g.A, gram_bytes, &full[st]);
    };
    if (lane == 0) {
      for (int st = warp; st < stages && st < nrows; st += kWarps) fill(st, st);
    }

    // surgery: the row in global memory by rank 0, the tail segment by all
    // (per step launch only for a clipped event, from the registers)
    const bool clipped = event_clipped(position, g);
    if constexpr (kStep) {
      if (clipped && !seg_staged) {
#pragma unroll
        for (int q = 0; q < kSegRegs; ++q) {
          const int j = tid + q * kThreads;
          if (j < g.A) seg[j] = tail_regs[q];
        }
        for (int j = g.A + tid; j < 2 * g.A; j += kThreads) seg[j] = 0.f;
        __syncthreads();
      }
    }
    const float* drow = d2 + (size_t)atom * g.A;
    for (int k = tid; k < g.A; k += kThreads) {
      const float prod = __fmul_rn(value, drow[k]);
      const int j = position + k;
      if (rank == 0) res_b[j] = j < g.n_samples ? __fsub_rn(res_b[j], prod) : 0.f;
      const int js = j - (g.n_samples - g.A);
      if ((!kStep || clipped) && js >= 0 && js < g.A) seg[js] = __fsub_rn(seg[js], prod);
    }
    if (!kStep || clipped) __syncthreads();   // the segment is read next, or kept
    if (clipped) {
      tail_rows(seg, d2 + (size_t)row0 * g.A, tail_b + (size_t)row0 * g.A, ds, nrows, g.A);
    }

    // window pass: row i of the rank goes through stage i % stages, which
    // warp (i % stages) % kWarps owns. A lane takes 4 neighbouring floats of
    // each 128-float chunk; the gram values that meet them start kS4 floats
    // into an aligned group of 4, so they come from two 16-byte loads.
    const int chunks_per_block = g.block / 128, chunk_shift = __ffs(chunks_per_block) - 1;
    const int n_chunks = g.upd_blocks * chunks_per_block;
    auto window_pass = [&](auto s4_constant) {
      constexpr int kS4 = decltype(s4_constant)::value;
      for (int i0 = 0; i0 < nrows; i0 += stages) {
        // the maximum so far of the warp's next row and its first block,
        // loaded a row ahead
        float next_max = -CUDART_INF_F;
        int next_arg = 0;
        if (warp < stages && i0 + warp < nrows) {
          next_max = rmax[i0 + warp];
          next_arg = rarg[i0 + warp];
        }
        int k = 0;
        for (int st = warp; st < stages; st += kWarps, ++k) {
          const int i = i0 + st;
          if (i >= nrows) break;
          const float omax = next_max;
          const int oarg = next_arg;
          if (st + kWarps < stages && i + kWarps < nrows) {
            next_max = rmax[i + kWarps];
            next_arg = rarg[i + kWarps];
          }
          // a row whose maximum lies outside the window keeps it as the
          // first maximum of its entries outside the window; only a row
          // whose maximum lies inside needs its other entries: loaded now,
          // looked at after the window
          const bool rescan = oarg >= ws_blk && oarg < ws_blk + g.upd_blocks;
          const float* trow = tbl + i * tstride;
          float old[kRegs];
          if (rescan) {
#pragma unroll
            for (int q = 0; q < kRegs; ++q) {
              const int c = lane + 32 * q;
              old[q] = c < g.n_blocks ? trow[c] : -CUDART_INF_F;
            }
          }
          mbar_wait(&full[st], (phases >> k) & 1u);
          phases ^= 1u << k;
          const float* win = ring + (size_t)st * stage_floats;
          const float* gr = win + upd_w;
          float* out = fwin + (size_t)i * g.W;   // the row's window in the map
          const float* tr = tail_b + (size_t)(row0 + i) * g.A;
          float bmax = -CUDART_INF_F;   // maximum of the block being walked
          int blane = 0;                // kLanes: its first lane in the block
          float nv = -CUDART_INF_F;     // first maximum of the window's blocks
          int nc = INT_MAX;
          int nl = 0;                   // kLanes: its lane
          // kLanes: the chunk position of the first of a lane's four values
          // that equals their maximum lm (float equality: -0.0 equals +0.0,
          // as torch.argmax sees them)
          auto first_at = [&](const float4& w, float lm) {
            return 4 * lane + (w.x == lm ? 0 : w.y == lm ? 1 : w.z == lm ? 2 : 3);
          };
          // a chunk's maximum (an ordered int per lane) into its block's;
          // at is the lane's first_at
          auto chunk_done = [&](int c, int m, int at) {
            const float cm = ordered_back(__reduce_max_sync(0xffffffffu, m));
            if constexpr (kLanes) {
              // the chunk's first position holding its maximum: the
              // smallest at among the lanes whose maximum equals it; an
              // earlier chunk of the block keeps a tie
              const int cb = c & (chunks_per_block - 1);
              const int first = __reduce_min_sync(
                  0xffffffffu, ordered_back(m) == cm ? cb * 128 + at : INT_MAX);
              if (cb == 0 || cm > bmax) blane = first;
            }
            bmax = fmaxf(bmax, cm);
            if (((c + 1) & (chunks_per_block - 1)) == 0) {
              const int blk = ws_blk + (c >> chunk_shift);
              if (lane == 0) {
                tbl[i * tstride + blk] = bmax;
                if constexpr (kLanes) ltbl[i * tstride + blk] = blane;
              }
              if (bmax > nv) {   // blocks ascend: the first maximum stays
                nv = bmax;
                nc = blk;
                nl = blane;
              }
              bmax = -CUDART_INF_F;
            }
          };
          int c = 0;
          while (c < n_chunks) {
            // chunks c .. c + run - 1 lie wholly inside the gram row's span
            // and outside a spliced tail: no lane needs a range test
            int run = 0;
            while (run < kUnroll && c + run < n_chunks) {
              const int j0 = (c + run) * 128, x0 = ws_blk * g.block + j0;
              if (j0 < off || j0 + 128 - off > 2 * g.A) break;
              if (clipped && x0 >= g.tail_start && x0 < g.tail_start + g.A) break;
              ++run;
            }
            if (run > 0) {
              // all the loads first, so that they overlap
              float4 w[kUnroll], lo[kUnroll], hi[kUnroll];
#pragma unroll
              for (int u = 0; u < kUnroll; ++u) {
                if (u >= run) continue;
                const int j = (c + u) * 128 + 4 * lane, ga = j - off - kS4;
                w[u] = *reinterpret_cast<const float4*>(win + j);
                lo[u] = *reinterpret_cast<const float4*>(gr + ga);
                // may read up to 16 bytes past the gram row: shared memory
                // of this block (the plan pads for it), values not used
                if (kS4 != 0) hi[u] = *reinterpret_cast<const float4*>(gr + ga + 4);
              }
              int m[kUnroll], at[kUnroll];
#pragma unroll
              for (int u = 0; u < kUnroll; ++u) {
                if (u >= run) continue;
                const int j = (c + u) * 128 + 4 * lane;
                const float4 l4 = lo[u], h4 = hi[u];
                const float g0 = kS4 == 0 ? l4.x : kS4 == 1 ? l4.y : kS4 == 2 ? l4.z : l4.w;
                const float g1 = kS4 == 0 ? l4.y : kS4 == 1 ? l4.z : kS4 == 2 ? l4.w : h4.x;
                const float g2 = kS4 == 0 ? l4.z : kS4 == 1 ? l4.w : kS4 == 2 ? h4.x : h4.y;
                const float g3 = kS4 == 0 ? l4.w : kS4 == 1 ? h4.x : kS4 == 2 ? h4.y : h4.z;
                w[u].x = __fsub_rn(w[u].x, __fmul_rn(value, g0));
                w[u].y = __fsub_rn(w[u].y, __fmul_rn(value, g1));
                w[u].z = __fsub_rn(w[u].z, __fmul_rn(value, g2));
                w[u].w = __fsub_rn(w[u].w, __fmul_rn(value, g3));
                *reinterpret_cast<float4*>(out + j) = w[u];
                const float lm = fmaxf(fmaxf(w[u].x, w[u].y), fmaxf(w[u].z, w[u].w));
                m[u] = ordered(lm);
                if constexpr (kLanes) at[u] = first_at(w[u], lm);
              }
#pragma unroll
              for (int u = 0; u < kUnroll; ++u) {
                if (u < run) chunk_done(c + u, m[u], kLanes ? at[u] : 0);
              }
              c += run;
              continue;
            }
            // a chunk at an end of the span, or in the tail, whose exact
            // values win (the tail is whole chunks)
            const int j = c * 128 + 4 * lane, x = ws_blk * g.block + j;
            float4 w;
            if (clipped && x >= g.tail_start && x < g.tail_start + g.A) {
              w = *reinterpret_cast<const float4*>(tr + x - g.tail_start);
            } else {
              w = *reinterpret_cast<const float4*>(win + j);
              const int gi = j - off;
              const unsigned span = 2 * g.A;   // one unsigned compare: 0 <= gi + e < 2A
              if ((unsigned)gi < span) w.x = __fsub_rn(w.x, __fmul_rn(value, gr[gi]));
              if ((unsigned)(gi + 1) < span) w.y = __fsub_rn(w.y, __fmul_rn(value, gr[gi + 1]));
              if ((unsigned)(gi + 2) < span) w.z = __fsub_rn(w.z, __fmul_rn(value, gr[gi + 2]));
              if ((unsigned)(gi + 3) < span) w.w = __fsub_rn(w.w, __fmul_rn(value, gr[gi + 3]));
            }
            *reinterpret_cast<float4*>(out + j) = w;
            const float lm = fmaxf(fmaxf(w.x, w.y), fmaxf(w.z, w.w));
            chunk_done(c, ordered(lm), kLanes ? first_at(w, lm) : 0);
            ++c;
          }
          // every lane has read the stage: refill it
          __syncwarp();
          if (lane == 0 && i + stages < nrows) fill(i + stages, st);
          // the row's maximum: its old entries outside the window, the new
          // ones inside
          float ov = omax;
          int oc = oarg;
          if (rescan) {
            ov = -CUDART_INF_F;
            oc = INT_MAX;
#pragma unroll
            for (int q = 0; q < kRegs; ++q) {
              const int c = lane + 32 * q;
              if ((c < ws_blk || c >= ws_blk + g.upd_blocks) && old[q] > ov) {
                ov = old[q];
                oc = c;
              }
            }
            for (int c = lane + 32 * kRegs; c < g.n_blocks; c += 32) {
              const float x = trow[c];
              if ((c < ws_blk || c >= ws_blk + g.upd_blocks) && x > ov) {
                ov = x;
                oc = c;
              }
            }
            warp_first_max(ov, oc);
          }
          // kLanes: the window's lane where its block wins, else the old
          // maximum's, kept or (after a rescan) read from the lane table
          const bool window_wins = nv > ov || (nv == ov && nc < oc);
          keep_first_max(ov, oc, nv, nc);
          if (lane == 0) {
            rmax[i] = ov;
            rarg[i] = oc;
            if constexpr (kLanes) {
              rlane[i] = window_wins ? nl : rescan ? ltbl[i * tstride + oc] : rlane[i];
            }
          }
          __syncwarp();
        }
      }
    };
    switch ((4 - (off & 3)) & 3) {
      case 0: window_pass(std::integral_constant<int, 0>{}); break;
      case 1: window_pass(std::integral_constant<int, 1>{}); break;
      case 2: window_pass(std::integral_constant<int, 2>{}); break;
      default: window_pass(std::integral_constant<int, 3>{}); break;
    }
    // tail blocks outside the window (an interior event without the gate):
    // written by the threads, and the rows' maxima taken again
    const int tail_blk = g.tail_start / g.block, ntb = g.A / g.block;
    if (clipped && (tail_blk < ws_blk || tail_blk + ntb > ws_blk + g.upd_blocks)) {
      for (int w = warp; w < nrows * ntb; w += kWarps) {
        const int i = w / ntb, t = w - i * ntb, b_ = tail_blk + t;
        if (b_ >= ws_blk && b_ < ws_blk + g.upd_blocks) continue;
        float* f = fm_b + (size_t)(row0 + i) * g.W + (size_t)b_ * g.block;
        const float* tr = tail_b + (size_t)(row0 + i) * g.A + (size_t)t * g.block;
        float m = -CUDART_INF_F;
        int ml = INT_MAX;   // kLanes: the lane's first lane of m
        for (int l = lane; l < g.block; l += 32) {
          const float val = tr[l];
          f[l] = val;
          if constexpr (kLanes) {
            if (val > m) {
              m = val;
              ml = l;
            }
          } else {
            m = fmaxf(m, val);
          }
        }
        if constexpr (kLanes) {
          warp_first_max(m, ml);
          if (lane == 0) {
            tbl[i * tstride + b_] = m;
            ltbl[i * tstride + b_] = ml;
          }
        } else {
          m = ordered_back(__reduce_max_sync(0xffffffffu, ordered(m)));
          if (lane == 0) tbl[i * tstride + b_] = m;
        }
      }
      __syncthreads();
      summarise_rows();
    }
    // the next step's bulk loads read the map this one's threads wrote
    fence_async();
    __syncthreads();
    if (rank == 0 && tid == 0) {
      atoms[step * B + b] = atom;
      positions[step * B + b] = position;
      values[step * B + b] = value;
    }
  }
  if constexpr (!kStep) {
    if (table_on_chip) {
      for (int r = warp; r < nrows; r += kWarps) {
        for (int c = lane; c < g.n_blocks; c += 32) {
          bm_b[(size_t)(row0 + r) * g.nbt + c] = tbl[r * tstride + c];
          if constexpr (kLanes) {
            lanes[((size_t)b * g.N + row0 + r) * g.nbt + c] = ltbl[r * tstride + c];
          }
        }
      }
    }
    // no rank exits while another may still be behind the last step's barrier
    cluster.sync();
  }
}

struct Plan {
  int stages;
  int table_on_chip;
  int smem;
};

// The shared-memory plan of a block at cluster size C: the tail staging and
// segment, the rows' maxima, a ring as deep as the budget allows, and, for
// the whole encode, the rank's table share where it leaves the ring
// kMinStagesWithTable stages. A per-step kernel's ring is no deeper than the
// rank has rows. Returns false where nothing fits or the shapes break the
// kernels' rules (128-float chunks, 16-byte bulk copies).
//
// With lanes (the lane-table encode) each row keeps a third word, its
// maximum's lane, and the rank's table share costs twice the bytes, floats
// and ints: both tables go on chip together or stay in global memory (L2)
// together. At the bench shapes (512 atoms x 512 taps, 136 blocks a row)
// the card holds 30 clusters of 4, so 32 items take clusters of 2
// (encode_cluster_size), where a rank's 256 table rows (139 KB of floats)
// already stay in global memory without lanes, and so both tables do with
// them (278 KB). Clusters of 8 put both tables of a rank's 64 rows (70 KB)
// on chip beside 16 stages.
//
// With lanes the ring also holds a multiple of kWarps stages where it holds
// more than kWarps, so that every warp owns as many stages, and rows, as
// any other: 16 at clusters of 2, where 23 would fit. Row i goes through
// stage i % stages, which warp (i % stages) % kWarps owns, so a ring of 23
// gives seven warps two stages and twice the rows of the others, and the
// slowest warp sets the step's time. The lane work lengthens a row enough
// that the lane-table encode runs faster with 16 stages than with 23, while
// the whole encode without lanes runs faster with its 24 than with 16, so
// its plan keeps them (tools/encode_stamps.py --stages 0 16 23 times both).
static bool make_plan(const Geometry& g, int C, bool step, Plan& plan, bool lanes = false) {
  if (C < 1 || C > (step ? kMaxStepCluster : 8) || (C & (C - 1)) || g.N % C) return false;
  if (g.block % 128 || (g.block & (g.block - 1)) || g.A % 128 || g.W % 4) return false;
  if (step && lanes) return false;
  const int nrows = g.N / C;
  // 16 bytes of padding: the window pass may read that far past the last
  // stage's gram row (into the rows' maxima, which follow the ring)
  const int row_words = lanes ? 3 : 2;
  const int fixed = (kTailAtoms * g.A + 2 * g.A + row_words * nrows + 4) * (int)sizeof(float);
  const int stage = (g.upd_blocks * g.block + 2 * g.A) * (int)sizeof(float);
  if (step) {
    long long stages = (kStepSmemBudget - fixed) / stage;
    if (stages < 1) return false;
    if (stages > kStepStages) stages = kStepStages;
    if (stages > nrows) stages = nrows;
    plan.stages = (int)stages;
    plan.table_on_chip = 0;
    plan.smem = fixed + plan.stages * stage;
    return true;
  }
  const long long table = (long long)nrows * g.n_blocks * (long long)sizeof(float) * (lanes ? 2 : 1);
  const long long with_table = (kSmemBudget - fixed - table) / stage;
  plan.table_on_chip = with_table >= kMinStagesWithTable;
  const long long stages = plan.table_on_chip ? with_table : (kSmemBudget - fixed) / stage;
  if (stages < 1) return false;
  plan.stages = (int)(stages < kMaxStages ? stages : kMaxStages);
  if (lanes && plan.stages > kWarps) plan.stages -= plan.stages % kWarps;
  plan.smem = fixed + plan.stages * stage + (plan.table_on_chip ? (int)table : 0);
  return true;
}

// What a launcher has told CUDA about its kernel so far on one device, and
// on every device (a kernel's attributes are set per device).
struct Setup {
  int smem = 0;               // dynamic shared-memory limit
  bool wide_clusters = false; // clusters of more than 8 blocks allowed
};
constexpr int kMaxDevices = 64;
using Setups = Setup[kMaxDevices];

// On the current device: raise the kernel's dynamic shared-memory limit to
// smem bytes where it is below that, and allow clusters of C blocks; setups
// is the caller's record of what it last set, so that a chain of launches at
// one shape asks CUDA once.
template <typename Kernel>
static cudaError_t ensure_setup(Kernel kernel, int smem, int C, Setups& setups) {
  int device = 0;
  const cudaError_t found = cudaGetDevice(&device);
  if (found != cudaSuccess) return found;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  Setup& setup = setups[device];
  if (smem > setup.smem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    setup.smem = smem;
  }
  if (C > 8 && !setup.wide_clusters) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    setup.wide_clusters = true;
  }
  return cudaSuccess;
}

// The launch configuration of one of the three kernels: grid (C, items),
// with the x dimension a cluster where clustered. attr needs room for two.
static void launch_config(cudaLaunchConfig_t& config, cudaLaunchAttribute* attr, int items, int C,
                          bool clustered, int smem, void* stream) {
  config = cudaLaunchConfig_t{};
  config.gridDim = dim3(C, items, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  config.attrs = attr;
  config.numAttrs = 0;
  if (clustered) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.numAttrs = 1;
  }
}

// A per-step kernel: encode_body<true, ...>'s arguments.
using StepKernel = void (*)(float*, float*, float*, const float*, const float*, float*, int*, int*,
                            float*, Geometry, int, float*, int);

// Enqueue n_steps launches of a per-step kernel on the stream, step s
// writing its events into row s of (n_steps, B) outputs; rows is the chain's
// scratch of 2 x B x N words, which the first launch fills. With
// programmatic, every launch after the first carries
// cudaLaunchAttributeProgrammaticStreamSerialization: it may start while the
// step before it still runs, and waits inside the kernel
// (griddepcontrol.wait) before its first read of fm, bm or the residual.
// setup: see ensure_setup.
static cudaError_t launch_step_chain(StepKernel kernel, Setups& setup, bool clustered, void* fm,
                                     void* bm, void* residual, void* d2, void* gram_p, void* tail,
                                     void* rows, void* atoms, void* positions, void* values, int B,
                                     const Geometry& g, int C, int n_steps, int programmatic,
                                     void* stream) {
  Plan plan;
  if (n_steps < 1 || !make_plan(g, C, true, plan)) return cudaErrorInvalidValue;
  cudaError_t err = ensure_setup(kernel, plan.smem, C, setup);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[2];
  launch_config(config, attr, B, C, clustered, plan.smem, stream);
  const int base_attrs = config.numAttrs;
  attr[base_attrs].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[base_attrs].val.programmaticStreamSerializationAllowed = 1;
  for (int s = 0; s < n_steps; ++s) {
    config.numAttrs = base_attrs + (programmatic && s > 0 ? 1 : 0);
    err = cudaLaunchKernelEx(&config, kernel, (float*)fm, (float*)bm, (float*)residual,
                             (const float*)d2, (const float*)gram_p, (float*)tail,
                             (int*)atoms + (size_t)s * B, (int*)positions + (size_t)s * B,
                             (float*)values + (size_t)s * B, g, plan.stages, (float*)rows,
                             (int)(s > 0));
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// Launch a whole-encode kernel (encode_body<false, true, ...>) once on the
// stream: grid (C, items), one cluster of C blocks per item, with
// make_plan's plan (lanes: the lane-table encode's). pointers are the
// kernel's arguments before the Geometry, cast to its types. setup: see
// ensure_setup.
template <typename Kernel, typename... Pointers>
static cudaError_t launch_encode(Kernel kernel, Setups& setup, bool lanes, int items, int C,
                                 const Geometry& g, int n_steps, void* stream,
                                 Pointers... pointers) {
  Plan plan;
  if (!make_plan(g, C, false, plan, lanes)) return cudaErrorInvalidValue;
  cudaError_t err = ensure_setup(kernel, plan.smem, C, setup);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[2];
  launch_config(config, attr, items, C, true, plan.smem, stream);
  err = cudaLaunchKernelEx(&config, kernel, pointers..., g, n_steps, plan.stages,
                           plan.table_on_chip);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How a kernel runs at these shapes with C blocks per item (step: a per-step
// kernel; lanes: the lane-table encode), without a launch: make_plan's plan,
// and in clusters how many clusters of that size the card holds at once
// (cudaOccupancyMaxActiveClusters; more items than that run in waves); a
// zero plan and 0 clusters where the shapes admit no plan.
template <typename Kernel>
static cudaError_t query_plan(Kernel kernel, Setups& setup, bool step, bool lanes, int N, int A,
                              int block, int n_blocks, int upd_blocks, int C, Plan& plan,
                              int& clusters) {
  const Geometry g = make_geometry(N, A, n_blocks * block, 0, block, 0, n_blocks, n_blocks,
                                   upd_blocks, 0, 1);
  plan = Plan{};
  clusters = 0;
  if (!make_plan(g, C, step, plan, lanes)) return cudaSuccess;
  const cudaError_t err = ensure_setup(kernel, plan.smem, C, setup);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[2];
  launch_config(config, attr, 1, C, true, plan.smem, nullptr);
  return cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
}

// The cluster step kernel's plan: out = {clusters resident at once, ring
// stages, dynamic shared-memory bytes}, all 0 where the shapes admit none.
static int step_plan(StepKernel kernel, Setups& setup, int N, int A, int block, int n_blocks,
                     int upd_blocks, int C, int* out) {
  Plan plan;
  int clusters;
  const cudaError_t err =
      query_plan(kernel, setup, true, false, N, A, block, n_blocks, upd_blocks, C, plan, clusters);
  out[0] = clusters;
  out[1] = plan.stages;
  out[2] = plan.smem;
  return (int)err;
}

// A whole-encode kernel's plan: out = {clusters resident at once, ring
// stages, whether the table share is on chip, dynamic shared-memory bytes},
// all 0 where the shapes admit none.
template <typename Kernel>
static int encode_plan(Kernel kernel, Setups& setup, bool lanes, int N, int A, int block,
                       int n_blocks, int upd_blocks, int C, int* out) {
  Plan plan;
  int clusters;
  const cudaError_t err = query_plan(kernel, setup, false, lanes, N, A, block, n_blocks,
                                     upd_blocks, C, plan, clusters);
  out[0] = clusters;
  out[1] = plan.stages;
  out[2] = plan.table_on_chip;
  out[3] = plan.smem;
  return (int)err;
}

}  // namespace enc
