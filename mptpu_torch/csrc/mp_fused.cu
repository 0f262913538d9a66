// Fused greedy fast-MP kernels for Hopper (sm_90a), f32 on CUDA cores.
//
// mp_fused_step replaces mptpu/sparse/pallas_fused_mp.py pallas_fused_step
// (:289, kernel body _step_kernel :69-272): one launch per greedy step,
// one 1,024-thread block per batch item (mp_step.cuh: step_item).
//
// mp_fused_encode replaces pallas_fused_encode (:1219, kernel body
// _whole_loop_kernel :834-1198): one launch for the whole encode.
//
// What bounds the encode on this card: bytes. Each item-step reads one gram
// row (N x 2A floats, 2 MiB at 512 atoms x 512 taps) and reads and writes
// its update window (N x upd_blocks*block floats, 2.25 MiB each way): about
// 6.8 MB, so 3,200 item-steps move about 21.8 GB, 6.5 ms at 3.35 TB/s. A
// clipped event adds the N x A x A tail product (268 MFLOP). One block per
// item, its threads loading the window with dependent scalar loads and
// scanning the whole block-max table at every step, kept 32 of 132 SMs at
// about 32 GB/s each. What the design does about it:
//
//   cluster  one thread-block cluster per item, the step loop inside the
//            kernel; rank r owns atom rows [r * N / C, (r + 1) * N / C) of
//            the map, the block-max table, the gram row and the tail, so C
//            SMs stream one item's step. Items stay independent: there is
//            no grid-wide barrier. C is chosen so that all items' clusters
//            are resident at once (mp_fused_encode_plan): the kernel loops
//            over every step, so a second wave would double its time.
//   select   every rank keeps, in shared memory, the maximum of each of its
//            table rows and the first block that holds it; a step scans
//            those N / C pairs instead of the table, refines the winner
//            inside its own map block, and the C candidates (table value,
//            flat index, refined value, position) meet through distributed
//            shared memory behind ONE cluster barrier per step (the
//            candidate buffer is double-buffered, and no rank reads another
//            rank's map rows). Every rank keeps the first flat index among
//            equal maxima. The warp that rewrites a row's window blocks
//            also takes the row's maximum again: the row's other table
//            entries are loaded before the window and looked at after it.
//   tables   a rank's share of the block-max table (real columns only)
//            stays in shared memory for the whole encode where it fits
//            beside a ring of kMinStagesWithTable stages, read in at the
//            start and written back at the end; else it stays in global
//            memory (L2), where only the rows' window blocks are touched.
//   window   no thread loads the window. Per atom row two bulk
//            asynchronous copies (cp.async.bulk: the block-aligned window
//            of fm and the gram row, both contiguous and 16-byte aligned)
//            land in a ring of shared-memory stages and complete on an
//            mbarrier; a warp owns every kWarps-th stage, subtracts,
//            splices the exact tail and takes the block maxima from shared
//            memory, 16 bytes a lane (the misaligned gram offset is a
//            shared-memory offset: two aligned loads and a compile-time
//            shift; a chunk wholly inside the gram's span needs no range
//            test; a warp's maximum is one redux on order-preserving ints),
//            writes the new window to the map from its registers, 16 bytes
//            a lane (a bulk store from the stage was no faster and held the
//            stage until it had been read), and refills the stage. The ring
//            is as deep as shared memory allows (up to kMaxStages), so some
//            200 KB of loads are in flight per SM without a register spent.
//   residual the row stays in global memory (rank 0 updates it); every rank
//            keeps the last 2A samples, all the tail product reads, in
//            shared memory and repeats the surgery there.
//
// Numerics are mp_step.cuh's: the window subtract is
// __fsub_rn(a, __fmul_rn(v, g)) and each tail sum a k-ascending f32 FMA
// chain, so events, map, table and residual equal the one-block kernels'
// (mp_fused_step looped, mp_fused_encode_lane) bit for bit at any cluster
// size.
#include <cooperative_groups.h>
#include <cstdint>
#include <type_traits>

#include "mp_step.cuh"

namespace cg = cooperative_groups;
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

// ---- the whole encode over thread-block clusters

namespace enc {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTailAtoms = 8;    // atoms per shared-memory chunk of the tail product
constexpr int kMaxStages = 24;
constexpr int kUnroll = 4;       // 128-float chunks of a window in flight per warp
constexpr int kRowRegs = 5;      // table entries of a row a lane keeps in registers
// the table goes on chip only where that leaves the ring this many stages
constexpr int kMinStagesWithTable = 16;
// dynamic shared memory of a block: the card's 227 KB less the static part
constexpr int kSmemBudget = 232448 - 512;

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
    mp::keep_first_max(v, i, __shfl_down_sync(full, v, o), __shfl_down_sync(full, i, o));
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
      mp::keep_first_max(v, i, __shfl_down_sync(full, v, o), __shfl_down_sync(full, i, o));
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

// tail[a, p] = sum_k d2[a, k] * seg[p + k] for a < nrows, p < A: the sums of
// mp::tail_product (one k-ascending FMA chain each), kTailAtoms rows of d2
// staged in ds at a time. Ends with __syncthreads().
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

__global__ void __launch_bounds__(kThreads, 1)
fused_encode_kernel(float* fm, float* bm, float* residual, const float* __restrict__ d2,
                    const float* __restrict__ gram_p, float* tail, int* atoms, int* positions,
                    float* values, Geometry g, int n_steps, int stages, int table_on_chip) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ Scratch s;
  __shared__ Candidate cand[2];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.y, B = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nrows = g.N / C, row0 = rank * nrows;
  const int upd_w = g.upd_blocks * g.block, stage_floats = upd_w + 2 * g.A;
  const uint32_t win_bytes = upd_w * sizeof(float), gram_bytes = 2 * g.A * sizeof(float);

  float* ds = reinterpret_cast<float*>(smem_raw);
  float* seg = ds + kTailAtoms * g.A;   // residual samples [n_samples - A, n_samples + A)
  float* ring = seg + 2 * g.A;
  // per table row of the rank: its maximum and the first block that holds it
  float* rmax = ring + (size_t)stages * stage_floats;
  int* rarg = reinterpret_cast<int*>(rmax + nrows);
  float* fm_b = fm + (size_t)b * g.N * g.W;
  float* bm_b = bm + (size_t)b * g.N * g.nbt;
  float* res_b = residual + (size_t)b * g.L;
  float* tail_b = tail + (size_t)b * g.N * g.A;

  // the rank's table rows, tbl[r * tstride + blk] for its r-th row
  float* tbl = bm_b + (size_t)row0 * g.nbt;
  int tstride = g.nbt;
  if (table_on_chip) {
    tbl = rmax + 2 * nrows;
    tstride = g.n_blocks;
    for (int r = warp; r < nrows; r += kWarps) {
      for (int c = lane; c < g.n_blocks; c += 32) {
        tbl[r * tstride + c] = bm_b[(size_t)(row0 + r) * g.nbt + c];
      }
    }
    __syncthreads();
  }
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
      }
    }
  };
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

  uint32_t phases = 0;   // bit k: parity of the next fill of this warp's k-th stage
  for (int step = 0; step < n_steps; ++step) {
    // select: first maximum of the rank's rows, refined in its map block
    float v = -CUDART_INF_F;
    int idx = INT_MAX;
    for (int r = tid; r < nrows; r += kThreads) {
      mp::keep_first_max(v, idx, rmax[r], (row0 + r) * g.n_blocks + rarg[r]);
    }
    block_first_max(v, idx, s);
    if (warp == 0) {
      const int row = idx / g.n_blocks, blk = idx - row * g.n_blocks;
      // straight from L2, where the window pass's stores to the map land
      const float* p = fm_b + (size_t)row * g.W + (size_t)blk * g.block;
      float fv = -CUDART_INF_F;
      int fl = INT_MAX;
      for (int l = lane; l < g.block; l += 32) {
        const float x = __ldcg(p + l);
        if (x > fv) {
          fv = x;
          fl = l;
        }
      }
      warp_first_max(fv, fl);
      if (lane == 0) {
        if (fl == INT_MAX) fl = 0;
        cand[step & 1] = Candidate{v, idx, fv, blk * g.block + fl - g.pad};
      }
    }
    cluster.sync();
    v = -CUDART_INF_F;
    idx = INT_MAX;
    float value = 0.f;
    int position = 0;
    for (int r = 0; r < C; ++r) {
      const Candidate c = *cluster.map_shared_rank(&cand[step & 1], r);
      if (c.v > v || (c.v == v && c.idx < idx)) {
        v = c.v;
        idx = c.idx;
        value = c.value;
        position = c.position;
      }
    }
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
    const float* drow = d2 + (size_t)atom * g.A;
    for (int k = tid; k < g.A; k += kThreads) {
      const float prod = __fmul_rn(value, drow[k]);
      const int j = position + k;
      if (rank == 0) res_b[j] = j < g.n_samples ? __fsub_rn(res_b[j], prod) : 0.f;
      const int js = j - (g.n_samples - g.A);
      if (js >= 0 && js < g.A) seg[js] = __fsub_rn(seg[js], prod);
    }
    __syncthreads();
    const bool clipped = mp::event_clipped(position, g);
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
        int k = 0;
        for (int st = warp; st < stages; st += kWarps, ++k) {
          const int i = i0 + st;
          if (i >= nrows) break;
          // the row's table entries outside the window, for its new maximum;
          // loaded now, looked at after the window
          const float* trow = tbl + i * tstride;
          float old[kRowRegs];
#pragma unroll
          for (int q = 0; q < kRowRegs; ++q) {
            const int c = lane + 32 * q;
            old[q] = c < g.n_blocks ? trow[c] : -CUDART_INF_F;
          }
          mbar_wait(&full[st], (phases >> k) & 1u);
          phases ^= 1u << k;
          const float* win = ring + (size_t)st * stage_floats;
          const float* gr = win + upd_w;
          float* out = fwin + (size_t)i * g.W;   // the row's window in the map
          const float* tr = tail_b + (size_t)(row0 + i) * g.A;
          float bmax = -CUDART_INF_F;   // maximum of the block being walked
          float nv = -CUDART_INF_F;     // first maximum of the window's blocks
          int nc = INT_MAX;
          // a chunk's maximum (an ordered int per lane) into its block's
          auto chunk_done = [&](int c, int m) {
            bmax = fmaxf(bmax, ordered_back(__reduce_max_sync(0xffffffffu, m)));
            if (((c + 1) & (chunks_per_block - 1)) == 0) {
              const int blk = ws_blk + (c >> chunk_shift);
              if (lane == 0) tbl[i * tstride + blk] = bmax;
              if (bmax > nv) {   // blocks ascend: the first maximum stays
                nv = bmax;
                nc = blk;
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
              int m[kUnroll];
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
                m[u] = ordered(fmaxf(fmaxf(w[u].x, w[u].y), fmaxf(w[u].z, w[u].w)));
              }
#pragma unroll
              for (int u = 0; u < kUnroll; ++u) {
                if (u < run) chunk_done(c + u, m[u]);
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
            chunk_done(c, ordered(fmaxf(fmaxf(w.x, w.y), fmaxf(w.z, w.w))));
            ++c;
          }
          // every lane has read the stage: refill it
          __syncwarp();
          if (lane == 0 && i + stages < nrows) fill(i + stages, st);
          // the row's maximum: its old entries outside the window, the new
          // ones inside
          float ov = -CUDART_INF_F;
          int oc = INT_MAX;
#pragma unroll
          for (int q = 0; q < kRowRegs; ++q) {
            const int c = lane + 32 * q;
            if ((c < ws_blk || c >= ws_blk + g.upd_blocks) && old[q] > ov) {
              ov = old[q];
              oc = c;
            }
          }
          for (int c = lane + 32 * kRowRegs; c < g.n_blocks; c += 32) {
            const float x = trow[c];
            if ((c < ws_blk || c >= ws_blk + g.upd_blocks) && x > ov) {
              ov = x;
              oc = c;
            }
          }
          warp_first_max(ov, oc);
          mp::keep_first_max(ov, oc, nv, nc);
          if (lane == 0) {
            rmax[i] = ov;
            rarg[i] = oc;
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
        for (int l = lane; l < g.block; l += 32) {
          const float val = tr[l];
          f[l] = val;
          m = fmaxf(m, val);
        }
        m = ordered_back(__reduce_max_sync(0xffffffffu, ordered(m)));
        if (lane == 0) tbl[i * tstride + b_] = m;
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
  if (table_on_chip) {
    for (int r = warp; r < nrows; r += kWarps) {
      for (int c = lane; c < g.n_blocks; c += 32) {
        bm_b[(size_t)(row0 + r) * g.nbt + c] = tbl[r * tstride + c];
      }
    }
  }
  // no rank exits while another may still read its candidates
  cluster.sync();
}

struct Plan {
  int stages;
  int table_on_chip;
  int smem;
};

// The shared-memory plan of a block at cluster size C: the tail staging and
// segment, the rows' maxima, a ring as deep as the budget allows, and the
// rank's table share where it leaves the ring kMinStagesWithTable stages.
// Returns false where nothing fits or the shapes break the kernel's rules
// (128-float chunks, 16-byte bulk copies).
static bool make_plan(const Geometry& g, int C, Plan& plan) {
  if (C < 1 || C > 8 || g.N % C) return false;
  if (g.block % 128 || (g.block & (g.block - 1)) || g.A % 128 || g.W % 4) return false;
  // 16 bytes of padding: the window pass may read that far past the last
  // stage's gram row
  const int fixed = (kTailAtoms * g.A + 2 * g.A + 2 * (g.N / C) + 4) * (int)sizeof(float);
  const int stage = (g.upd_blocks * g.block + 2 * g.A) * (int)sizeof(float);
  const long long table = (long long)(g.N / C) * g.n_blocks * (long long)sizeof(float);
  const long long with_table = (kSmemBudget - fixed - table) / stage;
  plan.table_on_chip = with_table >= kMinStagesWithTable;
  const long long stages = plan.table_on_chip ? with_table : (kSmemBudget - fixed) / stage;
  if (stages < 1) return false;
  plan.stages = (int)(stages < kMaxStages ? stages : kMaxStages);
  plan.smem = fixed + plan.stages * stage + (plan.table_on_chip ? (int)table : 0);
  return true;
}

static cudaError_t launch_config(cudaLaunchConfig_t& config, cudaLaunchAttribute* attr, int B,
                                 int C, const Plan& plan, void* stream) {
  config = cudaLaunchConfig_t{};
  config.gridDim = dim3(C, B, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = plan.smem;
  config.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaFuncSetAttribute(fused_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              plan.smem);
}

}  // namespace enc

extern "C" int mp_fused_encode(void* fm, void* bm, void* residual, void* d2, void* gram_p,
                               void* tail, void* atoms, void* positions, void* values, int B,
                               int N, int A, int W, int n_samples, int block, int pad,
                               int n_blocks, int nbt, int upd_blocks, int tail_start,
                               int gate_tail, int n_steps, int cluster_size, void* stream) {
  const Geometry g = mp::make_geometry(N, A, W, n_samples, block, pad, n_blocks, nbt, upd_blocks,
                                   tail_start, gate_tail);
  enc::Plan plan;
  if (!enc::make_plan(g, cluster_size, plan)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  cudaError_t err = enc::launch_config(config, attr, B, cluster_size, plan, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&config, enc::fused_encode_kernel, (float*)fm, (float*)bm,
                           (float*)residual, (const float*)d2, (const float*)gram_p,
                           (float*)tail, (int*)atoms, (int*)positions, (float*)values, g, n_steps,
                           plan.stages, plan.table_on_chip);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The plan of mp_fused_encode at these shapes and cluster size, without a
// launch: out = {clusters of that size the card holds at once
// (cudaOccupancyMaxActiveClusters; more items than that run in waves), ring
// stages, whether the table is on chip, dynamic shared-memory bytes}, all 0
// where the shapes admit no plan.
extern "C" int mp_fused_encode_plan(int N, int A, int block, int n_blocks, int upd_blocks,
                                    int cluster_size, int* out) {
  const Geometry g = mp::make_geometry(N, A, n_blocks * block, 0, block, 0, n_blocks, n_blocks,
                                       upd_blocks, 0, 1);
  enc::Plan plan;
  out[0] = out[1] = out[2] = out[3] = 0;
  if (!enc::make_plan(g, cluster_size, plan)) return 0;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  cudaError_t err = enc::launch_config(config, attr, 1, cluster_size, plan, nullptr);
  if (err != cudaSuccess) return (int)err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, enc::fused_encode_kernel, &config);
  if (err != cudaSuccess) return (int)err;
  out[0] = clusters;
  out[1] = plan.stages;
  out[2] = plan.table_on_chip;
  out[3] = plan.smem;
  return 0;
}
