// One greedy fast-MP step for one batch item by one 1,024-thread block,
// selecting from the block-max table and a lane table (step_item_lane):
// the step body of the lane-table encode (mp_lane.cu:
// mp_fused_encode_lane). Geometry, keep_first_max and event_clipped are
// shared with the other fused kernels (mp_window.cuh).
//
// It computes what the Pallas step body computes
// (mptpu/sparse/pallas_fused_mp.py _step_kernel, :69-272), indexing directly
// where the TPU kernel rolls lanes, builds a Hankel matrix by a roll ladder,
// places block maxima by a one-hot matmul and refines from an 8-row slab.
//
// Numerics. The window subtract and the residual surgery are written as
// __fsub_rn(a, __fmul_rn(v, g)): nvcc would otherwise contract a - v*g
// into one FMA, while the plain PyTorch version rounds the product and
// the difference separately. Written this way the interior updates are
// bit-identical to the plain version. Only the tail dot products (taken
// with FMA, in another order than cuBLAS/cuDNN) differ from it, by the
// rounding of a 512-term float32 sum.
//
// Ties. The table argmax keeps the first (smallest) flat index among equal
// maxima, as torch.argmax and jnp.argmax do, and the lane table holds the
// first lane of each block's maximum.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace mp {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// atoms per shared-memory chunk of the boundary-tail product
constexpr int kTailAtoms = 16;

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

struct Event {
  int atom;
  int position;
  float value;
};

struct Scratch {
  float v[kWarps];
  int i[kWarps];
  float rv;
  int ri;
};

__device__ __forceinline__ void keep_first_max(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
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
  i = s.ri == INT_MAX ? 0 : s.ri;
}

// tail[a, p] = sum_k d2[a, k] * seg[p + k] for a < N, p < A, where seg is
// the residual from n_samples - A on (zeros past n_samples included).
// d2 is staged kTailAtoms rows at a time in shared memory (ds); each
// thread keeps 8 atoms x 1 position in registers. Requires A % 4 == 0.
static __device__ void tail_product(const float* seg, const float* __restrict__ d2, float* tail,
                             float* ds, int N, int A) {
  for (int a0 = 0; a0 < N; a0 += kTailAtoms) {
    for (int e = threadIdx.x; e < kTailAtoms * A; e += kThreads) {
      ds[e] = a0 + e / A < N ? d2[(size_t)a0 * A + e] : 0.f;
    }
    __syncthreads();
    for (int item = threadIdx.x; item < (kTailAtoms / 8) * A; item += kThreads) {
      const int p = item % A, grp = item / A;
      const float* r = seg + p;
      const float* w = ds + grp * 8 * A;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < A; k += 4) {
        const float r0 = r[k], r1 = r[k + 1], r2 = r[k + 2], r3 = r[k + 3];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 wv = *reinterpret_cast<const float4*>(w + i * A + k);
          acc[i] = fmaf(wv.x, r0, acc[i]);
          acc[i] = fmaf(wv.y, r1, acc[i]);
          acc[i] = fmaf(wv.z, r2, acc[i]);
          acc[i] = fmaf(wv.w, r3, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int a = a0 + grp * 8 + i;
        if (a < N) tail[(size_t)a * A + p] = acc[i];
      }
    }
    __syncthreads();
  }
}

// First maximum of rows [row0, row0 + nrows) of the block-max table, over
// real blocks in row-major order; idx is the flat index a * n_blocks + blk
// with a the row's index in the whole table. Every thread gets the result.
__device__ __forceinline__ void table_first_max(const float* bm, int row0, int nrows,
                                                const Geometry g, Scratch& s, float& v,
                                                int& idx) {
  v = -CUDART_INF_F;
  idx = INT_MAX;
  const int cells = nrows * g.n_blocks;
  for (int e = threadIdx.x; e < cells; e += kThreads) {
    const int r = e / g.n_blocks, blk = e - r * g.n_blocks;
    const float x = bm[(size_t)(row0 + r) * g.nbt + blk];
    if (x > v) {
      v = x;
      idx = (row0 + r) * g.n_blocks + blk;
    }
  }
  block_first_max(v, idx, s);
}

// res[position : position + A] -= value * drow on a whole residual row
// (length L), then zero everything past the signal end. Ends with
// __syncthreads().
__device__ __forceinline__ void residual_surgery(float* res, const float* __restrict__ drow,
                                                 int position, float value, const Geometry g) {
  for (int k = threadIdx.x; k < g.A; k += kThreads) {
    res[position + k] = __fsub_rn(res[position + k], __fmul_rn(value, drow[k]));
  }
  __syncthreads();
  for (int j = g.n_samples + threadIdx.x; j < g.L; j += kThreads) res[j] = 0.f;
  __syncthreads();
}

// One pass over the window blocks (and, when clipped, the tail blocks) of
// map rows [row0, row0 + nrows): subtract value * gram_p[atom] on
// [ustart, ustart + 2A), let the exact tail win over
// [tail_start, tail_start + A), and take each block's maximum from the
// final values. One warp per (atom row, block). tail is the item's whole
// (N, A) scratch. The first lane of each block's maximum goes into lanes
// (same layout as bm) beside the maximum. No barrier inside.
__device__ __forceinline__ void update_rows(float* fm, float* bm, int* lanes, const float* tail,
                                            const float* __restrict__ gram_p, int atom,
                                            int position, float value, bool clipped, int row0,
                                            int nrows, const Geometry g) {
  const int tid = threadIdx.x;
  const int ustart = position + g.pad - (g.A - 1);
  const int ws_blk = min(ustart / g.block, g.n_blocks - g.upd_blocks);
  const int tail_blk = g.tail_start / g.block;
  const int per_row = g.upd_blocks + (clipped ? g.A / g.block : 0);
  const int lane = tid & 31, warp = tid >> 5;
  const float* grow0 = gram_p + (size_t)atom * g.N * 2 * g.A;
  for (int w = warp; w < nrows * per_row; w += kWarps) {
    const int r = w / per_row, kk = w - r * per_row;
    const int row = row0 + r;
    const int b_ = kk < g.upd_blocks ? ws_blk + kk : tail_blk + (kk - g.upd_blocks);
    if (kk >= g.upd_blocks && b_ >= ws_blk && b_ < ws_blk + g.upd_blocks) continue;
    float* f = fm + (size_t)row * g.W;
    const float* gr = grow0 + (size_t)row * 2 * g.A;
    const float* tr = tail + (size_t)row * g.A;
    float m = -CUDART_INF_F;
    int ml = INT_MAX;
    for (int l = lane; l < g.block; l += 32) {
      const int x = b_ * g.block + l;
      float val;
      if (clipped && x >= g.tail_start && x < g.tail_start + g.A) {
        val = tr[x - g.tail_start];
        f[x] = val;
      } else {
        const int gi = x - ustart;
        if (gi >= 0 && gi < 2 * g.A) {
          val = __fsub_rn(f[x], __fmul_rn(value, gr[gi]));
          f[x] = val;
        } else {
          val = f[x];
        }
      }
      if (val > m) {   // l ascends: the first lane of the maximum stays
        m = val;
        ml = l;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      keep_first_max(m, ml, __shfl_xor_sync(0xffffffffu, m, o),
                     __shfl_xor_sync(0xffffffffu, ml, o));
    }
    if (lane == 0) {
      bm[(size_t)row * g.nbt + b_] = m;
      lanes[(size_t)row * g.nbt + b_] = ml;
    }
  }
}

// Whether the boundary tail must be recomputed for an event at position:
// only when its atom ran past the signal end (for interior events the gram
// subtract is exact), or always without the gate.
__device__ __forceinline__ bool event_clipped(int position, const Geometry g) {
  return !g.gate_tail || position > g.n_samples - g.A;
}

// One greedy step of one item, in place on its map row set fm (N, W), its
// tables bm and lanes (N, nbt) and its residual row res (L, in global or
// shared memory), with the winner's position read from the lane table: the
// table entry is the winner's value and lanes[atom, blk] its lane, so the
// map is not read to select. The window pass keeps both tables current.
// tail (N, A) is global scratch, ds shared scratch of kTailAtoms * A floats.
// Ends with __syncthreads().
static __device__ Event step_item_lane(float* fm, float* bm, int* lanes, float* res,
                                const float* __restrict__ d2, const float* __restrict__ gram_p,
                                float* tail, float* ds, const Geometry g, Scratch& s) {
  float value;
  int idx;
  table_first_max(bm, 0, g.N, g, s, value, idx);
  const int atom = idx / g.n_blocks, blk = idx - atom * g.n_blocks;
  const int position = blk * g.block + lanes[(size_t)atom * g.nbt + blk] - g.pad;
  residual_surgery(res, d2 + (size_t)atom * g.A, position, value, g);
  const bool clipped = event_clipped(position, g);
  if (clipped) tail_product(res + (g.n_samples - g.A), d2, tail, ds, g.N, g.A);
  update_rows(fm, bm, lanes, tail, gram_p, atom, position, value, clipped, 0, g.N, g);
  __syncthreads();
  return Event{atom, position, value};
}

}  // namespace mp
