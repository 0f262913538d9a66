// One greedy fast-MP step for one batch item, run by one thread block.
//
// Shared by the per-step kernel (mp_fused.cu: mp_fused_step) and the
// whole-encode kernel (mp_fused.cu: mp_fused_encode). It computes what
// the Pallas step body computes (mptpu/sparse/pallas_fused_mp.py
// _step_kernel, :69-272), indexing directly where the TPU kernel rolls
// lanes, builds a Hankel matrix by a roll ladder, places block maxima by a
// one-hot matmul and refines from an 8-row slab.
//
// Numerics. The window subtract and the residual surgery are written as
// __fsub_rn(a, __fmul_rn(v, g)): nvcc would otherwise contract a - v*g
// into one FMA, while the plain PyTorch version rounds the product and
// the difference separately. Written this way the interior updates are
// bit-identical to the plain version. Only the tail dot products (taken
// with FMA, in another order than cuBLAS/cuDNN) differ from it, by the
// rounding of a 512-term float32 sum.
//
// Ties. Both the table argmax and the refine keep the first (smallest)
// flat index among equal maxima, as torch.argmax and jnp.argmax do.
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
__device__ void tail_product(const float* seg, const float* __restrict__ d2, float* tail,
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

// One greedy step of one item, in place on its map row set fm (N, W), its
// block-max table bm (N, nbt) and its residual row res (L); res may live
// in global or shared memory. tail (N, A) is global scratch, ds shared
// scratch of kTailAtoms * A floats. Ends with __syncthreads().
__device__ Event step_item(float* fm, float* bm, float* res, const float* __restrict__ d2,
                           const float* __restrict__ gram_p, float* tail, float* ds,
                           const Geometry g, Scratch& s) {
  const int tid = threadIdx.x;

  // 1) first maximum of the block-max table, row-major over real blocks
  float v = -CUDART_INF_F;
  int idx = INT_MAX;
  const int cells = g.N * g.n_blocks;
  for (int e = tid; e < cells; e += kThreads) {
    const int a = e / g.n_blocks;
    const float x = bm[(size_t)a * g.nbt + (e - a * g.n_blocks)];
    if (x > v) {
      v = x;
      idx = e;
    }
  }
  block_first_max(v, idx, s);
  const int atom = idx / g.n_blocks;
  const int blk = idx - atom * g.n_blocks;

  // 2) refine inside the winning block: the winner is the block's first max
  const float* seg = fm + (size_t)atom * g.W + (size_t)blk * g.block;
  v = -CUDART_INF_F;
  idx = INT_MAX;
  for (int l = tid; l < g.block; l += kThreads) {
    const float x = seg[l];
    if (x > v) {
      v = x;
      idx = l;
    }
  }
  block_first_max(v, idx, s);
  const float value = v;
  const int position = blk * g.block + idx - g.pad;

  // 3) residual surgery, then zero everything past the signal end
  const float* drow = d2 + (size_t)atom * g.A;
  for (int k = tid; k < g.A; k += kThreads) {
    res[position + k] = __fsub_rn(res[position + k], __fmul_rn(value, drow[k]));
  }
  __syncthreads();
  for (int j = g.n_samples + tid; j < g.L; j += kThreads) res[j] = 0.f;
  __syncthreads();

  // 4) exact boundary tail, needed only when the event clipped (or always
  // without the gate): for interior events the gram subtract is exact
  const bool clipped = !g.gate_tail || position > g.n_samples - g.A;
  if (clipped) tail_product(res + (g.n_samples - g.A), d2, tail, ds, g.N, g.A);

  // 5) one pass over the window blocks (and, when clipped, the tail
  // blocks): subtract value * gram_p[atom] on [ustart, ustart + 2A), let
  // the exact tail win over [tail_start, tail_start + A), and take each
  // block's maximum from the final values. One warp per (atom row, block).
  const int ustart = position + g.pad - (g.A - 1);
  const int ws_blk = min(ustart / g.block, g.n_blocks - g.upd_blocks);
  const int tail_blk = g.tail_start / g.block;
  const int per_row = g.upd_blocks + (clipped ? g.A / g.block : 0);
  const int lane = tid & 31, warp = tid >> 5;
  const float* grow0 = gram_p + (size_t)atom * g.N * 2 * g.A;
  for (int w = warp; w < g.N * per_row; w += kWarps) {
    const int row = w / per_row, kk = w - row * per_row;
    const int b_ = kk < g.upd_blocks ? ws_blk + kk : tail_blk + (kk - g.upd_blocks);
    if (kk >= g.upd_blocks && b_ >= ws_blk && b_ < ws_blk + g.upd_blocks) continue;
    float* f = fm + (size_t)row * g.W;
    const float* gr = grow0 + (size_t)row * 2 * g.A;
    const float* tr = tail + (size_t)row * g.A;
    float m = -CUDART_INF_F;
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
      m = fmaxf(m, val);
    }
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) bm[(size_t)row * g.nbt + b_] = m;
  }
  __syncthreads();
  return Event{atom, position, value};
}

}  // namespace mp
