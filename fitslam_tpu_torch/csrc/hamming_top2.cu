// K2: gated Hamming top-2 matcher for Hopper (sm_90a).
//
// Replaces the TPU kernel fitslam_tpu/ops/pallas_matching.py::_top2_kernel
// (launched by hamming_top2). For 256-bit descriptors packed to 8 x uint32
// (orb.pack_descriptors bit order) it returns, per query row of A, the best
// column of B, the best distance and the second-best distance (the minimum
// over every column other than the best), and per column of B the best row,
// without ever building the (Na, Nb) distance matrix.
//
// Semantics (held exact against matching.match_ratio / match_windowed /
// match_stereo): a pair that fails validity or the gate counts as the 512
// sentinel, a row keeps the lowest column on a tie, and a column keeps the
// lowest row. A row with no candidate returns column 0 and distance 512, as
// match_ratio does. Both orders come from packed keys, (distance << 22) |
// index, whose minimum is the (distance, index) lexicographic minimum: the
// result does not depend on the order in which pairs are visited.
//
// Gates, evaluated in the kernel from coordinates:
//   mode 0  none    (match_ratio)
//   mode 1  window  |xy_a - xy_b|^2 <= gate[0]                     (match_windowed)
//   mode 2  stereo  |dv| <= gate[0], 0.1 < disp < gate[1], |dlevel| <= 1 (match_stereo)
// The window gate forms dx*dx + dy*dy with __fmul_rn/__fadd_rn: a contracted
// FMA would flip pairs that sit exactly on the window's edge.
//
// What bounds it on the H100: the per-pair epilogue on the integer and
// float pipes, not the distance product. At 1024 x 8192 the inputs are
// 288 KB while there are 8.4 M pairs. Two designs of the distance product
// share one skeleton (DESIGN below), so that they can be timed side by side
// (chip_smoke.py phase 3); kB1 is the faster and the one the port runs:
//
//   kB1    single-bit tensor-core product, mma.m16n8k256 .and.popc on the
//          packed words: Hamming = popc(a) + popc(b) - 2 popc(a & b), with
//          popc(a) and popc(b) from the same instruction against all-ones.
//          One mma gives 128 pairs; operands come straight from L1/L2.
//   kS8    +-1 int8 tensor-core product, mma.m16n8k32 s8 -> s32, 8 steps a
//          pair tile: Hamming = (256 - dot) / 2. Bits are unpacked to +-1
//          bytes in shared memory (rows once a block, columns per 8-column
//          tile a warp) and read with ldmatrix.
//
// Both designs: a block takes 64 rows (4 m16 tiles) and a span of columns;
// its 4 warps split the span, each walking it in 8-column tiles and loading
// the next tile's operands while it computes the current one. A thread
// keeps each of its 8 rows' (best, second) keys and each tile column's
// minimum (distance, row) key in registers: the rows merge across the lanes
// by shuffles and across the warps in shared memory, the columns across the
// lanes by shuffles and then go out as one atomicMin per column and block.
// The column span is split across blocks so that ~4 blocks run per SM;
// a second kernel merges each row's top-2 over the splits with the
// order-free rule (best = min, second = min(seconds, max(bests))).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 8;
constexpr int kKeyShift = 22;                            // index bits of a key
constexpr uint32_t kIndexMask = (1u << kKeyShift) - 1;
constexpr uint32_t kSentinel = 512;
constexpr uint32_t kInitKey = (kSentinel << kKeyShift) | kIndexMask;  // loses to any key

enum { kModeNone = 0, kModeWindow = 1, kModeStereo = 2 };
enum { kB1 = 0, kS8 = 1 };

__device__ __forceinline__ void top2_push(uint32_t key, uint32_t& best, uint32_t& second) {
  second = min(second, max(key, best));
  best = min(best, key);
}

__device__ __forceinline__ void top2_merge(uint32_t ob, uint32_t os, uint32_t& best,
                                           uint32_t& second) {
  second = min(min(second, os), max(best, ob));
  best = min(best, ob);
}

template <int MODE>
__device__ __forceinline__ bool gate_ok(float qx, float qy, int ql, float x, float y, int l,
                                        float g0, float g1) {
  if (MODE == kModeWindow) {
    const float dx = __fsub_rn(qx, x);
    const float dy = __fsub_rn(qy, y);
    return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= g0;
  }
  if (MODE == kModeStereo) {
    const float dv = fabsf(__fsub_rn(qy, y));
    const float disp = __fsub_rn(qx, x);
    return (dv <= g0) && (disp > 0.1f) && (disp < g1) && (abs(ql - l) <= 1);
  }
  return true;
}

// ------------------------------------------------------- tensor-core designs

constexpr int kMTiles = 4;                    // m16 tiles a block: 64 rows
constexpr int kRowsPerBlock = 16 * kMTiles;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowBytes = 256 + 16;           // unpacked +-1 row, padded against bank conflicts

__device__ __forceinline__ void mma_b1(const uint32_t (&a)[4], uint32_t b0, uint32_t b1,
                                       uint32_t (&d)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

__device__ __forceinline__ void mma_s8(const uint32_t (&a)[4], uint32_t b0, uint32_t b1,
                                       uint32_t (&d)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

// one packed word -> 32 bytes of +-1 (byte k = bit k), as 8 words
__device__ __forceinline__ void unpack_word(uint32_t w, uint8_t* dst) {
  uint32_t v[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint32_t m = (((w >> (4 * q)) & 0xfu) * 0x00204081u) & 0x01010101u;
    v[q] = m | ((m ^ 0x01010101u) * 0xffu);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

// What a thread needs of one 8-column tile: two packed words of column
// c0 + g (words t and t + 4 for kB1's B fragment, 2t and 2t + 1 for kS8's
// unpacking) and its two output columns' validity, position and level
struct ColTile {
  uint32_t w[2];
  bool valid[2];
  float x[2], y[2];
  int level[2];
};

template <int DESIGN, int MODE>
__device__ __forceinline__ ColTile load_tile(int c0, int Nb, int g, int t,
                                             const uint32_t* __restrict__ b,
                                             const uint8_t* __restrict__ vb,
                                             const float* __restrict__ xy_b,
                                             const int* __restrict__ lvl_b) {
  ColTile c;
  const int cb = c0 + g;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int w = DESIGN == kB1 ? t + 4 * k : 2 * t + k;
    c.w[k] = cb < Nb ? b[(size_t)cb * kWords + w] : 0u;
    const int col = c0 + 2 * t + k;
    const bool in = col < Nb;
    c.valid[k] = in && vb[col] != 0;
    c.x[k] = (MODE != kModeNone && in) ? xy_b[2 * col] : 0.0f;
    c.y[k] = (MODE != kModeNone && in) ? xy_b[2 * col + 1] : 0.0f;
    c.level[k] = (MODE == kModeStereo && in) ? lvl_b[col] : 0;
  }
  return c;
}

template <int DESIGN, int MODE>
__global__ void __launch_bounds__(kThreads)
hamming_top2_mma_kernel(const uint32_t* __restrict__ a, const uint8_t* __restrict__ va,
                        const uint32_t* __restrict__ b, const uint8_t* __restrict__ vb,
                        int Na, int Nb, int cols_per_block,
                        const float* __restrict__ xy_a, const float* __restrict__ xy_b,
                        const int* __restrict__ lvl_a, const int* __restrict__ lvl_b,
                        const float* __restrict__ gate, uint32_t* __restrict__ part,
                        uint32_t* __restrict__ col_key) {
  __shared__ uint32_t s_best[kWarps][kRowsPerBlock];
  __shared__ uint32_t s_second[kWarps][kRowsPerBlock];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;        // mma fragment group and thread-in-group
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int wcols = cols_per_block / kWarps;    // a multiple of 8
  const int col_lo = blockIdx.y * cols_per_block + warp * wcols;
  const int col_hi = min(col_lo + wcols, Nb);
  const float g0 = MODE != kModeNone ? gate[0] : 0.0f;
  const float g1 = MODE == kModeStereo ? gate[1] : 0.0f;

  // this thread's rows: row0 + 16 i + g + 8 h for m tile i, half h
  uint32_t af[kMTiles][4];
  int pa[kMTiles][2];
  bool rv[kMTiles][2];
  float qx[kMTiles][2], qy[kMTiles][2];
  int ql[kMTiles][2];
  uint32_t best[kMTiles][2], second[kMTiles][2];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 16 * i + g + 8 * h;
      const bool in = r < Na;
      if constexpr (DESIGN == kB1) {
        af[i][h] = in ? a[(size_t)r * kWords + t] : 0u;
        af[i][2 + h] = in ? a[(size_t)r * kWords + t + 4] : 0u;
      }
      rv[i][h] = in && va[r] != 0;
      qx[i][h] = (MODE != kModeNone && in) ? xy_a[2 * r] : 0.0f;
      qy[i][h] = (MODE != kModeNone && in) ? xy_a[2 * r + 1] : 0.0f;
      ql[i][h] = (MODE == kModeStereo && in) ? lvl_a[r] : 0;
      best[i][h] = kInitKey;
      second[i][h] = kInitKey;
    }
  }

  __shared__ __align__(16) uint8_t s_a[DESIGN == kS8 ? kRowsPerBlock * kRowBytes : 16];
  __shared__ __align__(16) uint8_t s_b[DESIGN == kS8 ? kWarps * 8 * kRowBytes : 16];
  if constexpr (DESIGN == kB1) {
    // popc of each row: the product against an all-ones B
    const uint32_t ones[4] = {~0u, ~0u, ~0u, ~0u};
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
      uint32_t d[4];
      mma_b1(af[i], ones[0], ones[1], d);
      pa[i][0] = (int)d[0];
      pa[i][1] = (int)d[2];
    }
  } else {
    // unpack the block's 64 rows to +-1 bytes: 4 words a thread
    for (int k = threadIdx.x; k < kRowsPerBlock * kWords; k += kThreads) {
      const int r = k / kWords, w = k % kWords;
      const uint32_t word = row0 + r < Na ? a[(size_t)(row0 + r) * kWords + w] : 0u;
      unpack_word(word, s_a + r * kRowBytes + 32 * w);
    }
    __syncthreads();
  }

  // the next 8-column tile's operands are loaded while this one is computed
  ColTile next = load_tile<DESIGN, MODE>(col_lo, Nb, g, t, b, vb, xy_b, lvl_b);
  for (int c0 = col_lo; c0 < col_hi; c0 += 8) {
    const ColTile cur = next;
    if (c0 + 8 < col_hi) next = load_tile<DESIGN, MODE>(c0 + 8, Nb, g, t, b, vb, xy_b, lvl_b);
    int pb[2] = {0, 0};
    if constexpr (DESIGN == kB1) {
      const uint32_t ones[4] = {~0u, ~0u, ~0u, ~0u};
      uint32_t d[4];
      mma_b1(ones, cur.w[0], cur.w[1], d);      // popc of columns c0 + 2t, c0 + 2t + 1
      pb[0] = (int)d[0];
      pb[1] = (int)d[1];
    } else {
      __syncwarp();                             // the previous tile's ldmatrix are done
      uint8_t* sb = s_b + warp * 8 * kRowBytes;
#pragma unroll
      for (int k = 0; k < 2; ++k) unpack_word(cur.w[k], sb + g * kRowBytes + 32 * (2 * t + k));
      __syncwarp();
    }
    uint32_t cmin[2] = {~0u, ~0u};

#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
      uint32_t d[4] = {0u, 0u, 0u, 0u};
      if constexpr (DESIGN == kB1) {
        mma_b1(af[i], cur.w[0], cur.w[1], d);
      } else {
        const uint32_t sa = (uint32_t)__cvta_generic_to_shared(s_a);
        const uint32_t sb = (uint32_t)__cvta_generic_to_shared(s_b + warp * 8 * kRowBytes);
        const int arow = 16 * i + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          uint32_t af8[4], bf0, bf1;
          ldmatrix_x4(sa + arow * kRowBytes + 32 * k + (lane >> 4) * 16, af8);
          ldmatrix_x2(sb + (lane & 7) * kRowBytes + 32 * k + ((lane >> 3) & 1) * 16, bf0, bf1);
          mma_s8(af8, bf0, bf1, d);
        }
      }
      // d[2h + j]: row 16 i + g + 8 h, column c0 + 2 t + j
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t row = (uint32_t)(row0 + 16 * i + g + 8 * h);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ham = DESIGN == kB1 ? pa[i][h] + pb[j] - 2 * (int)d[2 * h + j]
                                        : (256 - (int)d[2 * h + j]) >> 1;
          const bool ok = rv[i][h] && cur.valid[j] &&
                          gate_ok<MODE>(qx[i][h], qy[i][h], ql[i][h], cur.x[j], cur.y[j],
                                        cur.level[j], g0, g1);
          const uint32_t dist = ok ? (uint32_t)ham : kSentinel;
          top2_push((dist << kKeyShift) | (uint32_t)(c0 + 2 * t + j), best[i][h], second[i][h]);
          cmin[j] = min(cmin[j], (dist << kKeyShift) | row);
        }
      }
    }
    // columns: the minimum over the 8 lanes of a group, one atomicMin each
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        cmin[j] = min(cmin[j], __shfl_xor_sync(0xffffffffu, cmin[j], off));
      if (g == 0 && c0 + 2 * t + j < Nb) atomicMin(&col_key[c0 + 2 * t + j], cmin[j]);
    }
  }

  // rows: merge over the 4 lanes of a group, then over the warps
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const uint32_t ob = __shfl_xor_sync(0xffffffffu, best[i][h], off);
        const uint32_t os = __shfl_xor_sync(0xffffffffu, second[i][h], off);
        top2_merge(ob, os, best[i][h], second[i][h]);
      }
      if (t == 0) {
        s_best[warp][16 * i + g + 8 * h] = best[i][h];
        s_second[warp][16 * i + g + 8 * h] = second[i][h];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kRowsPerBlock && row0 + (int)threadIdx.x < Na) {
    uint32_t bk = s_best[0][threadIdx.x], sk = s_second[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) top2_merge(s_best[w][threadIdx.x], s_second[w][threadIdx.x], bk, sk);
    const size_t at = ((size_t)blockIdx.y * Na + row0 + threadIdx.x) * 2;
    part[at] = bk;
    part[at + 1] = sk;
  }
}

// each row's top-2 over the column splits, in split order (the merge is
// order-free, so any order gives the same keys)
__global__ void top2_merge_kernel(const uint32_t* __restrict__ part, int Na, int splits,
                                  int* __restrict__ idx_out, int* __restrict__ best_out,
                                  int* __restrict__ second_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= Na) return;
  uint32_t bk = part[2 * (size_t)r], sk = part[2 * (size_t)r + 1];
  for (int s = 1; s < splits; ++s) {
    const size_t at = ((size_t)s * Na + r) * 2;
    top2_merge(part[at], part[at + 1], bk, sk);
  }
  idx_out[r] = (int)(bk & kIndexMask);
  best_out[r] = (int)(bk >> kKeyShift);
  second_out[r] = (int)(sk >> kKeyShift);
}

template <int DESIGN, int MODE>
int launch(const void* a, const void* va, const void* b, const void* vb, int Na, int Nb,
           const void* xy_a, const void* xy_b, const void* lvl_a, const void* lvl_b,
           const void* gate, int cols_per_block, int splits, void* part, void* idx_out,
           void* best_out, void* second_out, void* col_key, cudaStream_t stream) {
  auto A = static_cast<const uint32_t*>(a);
  auto B = static_cast<const uint32_t*>(b);
  auto VA = static_cast<const uint8_t*>(va);
  auto VB = static_cast<const uint8_t*>(vb);
  auto XA = static_cast<const float*>(xy_a);
  auto XB = static_cast<const float*>(xy_b);
  auto LA = static_cast<const int*>(lvl_a);
  auto LB = static_cast<const int*>(lvl_b);
  auto GT = static_cast<const float*>(gate);
  const dim3 grid((Na + kRowsPerBlock - 1) / kRowsPerBlock, splits);
  hamming_top2_mma_kernel<DESIGN, MODE><<<grid, kThreads, 0, stream>>>(
      A, VA, B, VB, Na, Nb, cols_per_block, XA, XB, LA, LB, GT, static_cast<uint32_t*>(part),
      static_cast<uint32_t*>(col_key));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  top2_merge_kernel<<<(Na + 255) / 256, 256, 0, stream>>>(
      static_cast<const uint32_t*>(part), Na, splits, static_cast<int*>(idx_out),
      static_cast<int*>(best_out), static_cast<int*>(second_out));
  return (int)cudaGetLastError();
}

template <int DESIGN>
int launch_mode(int mode, const void* a, const void* va, const void* b, const void* vb, int Na,
                int Nb, const void* xy_a, const void* xy_b, const void* lvl_a,
                const void* lvl_b, const void* gate, int cols_per_block, int splits, void* part,
                void* idx_out, void* best_out, void* second_out, void* col_key,
                cudaStream_t stream) {
  if (mode == kModeWindow)
    return launch<DESIGN, kModeWindow>(a, va, b, vb, Na, Nb, xy_a, xy_b, lvl_a, lvl_b, gate,
                                       cols_per_block, splits, part, idx_out, best_out,
                                       second_out, col_key, stream);
  if (mode == kModeStereo)
    return launch<DESIGN, kModeStereo>(a, va, b, vb, Na, Nb, xy_a, xy_b, lvl_a, lvl_b, gate,
                                       cols_per_block, splits, part, idx_out, best_out,
                                       second_out, col_key, stream);
  return launch<DESIGN, kModeNone>(a, va, b, vb, Na, Nb, xy_a, xy_b, lvl_a, lvl_b, gate,
                                   cols_per_block, splits, part, idx_out, best_out, second_out,
                                   col_key, stream);
}

}  // namespace

// design 0 = single-bit mma, 1 = +-1 int8 mma (see the top of the file).
// cols_per_block (a multiple of 32) and splits (blocks across the columns,
// cols_per_block * splits >= Nb) come from ops/pallas_matching.py::top2_plan;
// part holds splits * Na * 2 keys.
// col_key must hold 0xffffffff on entry; on exit col_key[c] & (2^22 - 1) is
// column c's best row. Returns cudaGetLastError() after the launches
// (0 = launched), or -2 for an unknown design.
extern "C" int fitslam_hamming_top2(const void* a, const void* va, const void* b,
                                    const void* vb, int Na, int Nb, int mode,
                                    const void* xy_a, const void* xy_b,
                                    const void* lvl_a, const void* lvl_b,
                                    const void* gate, int design, int cols_per_block,
                                    int splits, void* part, void* idx_out, void* best_out,
                                    void* second_out, void* col_key, cudaStream_t stream) {
  if (design == kB1)
    return launch_mode<kB1>(mode, a, va, b, vb, Na, Nb, xy_a, xy_b, lvl_a, lvl_b, gate,
                            cols_per_block, splits, part, idx_out, best_out, second_out,
                            col_key, stream);
  if (design == kS8)
    return launch_mode<kS8>(mode, a, va, b, vb, Na, Nb, xy_a, xy_b, lvl_a, lvl_b, gate,
                            cols_per_block, splits, part, idx_out, best_out, second_out,
                            col_key, stream);
  return -2;
}
