// K3: wavefront potential sweeps for Hopper (sm_90a).
//
// Replaces the TPU kernel fitslam_tpu/ops/pallas_grid.py::_sweep_kernel
// (launched by wavefront_sweeps). It runs `iters` Jacobi min-plus sweeps of
// a (H, W) float32 potential,
//
//   pot' = min(pot, passable ? min(up, down, left, right) + step : BIG),
//
// where a neighbour outside the grid counts as BIG. Each sweep reads only the
// previous sweep's values (Jacobi, not Gauss-Seidel), so the result after a
// fixed number of sweeps equals the reference's bit for bit: min is exact and
// there is one float32 add per cell and sweep (built with --fmad=false).
//
// What bounds it on the H100: latency, not bytes or operations. A sweep is
// ~5 operations a cell (1.5 us of the card's float32 rate for all 512 sweeps
// of a 320 x 320 grid), but every sweep waits for the previous one across
// the whole grid. Two kernels, chosen by the size rule in ops/pallas_grid.py:
//
// * wavefront_resident_kernel: ONE launch for all sweeps. One thread-block
//   cluster (up to 16 blocks, one per SM, non-portable size) owns the grid;
//   each block owns a band of rows and each thread a tile of RT x 4 cells,
//   whose potential and step costs stay in registers for every sweep. Per
//   sweep a thread writes its tile's four edges to shared memory, relaxes
//   its cells against their neighbours inside the tile, meets the block's
//   barrier, and finishes the edge cells from its neighbours' edges. The
//   band's top and bottom rows go to the neighbouring blocks with st.async
//   (distributed shared memory), which completes the receiving block's
//   mbarrier: each band waits only for its two neighbours' rows, and no
//   cluster-wide barrier runs inside the sweep loop. Edge and halo buffers
//   are double-buffered by sweep parity. With a group of k > 1 sweeps
//   instead, each band also holds k halo rows above and below it (real grid
//   rows, swept like its own) and receives them from its neighbours once
//   every k sweeps: between exchanges the band sweeps alone, its valid rows
//   shrinking by one a sweep from the halo's outer edge, so its own rows stay
//   exact. That variant (GROUPED) is timed beside the size rule's exchange
//   after every sweep, which is faster at every size measured. The first
//   sweep reads pot0 from device memory with the reference's rule for
//   impassable cells; after it an impassable cell holds at most BIG, so
//   later sweeps give it an infinite step (min(pot, +inf) = pot =
//   min(pot, BIG)) and need no select.
// * wavefront_tile_kernel (grids too large for one cluster): temporal
//   blocking. Each block loads a (B + 2T)^2 tile (B = 32 inner cells, a halo
//   of T = 8) into shared memory, runs T sweeps there while the valid region
//   shrinks by one cell per sweep, and writes back its inner B^2 cells;
//   ceil(iters / T) launches ping-pong between two device buffers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kBig = 1e9f;

// ---------------------------------------------------------------- resident

constexpr int kCols = 4;            // columns of a thread's tile (one float4)
constexpr int kMaxThreads = 512;    // threads a block: up to 128 registers each
constexpr int kMaxCluster = 16;     // the H100's non-portable cluster limit

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the same shared-memory offset in block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// 16 bytes into another block's shared memory; on arrival they count
// towards that block's mbarrier transaction
__device__ __forceinline__ void store_remote(uint32_t addr, float4 v, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(mbar) : "memory");
}

__device__ __forceinline__ void expect_bytes(uint32_t mbar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(mbar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_phase(uint32_t mbar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "wait_%=: mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra wait_%=;\n}\n" ::"r"(mbar), "r"(parity) : "memory");
}

// Shared memory of one sweep parity, in floats (XW = 4 TX, BR = RT TY):
//   row_edge[(2 ty + side) * XW + x]   side 0 = tile's top row, 1 = bottom
//   col_edge[(side * BR + y) * TX + tx] side 0 = tile's left column, 1 = right
//   halo_above[x], halo_below[x]        the neighbouring bands' edge rows
// and, after both parities, for a group of k > 1 sweeps, the k halo rows
// above and the k below, for each exchange parity:
//   recv[((2 parity + side) * k + r) * XW + x]   side 0 = above, 1 = below
// A cluster of more than one block moves the halo rows with st.async into
// the neighbour's shared memory and completes the neighbour's mbarrier of
// that parity: a point-to-point wait of ~0.2 us, where a cluster-wide
// barrier with release/acquire ordering costs ~0.5-0.7 us a sweep on an
// H100 (tools/cluster_sync_probe.cu).
template <int RT, bool CLUSTER, bool GROUPED>
__global__ void __launch_bounds__(kMaxThreads, 1)
wavefront_resident_kernel(const float* __restrict__ pot0, const float* __restrict__ step,
                          const unsigned char* __restrict__ passable, int H, int W,
                          int iters, int TX, int TY, int group, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  __shared__ __align__(8) unsigned long long halo_ready[2];
  float* const smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = CLUSTER ? (int)cluster.block_rank() : 0;
  const int nb = CLUSTER ? (int)cluster.num_blocks() : 1;
  const int XW = kCols * TX;
  const int BR = RT * TY;
  const int row_edge_at = 0;
  const int col_edge_at = 2 * TY * XW;
  const int above_at = col_edge_at + 2 * BR * TX;
  const int below_at = above_at + XW;
  const int parity_floats = below_at + XW;
  const int recv_at = 2 * parity_floats;
  static_assert(CLUSTER || !GROUPED, "a group exchanges between the blocks of a cluster");
  // halo rows of a band that exchanges once every `group` sweeps; a band
  // owns the BR - 2 * halo rows between them
  const int halo = GROUPED ? group : 0;
  const int own = BR - 2 * halo;

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int y0 = rank * own - halo + ty * RT;
  const int x0 = tx * kCols;
  const float inf = __int_as_float(0x7f800000);

  // sweep 1, from device memory
  float p[RT][kCols], s[RT][kCols];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int y = y0 + i, x = x0 + j;
      p[i][j] = kBig;
      s[i][j] = inf;
      if (y >= 0 && y < H && x < W) {
        const size_t g = (size_t)y * W + x;
        const float up = y > 0 ? pot0[g - W] : kBig;
        const float dn = y + 1 < H ? pot0[g + W] : kBig;
        const float lf = x > 0 ? pot0[g - 1] : kBig;
        const float rt = x + 1 < W ? pot0[g + 1] : kBig;
        const float best = fminf(fminf(up, dn), fminf(lf, rt));
        const bool ok = passable[g] != 0;
        const float st = step[g];
        p[i][j] = fminf(pot0[g], ok ? __fadd_rn(best, st) : kBig);
        s[i][j] = ok ? st : inf;
      }
    }
  }
  // halo rows that no neighbour writes (above band 0, below the last) stay BIG
  for (int k = threadIdx.x; k < 2 * XW; k += blockDim.x) {
    smem[above_at + k] = kBig;
    smem[parity_floats + above_at + k] = kBig;
  }
  const int halo_bytes =
      ((rank > 0) + (rank < nb - 1)) * XW * (int)sizeof(float) * (GROUPED ? halo : 1);
  // the threads that wait for the neighbours' rows: those of the band's edge
  // rows, or with a group, those that hold halo rows
  const bool waits = CLUSTER && (GROUPED ? (rank > 0 && ty * RT < halo) ||
                                               (rank < nb - 1 && ty * RT + RT > BR - halo)
                                         : ty == 0 || ty == TY - 1);
  if (CLUSTER) {
    if (threadIdx.x == 0) {
      for (int k = 0; k < 2; ++k)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&halo_ready[k])));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster.sync();   // every block has started, set its halos and its mbarriers
  } else {
    __syncthreads();
  }

  for (int sweep = 1; sweep < iters; ++sweep) {
    const int par = sweep & 1;
    float* const buf = smem + par * parity_floats;
    const float4 top = make_float4(p[0][0], p[0][1], p[0][2], p[0][3]);
    const float4 bot = make_float4(p[RT - 1][0], p[RT - 1][1], p[RT - 1][2], p[RT - 1][3]);
    *reinterpret_cast<float4*>(buf + row_edge_at + (2 * ty) * XW + x0) = top;
    *reinterpret_cast<float4*>(buf + row_edge_at + (2 * ty + 1) * XW + x0) = bot;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      buf[col_edge_at + (ty * RT + i) * TX + tx] = p[i][0];
      buf[col_edge_at + (BR + ty * RT + i) * TX + tx] = p[i][kCols - 1];
    }
    const uint32_t ready = smem_addr(&halo_ready[par]);
    if (CLUSTER && !GROUPED) {
      if (ty == 0 && rank > 0)
        store_remote(cluster_addr(smem_addr(buf + below_at + x0), rank - 1), top,
                     cluster_addr(ready, rank - 1));
      if (ty == TY - 1 && rank < nb - 1)
        store_remote(cluster_addr(smem_addr(buf + above_at + x0), rank + 1), bot,
                     cluster_addr(ready, rank + 1));
      if (threadIdx.x == 0) expect_bytes(ready, halo_bytes);
    }

    // neighbours inside the tile, while the other threads' edges land
    float m[RT][kCols];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        // starts from a neighbour that exists (RT >= 2): a start at +inf
        // would cost one more min a cell, since fminf(inf, x) is not x for NaN
        float v = i > 0 ? p[i - 1][j] : p[i + 1][j];
        if (i > 0 && i < RT - 1) v = fminf(v, p[i + 1][j]);
        if (j > 0) v = fminf(v, p[i][j - 1]);
        if (j < kCols - 1) v = fminf(v, p[i][j + 1]);
        m[i][j] = v;
      }
    }
    __syncthreads();
    // this parity's (sweep - 1) / 2-th use; thread 0 is a waiter, so its
    // next expect_tx on this mbarrier follows the phase's completion
    if (!GROUPED && waits) wait_phase(ready, ((sweep - 1) >> 1) & 1);

    const float4 up = *reinterpret_cast<const float4*>(
        ty > 0 ? buf + row_edge_at + (2 * ty - 1) * XW + x0 : buf + above_at + x0);
    const float4 dn = *reinterpret_cast<const float4*>(
        ty < TY - 1 ? buf + row_edge_at + (2 * ty + 2) * XW + x0 : buf + below_at + x0);
    m[0][0] = fminf(m[0][0], up.x);
    m[0][1] = fminf(m[0][1], up.y);
    m[0][2] = fminf(m[0][2], up.z);
    m[0][3] = fminf(m[0][3], up.w);
    m[RT - 1][0] = fminf(m[RT - 1][0], dn.x);
    m[RT - 1][1] = fminf(m[RT - 1][1], dn.y);
    m[RT - 1][2] = fminf(m[RT - 1][2], dn.z);
    m[RT - 1][3] = fminf(m[RT - 1][3], dn.w);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float lf = tx > 0 ? buf[col_edge_at + (BR + ty * RT + i) * TX + tx - 1] : kBig;
      const float rt = tx < TX - 1 ? buf[col_edge_at + (ty * RT + i) * TX + tx + 1] : kBig;
      m[i][0] = fminf(m[i][0], lf);
      m[i][kCols - 1] = fminf(m[i][kCols - 1], rt);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) p[i][j] = fminf(p[i][j], __fadd_rn(m[i][j], s[i][j]));
    }
    // a group's exchange after sweeps 1 + k, 1 + 2k, ... (sweep + 1 of them
    // are done): each band's first and last k own rows go to its neighbours'
    // halos, and its own halos arrive, all exact as of this sweep
    if (GROUPED && sweep % halo == 0 && sweep + 1 < iters) {
      const int e = sweep / halo - 1;
      float* const recv = smem + recv_at + (e & 1) * 2 * halo * XW;
      const uint32_t xready = smem_addr(&halo_ready[e & 1]);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = ty * RT + i;
        const float4 v = make_float4(p[i][0], p[i][1], p[i][2], p[i][3]);
        if (rank > 0 && r >= halo && r < 2 * halo)
          store_remote(cluster_addr(smem_addr(recv + (halo + (r - halo)) * XW + x0), rank - 1),
                       v, cluster_addr(xready, rank - 1));
        if (rank < nb - 1 && r >= BR - 2 * halo && r < BR - halo)
          store_remote(cluster_addr(smem_addr(recv + (r - (BR - 2 * halo)) * XW + x0), rank + 1),
                       v, cluster_addr(xready, rank + 1));
      }
      if (threadIdx.x == 0) expect_bytes(xready, halo_bytes);
      if (waits) {
        wait_phase(xready, (e >> 1) & 1);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const int r = ty * RT + i;
          const float* src = rank > 0 && r < halo ? recv + r * XW
                             : rank < nb - 1 && r >= BR - halo ? recv + (halo + r - (BR - halo)) * XW
                                                               : nullptr;
          if (src) {
            const float4 v = *reinterpret_cast<const float4*>(src + x0);
            p[i][0] = v.x;
            p[i][1] = v.y;
            p[i][2] = v.z;
            p[i][3] = v.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int y = y0 + i, x = x0 + j, r = ty * RT + i;
      if (r >= halo && r < BR - halo && y < H && x < W) out[(size_t)y * W + x] = p[i][j];
    }
  }
  // no block leaves while a neighbour may still write into its shared memory
  if (CLUSTER) cluster.sync();
}

// -------------------------------------------------------------------- tiled

constexpr int kInner = 32;                 // B: inner tile width
constexpr int kHalo = 8;                   // T: sweeps per launch
constexpr int kTile = kInner + 2 * kHalo;  // 48
constexpr int kTileThreads = 256;

__global__ void wavefront_tile_kernel(const float* __restrict__ pot_in,
                                      const float* __restrict__ step,
                                      const unsigned char* __restrict__ passable,
                                      int H, int W, int sweeps,
                                      float* __restrict__ pot_out) {
  __shared__ float buf_a[kTile * kTile];
  __shared__ float buf_b[kTile * kTile];
  __shared__ float cost[kTile * kTile];
  __shared__ unsigned char ok[kTile * kTile];

  const int y0 = blockIdx.y * kInner - kHalo;   // grid row of tile row 0
  const int x0 = blockIdx.x * kInner - kHalo;
  for (int k = threadIdx.x; k < kTile * kTile; k += blockDim.x) {
    const int y = y0 + k / kTile;
    const int x = x0 + k % kTile;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const size_t g = (size_t)y * W + x;
      buf_a[k] = pot_in[g];
      cost[k] = step[g];
      ok[k] = passable[g];
    } else {
      // outside the grid: BIG and impassable, so it stays BIG every sweep
      buf_a[k] = kBig;
      cost[k] = 0.0f;
      ok[k] = 0;
    }
  }
  __syncthreads();

  float* cur = buf_a;
  float* nxt = buf_b;
  for (int s = 1; s <= sweeps; ++s) {
    // after s sweeps, cells at least s from the tile's edge are exact
    const int lo = s, hi = kTile - s;
    for (int k = threadIdx.x; k < kTile * kTile; k += blockDim.x) {
      const int r = k / kTile;
      const int c = k % kTile;
      if (r < lo || r >= hi || c < lo || c >= hi) continue;
      const float up = cur[k - kTile];
      const float dn = cur[k + kTile];
      const float lf = cur[k - 1];
      const float rt = cur[k + 1];
      const float best = fminf(fminf(up, dn), fminf(lf, rt));
      const float cand = ok[k] ? __fadd_rn(best, cost[k]) : kBig;
      nxt[k] = fminf(cur[k], cand);
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  for (int k = threadIdx.x; k < kInner * kInner; k += blockDim.x) {
    const int r = kHalo + k / kInner;
    const int c = kHalo + k % kInner;
    const int y = y0 + r;
    const int x = x0 + c;
    if (y < H && x < W) pot_out[(size_t)y * W + x] = cur[r * kTile + c];
  }
}

// cudaOccupancyMaxActiveClusters is a host query; its answer for a launch
// shape is kept so that a plan pays for it once
struct ClusterCheck {
  const void* kernel;
  int blocks, threads, smem, active;
};
ClusterCheck g_checked[32];
int g_n_checked = 0;

template <int RT, bool CLUSTER, bool GROUPED>
int launch_resident(const float* pot0, const float* step, const unsigned char* passable,
                    int H, int W, int iters, int TX, int TY, int group, int blocks,
                    float* out, cudaStream_t stream) {
  const int XW = kCols * TX, BR = RT * TY;
  const int halo = GROUPED ? group : 0;
  const int smem = (int)sizeof(float) * (2 * (2 * TY * XW + 2 * BR * TX + 2 * XW) +
                                         4 * halo * XW);
  auto kernel = wavefront_resident_kernel<RT, CLUSTER, GROUPED>;
  const void* key = reinterpret_cast<const void*>(kernel);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(TX * TY);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  int active = -1;
  for (int k = 0; k < g_n_checked; ++k) {
    const ClusterCheck& c = g_checked[k];
    if (c.kernel == key && c.blocks == blocks && c.threads == TX * TY && c.smem == smem)
      active = c.active;
  }
  if (active < 0) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (g_n_checked < 32) g_checked[g_n_checked++] = {key, blocks, TX * TY, smem, active};
  } else {
    // the attribute is per kernel: a larger plan may have raised it since
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (active < 1) return -1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, pot0, step, passable, H, W, iters, TX, TY, group, out);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// All `iters` sweeps in one launch of one cluster of `blocks` blocks of
// TX * TY threads, each thread a tile of `rows_per_thread` (4 or 8) x 4
// cells, the bands exchanging rows after every sweep (group 1) or every
// `group` sweeps (a cluster only: `group` halo rows on either side of each
// band); the plan comes from ops/pallas_grid.py::sweep_plan. pot0 is not
// modified. Returns 0 when launched, a cudaError_t, -1 when the device
// cannot schedule the cluster, or -2 for a plan that does not cover the grid.
extern "C" int fitslam_wavefront_sweeps_resident(const float* pot0, const float* step,
                                                 const unsigned char* passable, int H, int W,
                                                 int iters, int rows_per_thread, int TX,
                                                 int TY, int group, int blocks, float* out,
                                                 cudaStream_t stream) {
  const int halo = blocks > 1 && group > 1 ? group : 0;
  const int own = rows_per_thread * TY - 2 * halo;
  if (TX < 1 || TY < 1 || TX * TY > kMaxThreads || blocks < 1 || blocks > kMaxCluster ||
      group < 1 || own < halo || own < 1 || kCols * TX < W || blocks * own < H ||
      (rows_per_thread != 4 && rows_per_thread != 8))
    return -2;
  if (iters <= 0) {
    cudaMemcpyAsync(out, pot0, sizeof(float) * (size_t)H * W, cudaMemcpyDeviceToDevice, stream);
    return (int)cudaGetLastError();
  }
  if (rows_per_thread == 4 && blocks == 1)
    return launch_resident<4, false, false>(pot0, step, passable, H, W, iters, TX, TY, 1, 1, out,
                                            stream);
  if (rows_per_thread == 4 && halo)
    return launch_resident<4, true, true>(pot0, step, passable, H, W, iters, TX, TY, group,
                                          blocks, out, stream);
  if (rows_per_thread == 4)
    return launch_resident<4, true, false>(pot0, step, passable, H, W, iters, TX, TY, 1, blocks,
                                           out, stream);
  if (blocks == 1)
    return launch_resident<8, false, false>(pot0, step, passable, H, W, iters, TX, TY, 1, 1, out,
                                            stream);
  if (halo)
    return launch_resident<8, true, true>(pot0, step, passable, H, W, iters, TX, TY, group,
                                          blocks, out, stream);
  return launch_resident<8, true, false>(pot0, step, passable, H, W, iters, TX, TY, 1, blocks,
                                         out, stream);
}

// All `iters` sweeps of the tiled kernel: ceil(iters / 8) launches on
// `stream`, reading pot0 first and alternating between `scratch` and `out`
// so that the last launch writes `out`. pot0 is not modified. Returns
// cudaGetLastError() after the last launch (0 = every launch was accepted).
extern "C" int fitslam_wavefront_sweeps_tiled(const float* pot0, const float* step,
                                              const unsigned char* passable, int H, int W,
                                              int iters, float* out, float* scratch,
                                              cudaStream_t stream) {
  if (iters <= 0) {
    cudaMemcpyAsync(out, pot0, sizeof(float) * (size_t)H * W, cudaMemcpyDeviceToDevice, stream);
    return (int)cudaGetLastError();
  }
  const int launches = (iters + kHalo - 1) / kHalo;
  const dim3 grid((W + kInner - 1) / kInner, (H + kInner - 1) / kInner);
  const float* src = pot0;
  for (int i = 0; i < launches; ++i) {
    float* dst = ((launches - 1 - i) % 2 == 0) ? out : scratch;
    const int sweeps = (i == launches - 1) ? iters - kHalo * (launches - 1) : kHalo;
    wavefront_tile_kernel<<<grid, kTileThreads, 0, stream>>>(src, step, passable, H, W,
                                                             sweeps, dst);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  return 0;
}
