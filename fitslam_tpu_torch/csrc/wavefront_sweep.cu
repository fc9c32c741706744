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
// What bounds it on the H100: memory traffic and launch count. The TPU
// kernel kept the three (G, G) arrays resident in one core's VMEM for all
// sweeps; one SM's shared memory (227 KB) cannot hold them (1.2 MB at
// G=320, 3 MB at G=512), and a sweep per launch would move the grid through
// L2 `iters` times. The design is temporal blocking: each block loads a
// (B + 2T)^2 tile (B = 32 inner cells, a halo of T = 8) of the potential,
// the step costs and the passability into shared memory (about 30 KB), runs
// T sweeps there while the valid region shrinks by one cell per sweep, and
// writes back its inner B^2 cells, which are then exact. Launches ping-pong
// between two device buffers; the loop over launches (iters / T of them)
// lives in the C entry point, so Python makes one call per potential.

#include <cuda_runtime.h>

namespace {

constexpr int kInner = 32;                 // B: inner tile width
constexpr int kHalo = 8;                   // T: sweeps per launch
constexpr int kTile = kInner + 2 * kHalo;  // 48
constexpr int kThreads = 256;
constexpr float kBig = 1e9f;

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

}  // namespace

// Runs all `iters` sweeps: ceil(iters / 8) launches on `stream`, reading
// pot0 first and alternating between `scratch` and `out` so that the last
// launch writes `out`. pot0 is not modified. Returns cudaGetLastError()
// after the last launch (0 = every launch was accepted).
extern "C" int fitslam_wavefront_sweeps(const float* pot0, const float* step,
                                        const unsigned char* passable, int H, int W,
                                        int iters, float* out, float* scratch,
                                        cudaStream_t stream) {
  if (iters <= 0) {
    cudaMemcpyAsync(out, pot0, sizeof(float) * (size_t)H * W,
                    cudaMemcpyDeviceToDevice, stream);
    return (int)cudaGetLastError();
  }
  const int launches = (iters + kHalo - 1) / kHalo;
  const dim3 grid((W + kInner - 1) / kInner, (H + kInner - 1) / kInner);
  const float* src = pot0;
  for (int i = 0; i < launches; ++i) {
    float* dst = ((launches - 1 - i) % 2 == 0) ? out : scratch;
    const int sweeps = (i == launches - 1) ? iters - kHalo * (launches - 1) : kHalo;
    wavefront_tile_kernel<<<grid, kThreads, 0, stream>>>(src, step, passable, H, W,
                                                         sweeps, dst);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  return 0;
}
