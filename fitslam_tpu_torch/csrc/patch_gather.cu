// K1 for Hopper (sm_90a): the ORB patch gather and the fused ORB describe.
//
// Replaces the TPU kernel fitslam_tpu/ops/pallas_patches.py::_gather_kernel
// (launched by _gather_tpu). Two entry points share the window placement:
//
// fitslam_patch_gather: for each integer keypoint centre (x, y) it copies the
// (patch x patch) window of the image zero-padded by patch/2, with the start
// wrapped and clamped exactly as lax.dynamic_slice places it, so the result is
// bit-identical to the reference's vmapped dynamic_slice. Bound by bytes (no
// arithmetic); one block per keypoint, consecutive threads on consecutive
// pixels of a patch row, the zero padding a bounds test instead of a padded
// copy of the image. The TPU kernel kept the padded image in VMEM and shifted
// lanes with a one-hot MXU product because Mosaic cannot load at a dynamic
// lane offset; on Hopper a thread simply loads any address.
//
// fitslam_orb_describe: the gather and everything ops/orb.py computes from the
// 40x40 window, for the keypoints of all pyramid levels in one launch: the
// intensity-centroid orientation, its angle bin, the separable 7-tap blur to
// 32x32 and the rotated-BRIEF bit test, with the window and the blurred patch
// in shared memory. Only the angle and the +-1 descriptor go back to device
// memory. Its bound is bytes (the level images read once, ~0.5 MB of
// descriptors written: ~0.84 us an eye; ~38 M operations are ~0.56 us at the
// float32 peak); what it reaches is set by instruction throughput (every product
// and add is an instruction of its own, see below) and by the chain of
// dependent loads (keypoint, window, pair table). Layout: one block of 256
// threads per keypoint, a thread per descriptor bit, all of a thread's window
// loads in flight at once; the block finds its level in a by-value table of
// at most 8 levels. The blur's two passes keep a run of 8 (columns) or 4
// (rows) outputs a thread and the 14 or 10 inputs they share in registers,
// over shared-memory rows padded against bank conflicts.
//
// Bit-equality with the plain twin (ops/orb.py::describe_keypoints_plain)
// fixes every sum's order, and the twin repeats it:
// - blur: 7 taps in increasing offset, columns first and then rows, each
//   product and add rounded on its own (__fmul_rn / __fadd_rn, which are never
//   contracted into an FMA) on the bf16-rounded window; the result is rounded
//   to bf16 again;
// - moments m10, m01 over the central 32x32 of the raw window in float64:
//   thread t sums pixels t, t+256, t+512, t+768 in that order, then a tree
//   pairs lane l with lane l+16, +8, .., +1 in each warp and warp w with warp
//   w+4, +2, +1; the sums are rounded once to float32, then atan2f;
// - bin: round(angle / 2pi * 30) mod 30, with a true division (__fdiv_rn).
// No tensor cores: an mma gives no fixed float32 order, and the work is small.
// No TMA: its 2-D tile would zero-fill the border in hardware, but it needs a
// 16-byte row stride, which a level width that is not a multiple of 4 lacks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// lax.dynamic_slice first wraps a negative start once (start += extent), then
// clamps it into [0, padded_extent - patch]; returns the window's origin in
// unpadded image coordinates
__device__ __forceinline__ int2 window_origin(int x, int y, int H, int W, int patch) {
  const int half = patch / 2;
  const int ext_x = W + 2 * half;
  const int ext_y = H + 2 * half;
  if (x < 0) x += ext_x;
  if (y < 0) y += ext_y;
  x = min(max(x, 0), ext_x - patch);
  y = min(max(y, 0), ext_y - patch);
  return make_int2(x - half, y - half);
}

__global__ void patch_gather_kernel(const float* __restrict__ img, int H, int W,
                                    const int* __restrict__ xy, int n, int patch,
                                    float* __restrict__ out) {
  const int i = blockIdx.x;
  if (i >= n) return;
  const int2 o = window_origin(xy[2 * i], xy[2 * i + 1], H, W, patch);
  float* dst = out + (size_t)i * patch * patch;
  const int count = patch * patch;
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    const int r = k / patch;
    const int c = k - r * patch;
    const int y = o.y + r;
    const int x = o.x + c;
    float v = 0.0f;
    if (y >= 0 && y < H && x >= 0 && x < W) v = img[(size_t)y * W + x];
    dst[k] = v;
  }
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fitslam_patch_gather(const float* img, int H, int W, const int* xy,
                                    int n, int patch, float* out,
                                    cudaStream_t stream) {
  if (n > 0) {
    patch_gather_kernel<<<n, 256, 0, stream>>>(img, H, W, xy, n, patch, out);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fused ORB describe
// ---------------------------------------------------------------------------

constexpr int MAX_LEVELS = 8;
constexpr int WIN = 40;       // gathered window (GPATCH)
constexpr int PATCH = 32;     // described patch
constexpr int CROP = (WIN - PATCH) / 2;
constexpr int TAPS = 7;
constexpr int N_BINS = 30;
constexpr int N_PAIRS = 256;  // = threads a block
constexpr float TWO_PI = 6.28318530717958647692f;
constexpr unsigned short BF16_PLUS_ONE = 0x3F80;
constexpr unsigned short BF16_MINUS_ONE = 0xBF80;

struct LevelTable {
  const float* img[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int first[MAX_LEVELS + 1];  // first keypoint of each level; first[n_levels] = N
  int n_levels;
  float taps[TAPS];           // bf16-valued blur weights, offsets -3..3
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(N_PAIRS)
orb_describe_kernel(const LevelTable lv, const int* __restrict__ xy,
                    const int2* __restrict__ pairs, float* __restrict__ angle,
                    unsigned short* __restrict__ desc) {
  // rows padded to an odd stride (WB) or to 33 (CS): the blur's threads walk
  // down the rows, and an even stride would put them on a few banks
  constexpr int WB = WIN + 1;
  constexpr int CS = PATCH + 1;
  __shared__ float win[WIN * WIN];        // raw window, zero outside the level image
  __shared__ float win_bf[WIN * WB];      // the window rounded to bf16
  __shared__ float cols[WIN * CS];        // column pass of the blur
  __shared__ float smooth[PATCH * PATCH]; // blurred patch, bf16-valued
  __shared__ double warp_sum[2][N_PAIRS / 32];
  __shared__ int s_bin;

  const int i = blockIdx.x;
  const int t = threadIdx.x;
  int l = 0;
  while (l + 1 < lv.n_levels && i >= lv.first[l + 1]) ++l;
  const int H = lv.h[l];
  const int W = lv.w[l];
  const float* __restrict__ img = lv.img[l];
  const int2 o = window_origin(xy[2 * i], xy[2 * i + 1], H, W, WIN);

  // all of a thread's window loads in flight at once, then into shared memory
  constexpr int LOADS = (WIN * WIN + N_PAIRS - 1) / N_PAIRS;
  float v[LOADS];
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int k = t + j * N_PAIRS;
    const int y = o.y + k / WIN;
    const int x = o.x + k % WIN;
    v[j] = (k < WIN * WIN && y >= 0 && y < H && x >= 0 && x < W) ? img[(size_t)y * W + x] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int k = t + j * N_PAIRS;
    if (k < WIN * WIN) {
      win[k] = v[j];
      win_bf[(k / WIN) * WB + k % WIN] = bf16_round(v[j]);
    }
  }
  __syncthreads();

  // orientation moments: weights (c - 16, r - 16) inside the radius-15
  // circle, else (c - 16) * 0.0 as the reference's float matrix holds them
  double m10 = 0.0, m01 = 0.0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = t + j * N_PAIRS;
    const int dr = (k >> 5) - PATCH / 2;
    const int dc = (k & 31) - PATCH / 2;
    const double circ = (dr * dr + dc * dc <= 15 * 15) ? 1.0 : 0.0;
    const double p = (double)win[((k >> 5) + CROP) * WIN + (k & 31) + CROP];
    const double px = __dmul_rn(p, __dmul_rn((double)dc, circ));
    const double py = __dmul_rn(p, __dmul_rn((double)dr, circ));
    m10 = j == 0 ? px : __dadd_rn(m10, px);
    m01 = j == 0 ? py : __dadd_rn(m01, py);
  }

  // blur, column pass: a thread takes 8 neighbouring outputs of one row
  // (rows 0..39, output columns 0..31) from 14 window values in registers
  constexpr int RUN = 8;
  if (t < WIN * (PATCH / RUN)) {
    const int r = t % WIN;
    const int c0 = (t / WIN) * RUN;
    const float* row = win_bf + r * WB + c0 + (CROP - TAPS / 2);
    float x[RUN + TAPS - 1];
#pragma unroll
    for (int m = 0; m < RUN + TAPS - 1; ++m) x[m] = row[m];
#pragma unroll
    for (int u = 0; u < RUN; ++u) {
      float acc = __fmul_rn(x[u], lv.taps[0]);
#pragma unroll
      for (int q = 1; q < TAPS; ++q) acc = __fadd_rn(acc, __fmul_rn(x[u + q], lv.taps[q]));
      cols[r * CS + c0 + u] = acc;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 = __dadd_rn(m10, __shfl_down_sync(0xffffffffu, m10, off));
    m01 = __dadd_rn(m01, __shfl_down_sync(0xffffffffu, m01, off));
  }
  if ((t & 31) == 0) {
    warp_sum[0][t >> 5] = m10;
    warp_sum[1][t >> 5] = m01;
  }
  __syncthreads();

  if (t < 32) {
    m10 = t < N_PAIRS / 32 ? warp_sum[0][t] : 0.0;
    m01 = t < N_PAIRS / 32 ? warp_sum[1][t] : 0.0;
#pragma unroll
    for (int off = N_PAIRS / 64; off > 0; off >>= 1) {
      m10 = __dadd_rn(m10, __shfl_down_sync(0xffffffffu, m10, off));
      m01 = __dadd_rn(m01, __shfl_down_sync(0xffffffffu, m01, off));
    }
    if (t == 0) {
      const float a = atan2f(__double2float_rn(m01), __double2float_rn(m10));
      angle[i] = a;
      int b = (int)rintf(__fmul_rn(__fdiv_rn(a, TWO_PI), (float)N_BINS));
      s_bin = ((b % N_BINS) + N_BINS) % N_BINS;
    }
  }

  // blur, row pass: a thread takes 4 neighbouring outputs of one column
  // (output rows 0..31) from 10 column-pass values in registers, rounded to bf16
  constexpr int ROWS = PATCH * PATCH / N_PAIRS;
  {
    const int c = t & 31;
    const int r0 = (t >> 5) * ROWS;
    const float* col = cols + (r0 + CROP - TAPS / 2) * CS + c;
    float x[ROWS + TAPS - 1];
#pragma unroll
    for (int m = 0; m < ROWS + TAPS - 1; ++m) x[m] = col[m * CS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      float acc = __fmul_rn(x[u], lv.taps[0]);
#pragma unroll
      for (int q = 1; q < TAPS; ++q) acc = __fadd_rn(acc, __fmul_rn(x[u + q], lv.taps[q]));
      smooth[(r0 + u) * PATCH + c] = bf16_round(acc);
    }
  }
  __syncthreads();

  // rotated BRIEF: bit t is +1 where point A is darker than point B
  const int2 pr = __ldg(pairs + s_bin * N_PAIRS + t);
  const bool darker = __fsub_rn(smooth[pr.x], smooth[pr.y]) < 0.0f;
  desc[(size_t)i * N_PAIRS + t] = darker ? BF16_PLUS_ONE : BF16_MINUS_ONE;
}

// Describes the keypoints of n_levels (<= 8) level images: counts[l]
// keypoints of level l, concatenated in level order in xy (N x 2 int32).
// pairs: (30, 256, 2) int32 flat in-patch indices of each bit's points A, B;
// taps: the 7 blur weights. Writes angle (N) and desc (N x 256 bf16 bits).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fitslam_orb_describe(int n_levels, const float* const* imgs, const int* hs,
                                    const int* ws, const int* counts, const int* xy,
                                    const float* taps, const int* pairs, float* angle,
                                    unsigned short* desc, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  LevelTable lv;
  lv.n_levels = n_levels;
  lv.first[0] = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.img[l] = imgs[l];
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
    lv.first[l + 1] = lv.first[l] + counts[l];
  }
  for (int q = 0; q < TAPS; ++q) lv.taps[q] = taps[q];
  const int n = lv.first[n_levels];
  if (n > 0) {
    orb_describe_kernel<<<n, N_PAIRS, 0, stream>>>(
        lv, xy, reinterpret_cast<const int2*>(pairs), angle, desc);
  }
  return (int)cudaGetLastError();
}
