// The EKF window: one filter's window of measurement rows fused on Hopper
// (sm_90a), every row in order inside one thread block.
//
// Replaces no Pallas kernel: the reference has none for the filter. It
// replaces the reference's lax.scan over a window's rows,
// fitslam_tpu/models/localization.py:182-201 (_run_ekf), which the port ran
// as run_ekf's Python loop of ~82 PyTorch and cuSOLVER kernels a row,
// captured as one CUDA graph a window. The arithmetic is run_ekf's, in
// float32, with sums taken in index order and no fused multiply-add
// (NVCC_FLAGS' --fmad=false). Per row:
//   predict  F from the factor products of _transition_jacobian (sinf, cosf,
//            the gimbal guard at |cos pitch| < 1e-6), x <- wrap(F x),
//            P <- (F P) F^T + Q max(dt, 0);
//   update   the masked, wrapped innovation, Rd (BIG_VAR on unmeasured
//            dims), S = P + diag(Rd); LU with partial pivoting (the first
//            largest |a| of a column, rows swapped; the column below a pivot
//            scaled by its correctly rounded reciprocal, as LAPACK's getf2
//            does) of S and, with its own factors, of S^T; S sol = innov and
//            S^T Y = P^T by getrs' substitutions, U's diagonal applied by the
//            same reciprocals; the Mahalanobis gate; K = Y^T accepted;
//            x <- wrap(x + K innov); the Joseph form
//            P <- ((I - K) P)(I - K)^T + (K Rd) K^T.
// The angle wrap is torch.remainder's (and jnp.mod's): fmodf, then the
// divisor added where the remainder's sign differs from it.
//
// What bounds it: the chain of T dependent row updates. A row is ~24 k
// float32 multiply-adds on 15x15 matrices and a 64-row window's input is
// 12 KB, microseconds of work for one SM and nanoseconds of memory traffic:
// neither FLOPs nor bytes bound it. Each row needs the last row's x and P,
// so the time is T times the latency of one row's dependent steps, and most
// of a row is the two 15-step factorisations, each step a pivot search,
// a reciprocal and a row update one after another.
//
// How the design shortens that chain:
//   - x, P, Q, the window's rows (T x 47) and every intermediate stay in
//     shared memory for the whole window: one load at entry, one store of x
//     and P at exit, nothing through device memory between rows.
//   - 225 threads own one entry each of the 15x15 products; a ninth warp
//     does the vector work (K innov, then the next row's F, F x and
//     innovation) while they run the row's products. Six block barriers a
//     row.
//   - The two factorisations run at the same time, S's on warp 0 and S^T's
//     on warp 1. A lane holds one row of the matrix in registers; a row swap
//     trades two lanes' positions instead of moving data; the pivot comes
//     from two warp reductions (redux.sync), the pivot's reciprocal from a
//     shuffle. Every lane takes the reciprocal of its own entry while the
//     pivot is sought, so the ~200 cycles of a correctly rounded reciprocal
//     overlap the search; no lane divides by zero, whose slow path holds
//     the warp ~300 cycles.
//   - The solves take one lane a right-hand side, so the 15 columns of P^T
//     run side by side, and the back substitution multiplies by the
//     reciprocals instead of dividing on the chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 15;                      // state dims
constexpr int kNN = kN * kN;
constexpr int kRowWidth = 47;               // rows_array: dt, z (15), mask (15), var (15), gate
constexpr int kZ = 1, kMask = 1 + kN, kVar = 1 + 2 * kN, kGate = 1 + 3 * kN;
constexpr int kMaxRows = 64;                // DualEkf.WINDOW_CAP; 21.5 KB of shared memory
constexpr int kMatrixThreads = kNN;         // one entry of a 15x15 product each
constexpr int kVectorWarp = 8;              // threads 256..287
constexpr int kThreads = (kVectorWarp + 1) * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBigVar = 1e12f;            // localization.BIG_VAR
constexpr float kMinVar = 1e-12f;

enum { X = 0, ROLL = 3, PITCH = 4, YAW = 5, VX = 6, WX = 9, AX = 12 };

// Shared memory: the fixed part (in floats), then the window's rows.
constexpr int kVec = 16;
constexpr int kFixed = 10 * kNN + 8 * kVec;

__device__ __forceinline__ float wrap_angle(float a) {
  const float pi = __int_as_float(0x40490fdb);      // float32(pi), as the reference rounds it
  const float two_pi = __int_as_float(0x40c90fdb);  // float32(2 pi)
  float m = fmodf(a + pi, two_pi);
  if (m != 0.f && ((two_pi < 0.f) != (m < 0.f))) m += two_pi;
  return m - pi;
}

__device__ __forceinline__ bool is_angle(int i) { return i >= ROLL && i <= YAW; }

// The row's variable entries of F (R dt, R dt^2 / 2, dt, G dt) from the
// current attitude, on one warp; the constant ones (identity, zeros) are set
// once. Each entry is _transition_jacobian's product of the same factors in
// the same order: R = a b c + d e and G = a b / c (localization._R_FACTORS,
// _G_FACTORS), a missing factor written as 1 or 0 as there. Lanes 0-2 take
// the sines and cosines, lanes 0-8 the entries of R, lanes 9-17 those of G
// (its three divisions side by side), lanes 18-20 dt.
__device__ void build_transition(float* F, const float* x, float dt, int lane) {
  float s = 0.f, c = 1.f;
  if (lane < 3) sincosf(x[ROLL + lane], &s, &c);
  const float sr = __shfl_sync(kFull, s, 0), cr = __shfl_sync(kFull, c, 0);
  const float sp = __shfl_sync(kFull, s, 1), cp = __shfl_sync(kFull, c, 1);
  const float sy = __shfl_sync(kFull, s, 2), cy = __shfl_sync(kFull, c, 2);
  const float nsr = -sr, nsp = -sp, nsy = -sy;
  const bool near = fabsf(cp) < 1e-6f;      // the gimbal guard
  const float cps = near ? 1e-6f : cp;
  if (lane < 9) {
    const float R = lane == 0 ? cy * cp * 1.f + 0.f * 0.f
                  : lane == 1 ? cy * sp * sr + nsy * cr
                  : lane == 2 ? cy * sp * cr + sy * sr
                  : lane == 3 ? sy * cp * 1.f + 0.f * 0.f
                  : lane == 4 ? sy * sp * sr + cy * cr
                  : lane == 5 ? sy * sp * cr + cy * nsr
                  : lane == 6 ? nsp * 1.f * 1.f + 0.f * 0.f
                  : lane == 7 ? cp * sr * 1.f + 0.f * 0.f
                              : cp * cr * 1.f + 0.f * 0.f;
    const int r = lane / 3, col = lane % 3;
    F[(X + r) * kN + VX + col] = R * dt;
    F[(X + r) * kN + AX + col] = R * (0.5f * dt * dt);
  } else if (lane < 18) {
    const int e = lane - 9;
    // one division a lane: tan(pitch) = sp / cp unless guarded, sr / cps and
    // cr / cps; a division by 1 is left out (it is exact)
    const bool tan = e == 1 || e == 2;
    const float q = (tan ? sp : (e == 7 ? sr : cr)) / (tan ? cp : cps);
    const float tp = near ? 0.f : q;
    const float G = e == 0 ? 1.f * 1.f
                  : e == 1 ? sr * tp
                  : e == 2 ? cr * tp
                  : e == 3 ? 0.f * 1.f
                  : e == 4 ? cr * 1.f
                  : e == 5 ? nsr * 1.f
                  : e == 6 ? 0.f * 1.f
                           : q;          // (sr 1) / cps, (cr 1) / cps
    const int r = e / 3, col = e % 3;
    F[(ROLL + r) * kN + WX + col] = G * dt;
  } else if (lane < 21) {
    F[(VX + lane - 18) * kN + AX + lane - 18] = dt;
  }
}

// Lanes < 15 of a warp: row ``lane`` of F x, once F is in place.
__device__ __forceinline__ float predicted(const float* F, const float* x, int lane) {
  float s = 0.f;
  if (lane < kN) {
#pragma unroll
    for (int k = 0; k < kN; ++k) s = s + F[lane * kN + k] * x[k];
  }
  return s;
}

// The predicted state x <- wrap(F x), and ``row``'s masked, wrapped
// innovation and Rd. Lanes < 15 of a warp, ``fx`` from ``predicted``.
__device__ __forceinline__ void measure(float fx, float* x, float* innov, float* Rd,
                                        const float* row, int lane) {
  if (lane < kN) {
    const float xi = is_angle(lane) ? wrap_angle(fx) : fx;
    x[lane] = xi;
    const bool measured = row[kMask + lane] > 0.5f;
    const float d = row[kZ + lane] - xi;
    innov[lane] = measured ? (is_angle(lane) ? wrap_angle(d) : d) : 0.f;
    const float v = row[kVar + lane];
    Rd[lane] = measured ? (v < kMinVar ? kMinVar : v) : kBigVar;
  }
}

// LU with partial pivoting of one 15x15 matrix on one warp. Lane i < 15
// holds row i in ``a``; a row swap trades two lanes' positions. The column
// below a pivot is scaled by the pivot's reciprocal, as LAPACK's getf2
// does; every lane takes the reciprocal of its own entry while the pivot is
// sought, so the division overlaps the search. On return LU[p] holds the
// factors of position p (L below the unit diagonal, U on and above it),
// perm[p] the row that moved there and rinv[p] 1 / U[p][p].
__device__ __forceinline__ void lu_factor(float (&a)[kN], int lane, float* LU, int* perm,
                                          float* rinv) {
  const bool live = lane < kN;
  int pos = lane;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const bool cand = live && pos >= k;
    // correctly rounded, as 1 / a; a zero, or a lane out of the search, takes
    // 1 / 1 instead (1 / 0 is the reciprocal's slow path, ~300 cycles for the
    // whole warp; a zero pivot then leaves its column unscaled, as getf2 does)
    const float own_rcp = __frcp_rn(cand && a[k] != 0.f ? a[k] : 1.f);
    // the pivot: the first largest |a| of column k at positions >= k (the
    // bits of a non-negative float order as the float does)
    const unsigned key = cand ? __float_as_uint(fabsf(a[k])) + 1u : 0u;
    const unsigned top = __reduce_max_sync(kFull, key);
    const unsigned pick =
        __reduce_min_sync(kFull, cand && key == top ? (unsigned)(pos << 5 | lane) : ~0u);
    const int plane = pick & 31, p = pick >> 5;
    if (pos == k) pos = p;                  // rows k and p swap positions
    else if (pos == p) pos = k;
    const float rcp = __shfl_sync(kFull, own_rcp, plane);
    if (lane == 0) rinv[k] = rcp;
    float u[kN];
#pragma unroll
    for (int j = k + 1; j < kN; ++j) u[j] = __shfl_sync(kFull, a[j], plane);
    if (live && pos > k) {
      const float l = a[k] * rcp;
      a[k] = l;
#pragma unroll
      for (int j = k + 1; j < kN; ++j) a[j] = a[j] - l * u[j];
    }
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < kN; ++c) LU[pos * kN + c] = a[c];
    perm[pos] = lane;
  }
  __syncwarp();
}

// One right-hand side, already permuted (b[p] = rhs[perm[p]]), solved in
// place with lu_factor's factors: getrs' forward and back substitution, in
// its order of operations, the back substitution's divisions by U's
// diagonal taken as products with its reciprocals.
__device__ __forceinline__ void lu_substitute(const float* LU, const float* rinv,
                                              float (&b)[kN]) {
#pragma unroll
  for (int k = 0; k < kN - 1; ++k) {
#pragma unroll
    for (int i = k + 1; i < kN; ++i) b[i] = b[i] - LU[i * kN + k] * b[k];
  }
#pragma unroll
  for (int k = kN - 1; k >= 0; --k) {
    b[k] = b[k] * rinv[k];
#pragma unroll
    for (int i = 0; i < k; ++i) b[i] = b[i] - b[k] * LU[i * kN + k];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    ekf_window_kernel(float* __restrict__ gx, float* __restrict__ gP,
                      const float* __restrict__ gQ, const float* __restrict__ grows, int T) {
  extern __shared__ float smem[];
  float* P = smem;                  // the filter's covariance
  float* Q = P + kNN;
  float* F = Q + kNN;               // the row's transition Jacobian
  float* W = F + kNN;               // F P, then (I - K) P
  float* Y = W + kNN;               // S^-T P^T
  float* K = Y + kNN;
  float* IKH = K + kNN;             // I - K
  float* KRd = IKH + kNN;           // K diag(Rd)
  float* LU_S = KRd + kNN;          // S's factors
  float* LU_T = LU_S + kNN;         // S^T's factors
  float* x = LU_T + kNN;            // the filter's state
  float* innov = x + kVec;
  float* Rd = innov + kVec;
  float* rinv_S = Rd + kVec;
  float* rinv_T = rinv_S + kVec;
  float* flags = rinv_T + kVec;     // flags[0]: the row accepted, as 0 or 1
  int* perm_S = reinterpret_cast<int*>(flags + kVec);
  int* perm_T = perm_S + kVec;
  float* rows = smem + kFixed;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid / kN, j = tid % kN;   // the product entry of tid < 225
  for (int t = tid; t < T * kRowWidth; t += kThreads) rows[t] = grows[t];
  for (int t = tid; t < kNN; t += kThreads) {
    P[t] = gP[t];
    Q[t] = gQ[t];
    F[t] = (t / kN == t % kN) ? 1.f : 0.f;
  }
  if (tid < kN) x[tid] = gx[tid];
  __syncthreads();
  float fx = 0.f;                   // the vector warp's F x for the next row
  if (warp == kVectorWarp) {
    build_transition(F, x, rows[0], lane);
    __syncwarp();
    fx = predicted(F, x, lane);
  }
  __syncthreads();

  for (int r = 0; r < T; ++r) {
    const float* row = rows + r * kRowWidth;
    const float dt = row[0];
    const bool next = r + 1 < T;
    // -- F P; x <- wrap(F x), the innovation and Rd ---------------------------
    if (tid < kMatrixThreads) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kN; ++k) s = s + F[i * kN + k] * P[k * kN + j];
      W[tid] = s;
    } else if (warp == kVectorWarp) {
      measure(fx, x, innov, Rd, row, lane);
    }
    __syncthreads();
    // -- P <- (F P) F^T + Q max(dt, 0) -----------------------------------------
    if (tid < kMatrixThreads) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kN; ++k) s = s + W[i * kN + k] * F[j * kN + k];
      const float dtc = dt < 0.f ? 0.f : dt;     // clamp_min: NaN stays NaN
      P[tid] = s + Q[tid] * dtc;
    }
    __syncthreads();
    // -- S = P + diag(Rd): S sol = innov on warp 0, S^T Y = P^T on warp 1 ------
    if (warp == 0) {
      float a[kN];
      const int li = lane < kN ? lane : 0;
#pragma unroll
      for (int c = 0; c < kN; ++c)
        a[c] = lane < kN ? P[li * kN + c] + (c == lane ? Rd[li] : 0.f) : 0.f;
      lu_factor(a, lane, LU_S, perm_S, rinv_S);
      if (lane == 0) {
        float b[kN];
#pragma unroll
        for (int p = 0; p < kN; ++p) b[p] = innov[perm_S[p]];
        lu_substitute(LU_S, rinv_S, b);
        float m2 = 0.f;                        // the Mahalanobis distance, squared
#pragma unroll
        for (int k = 0; k < kN; ++k) m2 = m2 + innov[k] * b[k];
        const float gate = row[kGate];
        flags[0] = (gate <= 0.f || m2 <= gate * gate) ? 1.f : 0.f;
      }
    } else if (warp == 1) {
      float a[kN];
      const int li = lane < kN ? lane : 0;
#pragma unroll
      for (int c = 0; c < kN; ++c)
        a[c] = lane < kN ? P[c * kN + li] + (c == lane ? Rd[li] : 0.f) : 0.f;
      lu_factor(a, lane, LU_T, perm_T, rinv_T);
      if (lane < kN) {                         // lane c solves column c of P^T
        float b[kN];
#pragma unroll
        for (int p = 0; p < kN; ++p) b[p] = P[lane * kN + perm_T[p]];
        lu_substitute(LU_T, rinv_T, b);
#pragma unroll
        for (int p = 0; p < kN; ++p) Y[p * kN + lane] = b[p];
      }
    }
    __syncthreads();
    // -- K = Y^T accepted, I - K, K diag(Rd); x <- wrap(x + K innov) -----------
    const float accepted = flags[0];
    if (tid < kMatrixThreads) {
      const float k = Y[j * kN + i] * accepted;
      K[tid] = k;
      IKH[tid] = (i == j ? 1.f : 0.f) - k;
      KRd[tid] = k * Rd[j];
    } else if (warp == kVectorWarp && lane < kN) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kN; ++k) s = s + (Y[k * kN + lane] * accepted) * innov[k];
      const float v = x[lane] + s;
      x[lane] = is_angle(lane) ? wrap_angle(v) : v;
    }
    __syncthreads();
    // -- (I - K) P and (K Rd) K^T; the next row's F ----------------------------
    float c = 0.f;
    if (tid < kMatrixThreads) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kN; ++k) s = s + IKH[i * kN + k] * P[k * kN + j];
      W[tid] = s;
#pragma unroll
      for (int k = 0; k < kN; ++k) c = c + KRd[i * kN + k] * K[j * kN + k];
    } else if (warp == kVectorWarp && next) {
      build_transition(F, x, row[kRowWidth], lane);
    }
    __syncthreads();
    // -- P <- ((I - K) P)(I - K)^T + (K Rd) K^T; the next row's F x ------------
    if (tid < kMatrixThreads) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kN; ++k) s = s + W[i * kN + k] * IKH[j * kN + k];
      P[tid] = s + c;
    } else if (warp == kVectorWarp && next) {
      fx = predicted(F, x, lane);
    }
    __syncthreads();
  }
  for (int t = tid; t < kNN; t += kThreads) gP[t] = P[t];
  if (tid < kN) gx[tid] = x[tid];
}

}  // namespace

// Fuses rows (T x 47 float32, rows_array's layout) into x (15) and P (15 x
// 15) in place, with process noise Q (15 x 15). One block on ``stream``;
// returns -2 for a T outside [1, kMaxRows], else the launch's CUDA error.
extern "C" int fitslam_ekf_window(float* x, float* P, const float* Q, const float* rows, int T,
                                  cudaStream_t stream) {
  if (T < 1 || T > kMaxRows) return -2;
  const size_t smem = sizeof(float) * ((size_t)kFixed + (size_t)T * kRowWidth);
  ekf_window_kernel<<<1, kThreads, smem, stream>>>(x, P, Q, rows, T);
  return (int)cudaGetLastError();
}
