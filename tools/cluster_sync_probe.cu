// Latency of the synchronisation patterns a resident stencil kernel can use
// between sweeps, inside one thread-block cluster on Hopper. Not part of the
// port's path: it is the measurement behind the K3 design
// (csrc/wavefront_sweep.cu). Build and run on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o build/cluster_sync_probe tools/cluster_sync_probe.cu
//   ./build/cluster_sync_probe
//
// Each line is ns per iteration of one pattern (20000 iterations, 10 launches):
//   mode 0  __syncthreads (one block)
//   mode 1  barrier.cluster arrive.release + wait.acquire
//   mode 2  barrier.cluster arrive.relaxed + wait (no ordering of the data)
//   mode 3  mode 1 after a store into the next block's shared memory
//   mode 4  remote stores, then one remote mbarrier arrive.release.cluster per
//           neighbour, and a wait on the local mbarrier
//   mode 5  st.async into both neighbours' shared memory completing their
//           mbarriers (complete_tx), expect_tx and a wait on the local one,
//           then __syncthreads: the pattern K3's resident kernel uses
#include <cooperative_groups.h>
#include <cstdio>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ void arrive_rel() { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wait_acq() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void arrive_rlx() { asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wait_plain() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

template <int MODE>
__global__ void bench(int iters, float* out) {
  __shared__ float buf[2][1024];
  __shared__ __align__(8) unsigned long long mbar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank(), nb = cluster.num_blocks();
  float v = threadIdx.x;
  if (MODE >= 4) {
    if (threadIdx.x == 0) {
      int cnt = MODE == 5 ? 1 : (rank > 0) + (rank < nb - 1);
      for (int p = 0; p < 2; ++p) {
        unsigned a = (unsigned)__cvta_generic_to_shared(&mbar[p]);
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(a), "r"(cnt > 0 ? cnt : 1));
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster.sync();
  }
  for (int s = 0; s < iters; ++s) {
    const int p = s & 1;
    buf[p][threadIdx.x] = v;
    if (MODE == 0) {
      __syncthreads();
    } else if (MODE == 1) {
      arrive_rel();
      wait_acq();
    } else if (MODE == 2) {
      arrive_rlx();
      wait_plain();
    } else if (MODE == 3) {
      if (rank + 1 < nb) cluster.map_shared_rank(&buf[p][0], rank + 1)[threadIdx.x] = v;
      arrive_rel();
      wait_acq();
    } else if (MODE == 4) {
      if (rank + 1 < nb) cluster.map_shared_rank(&buf[p][0], rank + 1)[threadIdx.x] = v;
      if (rank > 0) cluster.map_shared_rank(&buf[p][0], rank - 1)[threadIdx.x] = v;
      __syncthreads();
      if (threadIdx.x == 0) {
        unsigned a = (unsigned)__cvta_generic_to_shared(&mbar[p]);
        for (int d = -1; d <= 1; d += 2) {
          int r = rank + d;
          if (r < 0 || r >= nb) continue;
          unsigned ra;
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(a), "r"(r));
          asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" :: "r"(ra) : "memory");
        }
      }
      if (nb > 1) {
        unsigned a = (unsigned)__cvta_generic_to_shared(&mbar[p]);
        unsigned phase = (s >> 1) & 1;
        asm volatile("{\n .reg .pred P;\n W: mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P, [%0], %1;\n @!P bra W;\n}\n" :: "r"(a), "r"(phase) : "memory");
      }
      __syncthreads();
    }
    else if (MODE == 5) {
      unsigned a = (unsigned)__cvta_generic_to_shared(&mbar[p]);
      unsigned la = (unsigned)__cvta_generic_to_shared(&buf[p][threadIdx.x]);
      for (int d = -1; d <= 1; d += 2) {
        int r = rank + d;
        if (r < 0 || r >= nb) continue;
        unsigned ra, rb;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(a), "r"(r));
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(la + 4096 * 0), "r"(r));
        asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" :: "r"(rb), "r"(__float_as_uint(v)), "r"(ra) : "memory");
      }
      if (threadIdx.x == 0) {
        int bytes = ((rank > 0) + (rank < nb - 1)) * blockDim.x * 4;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(a), "r"(bytes) : "memory");
      }
      unsigned phase = (s >> 1) & 1;
      asm volatile("{\n .reg .pred P;\n W: mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n @!P bra W;\n}\n" :: "r"(a), "r"(phase) : "memory");
      __syncthreads();
    }
    v = v * 0.5f + buf[p][(threadIdx.x + 1) % blockDim.x];
  }
  if (MODE >= 3) cluster.sync();
  out[blockIdx.x * blockDim.x + threadIdx.x] = v;
}

template <int MODE>
float run(int blocks, int threads, int iters, float* out) {
  auto k = bench<MODE>;
  cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = -1;
  cudaOccupancyMaxActiveClusters(&active, k, &cfg);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaLaunchKernelEx(&cfg, k, iters, out);
  cudaEventRecord(a);
  for (int r = 0; r < 10; ++r) cudaLaunchKernelEx(&cfg, k, iters, out);
  cudaEventRecord(b);
  cudaError_t e = cudaDeviceSynchronize();
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  printf("mode %d blocks %2d threads %4d: %.1f ns/iter (active clusters %d, %s)\n", MODE, blocks,
         threads, ms * 1e6 / 10 / iters, active, cudaGetErrorString(e));
  return ms;
}

int main() {
  float* out;
  cudaMalloc(&out, 16 * 1024 * sizeof(float));
  const int iters = 20000;
  for (int threads : {256, 512}) {
    run<0>(1, threads, iters, out);
    run<1>(1, threads, iters, out);
    run<2>(1, threads, iters, out);
    for (int nb : {2, 8, 16}) {
      run<1>(nb, threads, iters, out);
      run<2>(nb, threads, iters, out);
      run<3>(nb, threads, iters, out);
      run<4>(nb, threads, iters, out);
      run<5>(nb, threads, iters, out);
    }
  }
  return 0;
}
