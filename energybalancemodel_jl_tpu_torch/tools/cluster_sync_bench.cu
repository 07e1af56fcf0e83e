// The cost of one barrier phase of a thread-block cluster on the card, the
// quantity that bounds the cluster builds of the year kernels (csrc/
// cluster.cuh): a loop of N phases per kernel, timed with CUDA events, for
// cluster sizes 1-16 and 96 or 384 threads per block. Each phase is
//   sync       one cluster barrier (cooperative_groups cluster.sync(),
//              barrier.cluster arrive.release / wait.acquire),
//   relaxed    the cluster barrier without its memory ordering
//              (arrive.relaxed: the barrier alone, no fence; not enough to
//              exchange data),
//   syncthreads one block barrier,
//   exchange   a shared-memory store, the barrier, a load of the next rank's
//              value through distributed shared memory and a division (the
//              shape of one PCR level), with the cluster barrier, and with
//              the block barrier and a local load for comparison.
// Built and run by tools/kernel_times.py barriers; prints one line per case.
#include <cooperative_groups.h>

#include <cstdio>

namespace cg = cooperative_groups;

enum Mode { SYNC, RELAXED, SYNCTHREADS, EXCHANGE, EXCHANGE_LOCAL };

template <int MODE>
__global__ void phases(int iters, float* out) {
  __shared__ float buf[2][1024];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), C = (int)cl.num_blocks();
  float acc = threadIdx.x;
  for (int it = 0; it < iters; ++it) {
    float* cur = buf[it & 1];
    if (MODE == EXCHANGE || MODE == EXCHANGE_LOCAL) cur[threadIdx.x] = acc;
    if (MODE == SYNC || MODE == EXCHANGE)
      cl.sync();
    else if (MODE == RELAXED)
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\tbarrier.cluster.wait.aligned;" :::
                   "memory");
    else
      __syncthreads();
    if (MODE == EXCHANGE) {
      const float* r = cl.map_shared_rank(cur, (rank + 1) % C);
      acc = acc * 0.5f + r[(threadIdx.x + 1) % blockDim.x] / (acc + 1.0f);
    } else if (MODE == EXCHANGE_LOCAL) {
      acc = acc * 0.5f + cur[(threadIdx.x + 1) % blockDim.x] / (acc + 1.0f);
    }
  }
  cl.sync();
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

template <int MODE>
void run(int C, int threads, const char* name) {
  float* out;
  cudaMalloc(&out, 16 * 1024 * sizeof(float));
  auto kernel = phases<MODE>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const int iters = 20000;
  cudaLaunchKernelEx(&cfg, kernel, iters, out);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  cudaLaunchKernelEx(&cfg, kernel, iters, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  printf("{\"case\": \"%s\", \"C\": %d, \"threads\": %d, \"ns_per_phase\": %.1f, \"error\": \"%s\"}\n",
         name, C, threads, ms * 1e6 / iters, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  for (int C : {1, 2, 4, 8, 16})
    for (int threads : {96, 384}) {
      run<SYNC>(C, threads, "sync");
      run<RELAXED>(C, threads, "relaxed");
      run<SYNCTHREADS>(C, threads, "syncthreads");
      run<EXCHANGE>(C, threads, "exchange");
      run<EXCHANGE_LOCAL>(C, threads, "exchange_local");
    }
  return 0;
}
