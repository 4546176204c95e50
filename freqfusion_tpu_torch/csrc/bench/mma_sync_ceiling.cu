// The rate of mma.sync m16n8k8 TF32 products on the card, alone: the
// ceiling of the kernels that run their products through it (window
// attention, the fused FFN, the CAB convolutions), as opposed to the
// card's dense TF32 peak (495 TFLOP/s on an H100 SXM, which only wgmma
// reaches). Each warp runs `chains` independent accumulators over the same
// operands, so nothing but the tensor pipe and its latency paces it.
//
// Not part of the package's build (csrc/bench is not compiled by
// ops/cuda.py). Run on the card, from the repository root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_sync_ceiling \
//       freqfusion_tpu_torch/csrc/bench/mma_sync_ceiling.cu
//   build/mma_sync_ceiling

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int CHAINS>
__global__ void products(float* out, int iters) {
  float c[CHAINS][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  const uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) mma_tf32(c[j], a, b0, b1);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CHAINS>
void run(int sms, int warps) {
  float* out;
  cudaMalloc(&out, size_t(sms) * warps * 32 * sizeof(float));
  const int iters = 4096;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  products<CHAINS><<<sms, warps * 32>>>(out, iters);  // warm-up
  cudaEventRecord(e0);
  products<CHAINS><<<sms, warps * 32>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2.0 * 16 * 8 * 8 * CHAINS * double(iters) * warps * sms;
  printf("%2d chains a warp, %2d warps an SM: %.1f TFLOP/s (%s)\n", CHAINS,
         warps, flop / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int sms = prop.multiProcessorCount;
  run<1>(sms, 8);
  run<4>(sms, 4);
  run<4>(sms, 8);
  run<8>(sms, 8);
  run<8>(sms, 16);
  return 0;
}
