// Fused SPADE norm -> modulate epilogue, forward, for Hopper (sm_90a).
//
//   out = (x - mean) * rstd * (1 + sum_i gamma_i) + sum_i beta_i
//
// with per-(sample, channel) spatial statistics: mean, biased variance
// from a centred second pass (the arithmetic of jnp.var, which the JAX
// package's main path uses), rstd = 1 / sqrt(var + eps). All arithmetic
// is fp32; the output is cast once to the input type.
//
// Replaces: imaginaire_tpu/ops/pallas/spade_modulation_kernel.py,
// spade_modulation_fwd_pallas (_stats_kernel + _apply_kernel). The
// Pallas stats pass carries its accumulators across a sequential grid,
// which Hopper does not have. Here the tensors are NCHW-contiguous, so
// each (b, c) plane is one contiguous run of H*W elements and one
// thread block owns it: it reduces the plane to its mean (warp shuffles,
// then one float per warp in shared memory), reduces it again, centred,
// to its variance, and applies the modulation, so no statistic ever
// leaves the block and norm(x), sum(gamma) and sum(beta) are never
// written to device memory.
//
// Bound: device-memory bytes. Per call the least traffic is x, every
// gamma_i and beta_i read once and out written once, i.e.
// (2 + 2 * n_pairs) * B*C*H*W elements, against ~(4 + 2 * n_pairs) flops
// per element: far below the card's operations-per-byte balance. What
// the design does about it: a plane of up to SPADE_CACHE_ELEMS elements
// (every plane of the 256x256 generator: 16x16 .. 128x128) is kept in
// shared memory as fp32 while the block reduces it, so x is read from
// device memory exactly once and the kernel moves the least traffic;
// larger planes are re-read for the second and third passes (from L2
// when it still holds them). Loads and stores are coalesced, one
// element per thread per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SPADE_MAX_PAIRS 4
#define SPADE_THREADS 512
#define SPADE_CACHE_ELEMS 16384  // 64 KiB of fp32 shared memory per block

struct PairPtrs {
  const void* gamma[SPADE_MAX_PAIRS];
  const void* beta[SPADE_MAX_PAIRS];
};

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Sum of v over the block, returned to every thread. blockDim.x is a
// multiple of 32 and at most 1024; scratch holds one float per warp.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? scratch[lane] : 0.f;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // scratch is reused by the next call
  return v;
}

template <typename T, bool kCache>
__global__ void __launch_bounds__(SPADE_THREADS)
spade_modulation_kernel(const T* __restrict__ x, PairPtrs pairs, int n_pairs,
                        T* __restrict__ out, int64_t plane, float inv_plane,
                        float eps) {
  extern __shared__ float cache[];  // plane floats when kCache
  __shared__ float scratch[32];
  const int64_t base = (int64_t)blockIdx.x * plane;
  const T* xp = x + base;

  // Each thread only ever touches the elements i = threadIdx.x (mod
  // blockDim.x), so the cache needs no barrier of its own.
  float s = 0.f;
  for (int64_t i = threadIdx.x; i < plane; i += blockDim.x) {
    const float v = load_f(xp, i);
    if (kCache) cache[i] = v;
    s += v;
  }
  const float mean = block_sum(s, scratch) * inv_plane;

  float ss = 0.f;
  for (int64_t i = threadIdx.x; i < plane; i += blockDim.x) {
    const float d = (kCache ? cache[i] : load_f(xp, i)) - mean;
    ss += d * d;
  }
  const float var = block_sum(ss, scratch) * inv_plane;
  const float rstd = 1.f / sqrtf(var + eps);

  T* op = out + base;
  for (int64_t i = threadIdx.x; i < plane; i += blockDim.x) {
    const float xhat = ((kCache ? cache[i] : load_f(xp, i)) - mean) * rstd;
    float g = 1.f;
    float b = 0.f;
#pragma unroll
    for (int k = 0; k < SPADE_MAX_PAIRS; ++k) {
      if (k < n_pairs) {
        g += load_f(static_cast<const T*>(pairs.gamma[k]) + base, i);
        b += load_f(static_cast<const T*>(pairs.beta[k]) + base, i);
      }
    }
    store_f(op, i, xhat * g + b);
  }
}

template <typename T>
static cudaError_t launch(const void* x, const PairPtrs& pairs, int n_pairs,
                          void* out, long long n_planes, long long plane,
                          float eps, cudaStream_t stream) {
  int threads = SPADE_THREADS;
  if (plane < SPADE_THREADS) threads = (int)((plane + 31) / 32) * 32;
  const dim3 grid((unsigned)n_planes);
  const float inv_plane = 1.f / (float)plane;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (plane <= SPADE_CACHE_ELEMS) {
    const size_t smem = (size_t)plane * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        spade_modulation_kernel<T, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(SPADE_CACHE_ELEMS * sizeof(float)));
    if (err != cudaSuccess) return err;
    spade_modulation_kernel<T, true><<<grid, threads, smem, stream>>>(
        xt, pairs, n_pairs, ot, plane, inv_plane, eps);
  } else {
    spade_modulation_kernel<T, false><<<grid, threads, 0, stream>>>(
        xt, pairs, n_pairs, ot, plane, inv_plane, eps);
  }
  return cudaGetLastError();
}

extern "C" {

// x, gammas[k], betas[k] and out: NCHW-contiguous tensors of one type
// (dtype 0 = float32, 1 = bfloat16) with n_planes = B*C planes of
// plane = H*W elements. Launches on `stream` and returns the CUDA error
// code of the launch (0 on success); it does not synchronise.
int spade_modulation_fwd(const void* x, const void* const* gammas,
                         const void* const* betas, int n_pairs, void* out,
                         long long n_planes, long long plane, float eps,
                         int dtype, void* stream) {
  if (n_pairs < 1 || n_pairs > SPADE_MAX_PAIRS || n_planes < 1 ||
      n_planes > 0x7fffffffLL || plane < 1) {
    return (int)cudaErrorInvalidValue;
  }
  PairPtrs pairs = {};
  for (int k = 0; k < n_pairs; ++k) {
    pairs.gamma[k] = gammas[k];
    pairs.beta[k] = betas[k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, pairs, n_pairs, out, n_planes, plane, eps, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, pairs, n_pairs, out, n_planes, plane, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* spade_modulation_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
