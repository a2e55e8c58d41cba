// Fused SPADE norm -> modulate epilogue for Hopper (sm_90a): forward and
// backward.
//
//   out = (x - mean) * rstd * (1 + sum_i gamma_i) + sum_i beta_i
//
// with per-(sample, channel) spatial statistics: mean, biased variance
// from a centred second pass (the arithmetic of jnp.var, which the JAX
// package's main path uses), rstd = 1 / sqrt(var + eps). The forward
// writes mean and rstd (fp32, one of each a plane) beside out: they are
// the backward's only residuals besides x and the gammas.
//
// Rounding. In fp32 all arithmetic is fp32. In bf16 the forward rounds
// where the JAX package's _apply (imaginaire_tpu/ops/spade_modulation.py)
// does: x_hat = (x - mean) * rstd is computed in fp32 and rounded to
// bf16; sum gamma is summed left to right in bf16; 1 + sum gamma is
// formed in bf16; the product is taken in bf16; sum beta is summed in
// bf16; the final add is done in bf16. Each bf16 operation is an fp32
// operation on bf16 values rounded to nearest even, as PyTorch's bf16
// elementwise ops are, so given the same statistics the kernel's output
// is the plain composition's bit for bit. The backward computes in fp32
// and rounds each output once, as _fused_bwd does.
//
// Replaces: imaginaire_tpu/ops/pallas/spade_modulation_kernel.py,
// spade_modulation_fwd_pallas (_stats_kernel + _apply_kernel), and the
// jnp backward _fused_bwd of imaginaire_tpu/ops/spade_modulation.py. The
// Pallas stats pass carries its accumulators across a sequential grid,
// which Hopper does not have. Here the tensors are NCHW-contiguous, so
// each (b, c) plane is one contiguous run of H*W elements and one
// thread block owns it: it reduces the plane (warp shuffles, then one
// float per warp in shared memory) and applies the result, so no
// statistic ever leaves the block except mean and rstd.
//
// Bound: device-memory bytes. The forward's least traffic is x, every
// gamma_i and beta_i read once and out written once, (2 + 2 n_pairs)
// elements an element of x; the backward's is x, g and every gamma_i
// read and dx and dgamma written, (4 + n_pairs) elements. Both do a
// handful of flops an element, far below the card's operations-per-byte
// balance. What the design does about it: a plane of up to
// SPADE_CACHE_ELEMS elements (every plane of the 256x256 generator:
// 16x16 .. 128x128) is kept in shared memory as fp32 while the block
// reduces it (the forward caches x; the backward caches x_hat and
// g (1 + sum gamma)), so each input is read from device memory exactly
// once; larger planes are re-read for the later passes (from L2 when it
// still holds them). Loads and stores are coalesced, one element per
// thread per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SPADE_MAX_PAIRS 4
#define SPADE_THREADS 512
#define SPADE_CACHE_ELEMS 16384  // 64 KiB of fp32 a cached array

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
// v rounded to bf16 (nearest even) and widened back to fp32
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// The modulate half of one element, given x_hat in fp32.
template <typename T>
struct Combine;

template <>
struct Combine<float> {
  static __device__ __forceinline__ float apply(
      float xhat, const PairPtrs& pairs, int n_pairs, int64_t i) {
    float g = 1.f;
    float b = 0.f;
#pragma unroll
    for (int k = 0; k < SPADE_MAX_PAIRS; ++k) {
      if (k < n_pairs) {
        g += load_f(static_cast<const float*>(pairs.gamma[k]), i);
        b += load_f(static_cast<const float*>(pairs.beta[k]), i);
      }
    }
    return xhat * g + b;
  }
};

template <>
struct Combine<__nv_bfloat16> {
  // each step an fp32 operation on bf16 values, rounded to bf16; the
  // separate roundings also keep the compiler from contracting the
  // product and the add into one fused multiply-add
  static __device__ __forceinline__ float apply(
      float xhat, const PairPtrs& pairs, int n_pairs, int64_t i) {
    const float y = round_bf16(xhat);
    float gs = load_f(static_cast<const __nv_bfloat16*>(pairs.gamma[0]), i);
    float bs = load_f(static_cast<const __nv_bfloat16*>(pairs.beta[0]), i);
#pragma unroll
    for (int k = 1; k < SPADE_MAX_PAIRS; ++k) {
      if (k < n_pairs) {
        gs = round_bf16(gs + load_f(static_cast<const __nv_bfloat16*>(pairs.gamma[k]), i));
        bs = round_bf16(bs + load_f(static_cast<const __nv_bfloat16*>(pairs.beta[k]), i));
      }
    }
    const float prod = round_bf16(y * round_bf16(1.f + gs));
    return prod + bs;  // rounded by the bf16 store
  }
};

template <typename T, bool kCache>
__global__ void __launch_bounds__(SPADE_THREADS)
spade_modulation_kernel(const T* __restrict__ x, PairPtrs pairs, int n_pairs,
                        T* __restrict__ out, float* __restrict__ mean_out,
                        float* __restrict__ rstd_out, int64_t plane,
                        float inv_plane, float eps) {
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
  if (threadIdx.x == 0) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = rstd;
  }

  PairPtrs plane_pairs = pairs;
#pragma unroll
  for (int k = 0; k < SPADE_MAX_PAIRS; ++k) {
    if (k < n_pairs) {
      plane_pairs.gamma[k] = static_cast<const T*>(pairs.gamma[k]) + base;
      plane_pairs.beta[k] = static_cast<const T*>(pairs.beta[k]) + base;
    }
  }
  T* op = out + base;
  for (int64_t i = threadIdx.x; i < plane; i += blockDim.x) {
    const float xhat = ((kCache ? cache[i] : load_f(xp, i)) - mean) * rstd;
    store_f(op, i, Combine<T>::apply(xhat, plane_pairs, n_pairs, i));
  }
}

// Backward of one plane: with g_hat = g (1 + sum gamma) (fp32),
//   dx     = rstd (g_hat - mean(g_hat) - x_hat mean(g_hat x_hat))
//   dgamma = g x_hat  (the one gradient of every gamma_i)
// both spatial means reduced in fp32 inside the block. Where the terms
// of dx cancel, its value carries the rounding of the two means, which
// the block sums in another order than PyTorch does.
template <typename T, bool kCache>
__global__ void __launch_bounds__(SPADE_THREADS)
spade_modulation_bwd_kernel(const T* __restrict__ x, PairPtrs pairs,
                            int n_pairs, const float* __restrict__ mean_in,
                            const float* __restrict__ rstd_in,
                            const T* __restrict__ g, T* __restrict__ dx,
                            T* __restrict__ dgamma, int64_t plane,
                            float inv_plane) {
  extern __shared__ float cache[];  // 2 * plane floats when kCache
  __shared__ float scratch[32];
  float* xhat_c = cache;
  float* ghat_c = cache + plane;
  const int64_t base = (int64_t)blockIdx.x * plane;
  const float mean = mean_in[blockIdx.x];
  const float rstd = rstd_in[blockIdx.x];
  const T* xp = x + base;
  const T* gp = g + base;
  const T* gam[SPADE_MAX_PAIRS];
#pragma unroll
  for (int k = 0; k < SPADE_MAX_PAIRS; ++k) {
    gam[k] = k < n_pairs ? static_cast<const T*>(pairs.gamma[k]) + base : nullptr;
  }

  float s1 = 0.f;
  float s2 = 0.f;
  T* dgp = dgamma + base;
  for (int64_t i = threadIdx.x; i < plane; i += blockDim.x) {
    const float xhat = (load_f(xp, i) - mean) * rstd;
    const float gv = load_f(gp, i);
    float gs = 1.f;
#pragma unroll
    for (int k = 0; k < SPADE_MAX_PAIRS; ++k) {
      if (k < n_pairs) gs += load_f(gam[k], i);
    }
    const float ghat = gv * gs;
    if (kCache) {
      xhat_c[i] = xhat;
      ghat_c[i] = ghat;
    }
    s1 += ghat;
    s2 += __fmul_rn(ghat, xhat);
    store_f(dgp, i, gv * xhat);
  }
  const float m1 = block_sum(s1, scratch) * inv_plane;
  const float m2 = block_sum(s2, scratch) * inv_plane;

  T* dxp = dx + base;
  for (int64_t i = threadIdx.x; i < plane; i += blockDim.x) {
    float xhat, ghat;
    if (kCache) {
      xhat = xhat_c[i];
      ghat = ghat_c[i];
    } else {
      xhat = (load_f(xp, i) - mean) * rstd;
      float gs = 1.f;
#pragma unroll
      for (int k = 0; k < SPADE_MAX_PAIRS; ++k) {
        if (k < n_pairs) gs += load_f(gam[k], i);
      }
      ghat = load_f(gp, i) * gs;
    }
    // the plain version's operations in its order, none contracted
    const float t = __fsub_rn(__fsub_rn(ghat, m1), __fmul_rn(xhat, m2));
    store_f(dxp, i, __fmul_rn(rstd, t));
  }
}

static int threads_for(long long plane) {
  if (plane < SPADE_THREADS) return (int)((plane + 31) / 32) * 32;
  return SPADE_THREADS;
}

template <typename T>
static cudaError_t launch_fwd(const void* x, const PairPtrs& pairs, int n_pairs,
                              void* out, float* mean, float* rstd,
                              long long n_planes, long long plane, float eps,
                              cudaStream_t stream) {
  const int threads = threads_for(plane);
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
        xt, pairs, n_pairs, ot, mean, rstd, plane, inv_plane, eps);
  } else {
    spade_modulation_kernel<T, false><<<grid, threads, 0, stream>>>(
        xt, pairs, n_pairs, ot, mean, rstd, plane, inv_plane, eps);
  }
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_bwd(const void* x, const PairPtrs& pairs, int n_pairs,
                              const float* mean, const float* rstd,
                              const void* g, void* dx, void* dgamma,
                              long long n_planes, long long plane,
                              cudaStream_t stream) {
  const int threads = threads_for(plane);
  const dim3 grid((unsigned)n_planes);
  const float inv_plane = 1.f / (float)plane;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  T* dgt = static_cast<T*>(dgamma);
  if (plane <= SPADE_CACHE_ELEMS) {
    const size_t smem = 2 * (size_t)plane * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        spade_modulation_bwd_kernel<T, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(2 * SPADE_CACHE_ELEMS * sizeof(float)));
    if (err != cudaSuccess) return err;
    spade_modulation_bwd_kernel<T, true><<<grid, threads, smem, stream>>>(
        xt, pairs, n_pairs, mean, rstd, gt, dxt, dgt, plane, inv_plane);
  } else {
    spade_modulation_bwd_kernel<T, false><<<grid, threads, 0, stream>>>(
        xt, pairs, n_pairs, mean, rstd, gt, dxt, dgt, plane, inv_plane);
  }
  return cudaGetLastError();
}

static bool args_ok(int n_pairs, long long n_planes, long long plane) {
  return n_pairs >= 1 && n_pairs <= SPADE_MAX_PAIRS && n_planes >= 1 &&
         n_planes <= 0x7fffffffLL && plane >= 1;
}

extern "C" {

// x, gammas[k], betas[k] and out: NCHW-contiguous tensors of one type
// (dtype 0 = float32, 1 = bfloat16) with n_planes = B*C planes of
// plane = H*W elements; mean and rstd: n_planes floats each, written.
// Launches on `stream` and returns the CUDA error code of the launch (0
// on success); it does not synchronise.
int spade_modulation_fwd(const void* x, const void* const* gammas,
                         const void* const* betas, int n_pairs, void* out,
                         float* mean, float* rstd, long long n_planes,
                         long long plane, float eps, int dtype, void* stream) {
  if (!args_ok(n_pairs, n_planes, plane)) return (int)cudaErrorInvalidValue;
  PairPtrs pairs = {};
  for (int k = 0; k < n_pairs; ++k) {
    pairs.gamma[k] = gammas[k];
    pairs.beta[k] = betas[k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_fwd<float>(x, pairs, n_pairs, out, mean, rstd,
                                  n_planes, plane, eps, s);
  }
  if (dtype == 1) {
    return (int)launch_fwd<__nv_bfloat16>(x, pairs, n_pairs, out, mean, rstd,
                                          n_planes, plane, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The backward of spade_modulation_fwd. x, gammas[k], g (the gradient of
// out), dx and dgamma: NCHW-contiguous tensors of one type; mean and
// rstd: the forward's n_planes floats each. Writes dx and dgamma (the
// gradient of every gamma_i; the gradient of every beta_i is g itself).
int spade_modulation_bwd(const void* x, const void* const* gammas, int n_pairs,
                         const float* mean, const float* rstd, const void* g,
                         void* dx, void* dgamma, long long n_planes,
                         long long plane, int dtype, void* stream) {
  if (!args_ok(n_pairs, n_planes, plane)) return (int)cudaErrorInvalidValue;
  PairPtrs pairs = {};
  for (int k = 0; k < n_pairs; ++k) pairs.gamma[k] = gammas[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_bwd<float>(x, pairs, n_pairs, mean, rstd, g, dx,
                                  dgamma, n_planes, plane, s);
  }
  if (dtype == 1) {
    return (int)launch_bwd<__nv_bfloat16>(x, pairs, n_pairs, mean, rstd, g, dx,
                                          dgamma, n_planes, plane, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* spade_modulation_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
