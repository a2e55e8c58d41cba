// Per-pixel L-p norm over the channel axis (channelnorm), forward, for
// Hopper (sm_90a).
//
//   out[b, 0, y, x] = (sum_c |x[b, c, y, x]|^p)^(1/p)
//
// computed in fp32 whatever the input type, with sqrt at p = 2 and no
// root at p = 1; the output is written in x's type. Tensors are NCHW:
// x (B, C, H, W), out (B, 1, H, W).
//
// Replaces: imaginaire_tpu/ops/pallas/channelnorm_kernel.py,
// channelnorm_pallas (_kernel). The Pallas kernel flattens the pixels to
// rows and puts the channels on the 128-wide lane axis, so at FlowNet2's
// C = 2-3 most lanes idle. Here each output pixel (b, y, x) is one
// thread, which walks the C channel planes (stride H W): neighbouring
// threads take neighbouring pixels of a row, so every plane's loads and
// the output's stores are coalesced, and the sum stays in a register.
//
// Bound: device-memory bytes. x read once and out written once is
// (C + 1) e B H W bytes for element size e; at (1, 3, 512, 1024) fp32
// that is 8.4 MB, ~2.5 us at 3.35 TB/s, against ~3 flops per element.
// The kernel reads each input element once, in order, and does nothing
// else; all offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CHANNELNORM_THREADS 256

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

// mode 0: p = 2 (sqrt of the sum of squares); 1: p = 1 (sum of
// magnitudes); 2: any other p > 0 (powf both ways).
template <typename T>
__global__ void __launch_bounds__(CHANNELNORM_THREADS)
channelnorm_kernel(const T* __restrict__ x, T* __restrict__ out,
                   int64_t n_pixels, int channels, int64_t plane, int mode,
                   float p, float inv_p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pixels) return;
  const int64_t b = i / plane;
  const int64_t r = i - b * plane;
  const T* xc = x + b * channels * plane + r;
  float acc = 0.f;
  if (mode == 0) {
    for (int c = 0; c < channels; ++c, xc += plane) {
      const float v = load_f(xc, 0);
      acc = fmaf(v, v, acc);
    }
    acc = sqrtf(acc);
  } else if (mode == 1) {
    for (int c = 0; c < channels; ++c, xc += plane) acc += fabsf(load_f(xc, 0));
  } else {
    for (int c = 0; c < channels; ++c, xc += plane) {
      acc += powf(fabsf(load_f(xc, 0)), p);
    }
    acc = powf(acc, inv_p);
  }
  store_f(out, i, acc);
}

template <typename T>
static cudaError_t launch(const void* x, void* out, long long batch,
                          long long channels, long long height, long long width,
                          int mode, float p, float inv_p, cudaStream_t stream) {
  const int64_t plane = (int64_t)height * width;
  const int64_t n_pixels = (int64_t)batch * plane;
  const int64_t blocks = (n_pixels + CHANNELNORM_THREADS - 1) / CHANNELNORM_THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  channelnorm_kernel<T><<<(unsigned)blocks, CHANNELNORM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n_pixels, (int)channels,
      plane, mode, p, inv_p);
  return cudaGetLastError();
}

extern "C" {

// x: NCHW-contiguous (batch, channels, height, width), out:
// NCHW-contiguous (batch, 1, height, width), both of dtype (0 = float32,
// 1 = bfloat16). p > 0; inv_p = 1 / p. Launches on `stream` and returns
// the CUDA error code of the launch (0 on success); it does not
// synchronise.
int channelnorm_fwd(const void* x, void* out, long long batch,
                    long long channels, long long height, long long width,
                    int dtype, float p, float inv_p, void* stream) {
  if (batch < 1 || channels < 1 || height < 1 || width < 1 ||
      channels > 0x7fffffffLL || !(p > 0.f)) {
    return (int)cudaErrorInvalidValue;
  }
  const int mode = p == 2.f ? 0 : (p == 1.f ? 1 : 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<float>(x, out, batch, channels, height, width, mode, p,
                              inv_p, s);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(x, out, batch, channels, height, width,
                                      mode, p, inv_p, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* channelnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
