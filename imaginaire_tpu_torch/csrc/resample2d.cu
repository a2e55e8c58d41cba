// Bilinear backward warp (resample2d), forward, for Hopper (sm_90a).
//
//   out[b, c, y, x] = sum over the 4 corners of x[b, c, yi, xi] * weight
//
// sampled at (x + dx, y + dy) with (dx, dy) = flow[b, :, y, x]. The
// coordinates, floors and weights are fp32. Corner indices are clamped
// to the border; the weights come from the UNCLAMPED fractional parts
// (the reference CUDA op's clamp-after-weighting behaviour). Tensors are
// NCHW: x (B, C, H, W), flow (B, 2, H, W) with channel 0 = dx, out like
// x. The output is written in x's type.
//
// Replaces: imaginaire_tpu/ops/pallas/resample2d_kernel.py,
// resample2d_fwd_pallas (_kernel). The Pallas kernel walks each 8-row
// band's pixels in a scalar fori_loop, because gathers on the TPU are
// scalar-addressed. On Hopper every pixel is independent, so this
// kernel gives each output pixel (b, y, x) its own thread: it reads
// the pixel's two flow values once, computes the fp32 coordinates, the
// clamped corner indices and the four weights once, then loops over the
// C channel planes, gathering four corners per plane and accumulating
// in fp32. The arithmetic uses the round-to-nearest intrinsics
// (__fadd_rn, __fmul_rn) so that no multiply-add is contracted: the
// kernel then computes the same fp32 values as the plain PyTorch
// version, which runs each step as its own elementwise operation.
//
// Bound: device-memory bytes. x read once, flow read once and out
// written once is (2 C e + 2 f) B H W bytes for element sizes e (x)
// and f (flow): with an fp32 flow, (2 C e + 8) B H W. At
// (1, 3, 512, 1024) fp32 that is 16.8 MB, ~5 us at 3.35 TB/s, against
// ~30 flops per pixel: far below the card's operations-per-byte
// balance. What the design does about it: neighbouring threads take
// neighbouring pixels of a row, so the flow loads and the output stores
// are coalesced, and for a smooth flow the four corner gathers of a
// warp land on a few neighbouring rows of the plane; the flow is never
// re-read per channel. All offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RESAMPLE_THREADS 256

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

// floor(v) as an index, clamped to [0, n - 1] (and v + 1 likewise),
// exact for any finite v: v is clamped to [-1, n] before the int cast.
__device__ __forceinline__ void corner_indices(float fl, int n, int* i0,
                                               int* i1) {
  const int i = (int)fminf(fmaxf(fl, -1.f), (float)n);
  *i0 = min(max(i, 0), n - 1);
  *i1 = min(max(i + 1, 0), n - 1);
}

template <typename T, typename F>
__global__ void __launch_bounds__(RESAMPLE_THREADS)
resample2d_kernel(const T* __restrict__ x, const F* __restrict__ flow,
                  T* __restrict__ out, int64_t n_pixels, int channels,
                  int height, int width) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pixels) return;
  const int64_t plane = (int64_t)height * width;
  const int64_t b = p / plane;
  const int64_t r = p - b * plane;  // y * width + x within the plane
  const int y = (int)(r / width);
  const int xq = (int)(r - (int64_t)y * width);

  const F* fb = flow + b * 2 * plane;
  const float xf = __fadd_rn((float)xq, load_f(fb, r));
  const float yf = __fadd_rn((float)y, load_f(fb, plane + r));
  const float x0 = floorf(xf);
  const float y0 = floorf(yf);
  const float ax = __fsub_rn(xf, x0);  // fractional parts BEFORE clamping
  const float ay = __fsub_rn(yf, y0);
  int x0i, x1i, y0i, y1i;
  corner_indices(x0, width, &x0i, &x1i);
  corner_indices(y0, height, &y0i, &y1i);
  const float bx = __fsub_rn(1.f, ax);
  const float by = __fsub_rn(1.f, ay);
  const float w00 = __fmul_rn(by, bx);
  const float w01 = __fmul_rn(by, ax);
  const float w10 = __fmul_rn(ay, bx);
  const float w11 = __fmul_rn(ay, ax);
  const int64_t o00 = (int64_t)y0i * width + x0i;
  const int64_t o01 = (int64_t)y0i * width + x1i;
  const int64_t o10 = (int64_t)y1i * width + x0i;
  const int64_t o11 = (int64_t)y1i * width + x1i;

  const T* xc = x + b * channels * plane;
  T* oc = out + b * channels * plane + r;
  for (int c = 0; c < channels; ++c, xc += plane, oc += plane) {
    float v = __fmul_rn(w00, load_f(xc, o00));
    v = __fadd_rn(v, __fmul_rn(w01, load_f(xc, o01)));
    v = __fadd_rn(v, __fmul_rn(w10, load_f(xc, o10)));
    v = __fadd_rn(v, __fmul_rn(w11, load_f(xc, o11)));
    store_f(oc, 0, v);
  }
}

template <typename T, typename F>
static cudaError_t launch(const void* x, const void* flow, void* out,
                          long long batch, long long channels, long long height,
                          long long width, cudaStream_t stream) {
  const int64_t n_pixels = (int64_t)batch * height * width;
  const int64_t blocks = (n_pixels + RESAMPLE_THREADS - 1) / RESAMPLE_THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  resample2d_kernel<T, F><<<(unsigned)blocks, RESAMPLE_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const F*>(flow),
      static_cast<T*>(out), n_pixels, (int)channels, (int)height, (int)width);
  return cudaGetLastError();
}

extern "C" {

// x and out: NCHW-contiguous (batch, channels, height, width) tensors of
// x_dtype; flow: NCHW-contiguous (batch, 2, height, width) of
// flow_dtype (0 = float32, 1 = bfloat16 for both). Launches on `stream`
// and returns the CUDA error code of the launch (0 on success); it does
// not synchronise.
int resample2d_fwd(const void* x, const void* flow, void* out,
                   long long batch, long long channels, long long height,
                   long long width, int x_dtype, int flow_dtype,
                   void* stream) {
  if (batch < 1 || channels < 1 || height < 1 || width < 1 ||
      channels > 0x7fffffffLL || height > 0x7fffffffLL ||
      width > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (x_dtype == 0 && flow_dtype == 0) {
    err = launch<float, float>(x, flow, out, batch, channels, height, width, s);
  } else if (x_dtype == 0 && flow_dtype == 1) {
    err = launch<float, __nv_bfloat16>(x, flow, out, batch, channels, height,
                                       width, s);
  } else if (x_dtype == 1 && flow_dtype == 0) {
    err = launch<__nv_bfloat16, float>(x, flow, out, batch, channels, height,
                                       width, s);
  } else if (x_dtype == 1 && flow_dtype == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, flow, out, batch, channels,
                                               height, width, s);
  }
  return (int)err;
}

const char* resample2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
