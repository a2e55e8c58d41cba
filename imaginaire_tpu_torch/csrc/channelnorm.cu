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
// C = 2-3 most lanes idle. Here the channels stay planes (stride H W) and
// each thread owns one 16-byte vector of consecutive pixels of a plane
// (4 fp32 or 8 bf16): it reads that vector from each of the C planes with
// one 128-bit load, sums in fp32 registers and writes its outputs with
// one vector store, so a warp moves 512 bytes of a plane per load
// instruction. The grid is one wave of resident blocks on the card's SMs
// (8 blocks of 256 threads an SM), and each thread walks the vectors in a
// grid-stride loop.
//
// Alignment: the vectors of a plane are 16-byte aligned only when every
// plane starts at the same offset modulo 16 bytes, that is when H W is a
// multiple of the vector. Then the pixels before the first aligned vector
// of a plane (a base pointer at a 4-byte, not 16-byte, offset) and after
// the last one take a scalar path inside this kernel, and an output
// vector whose address is not aligned is stored element by element.
// When H W is not a multiple of the vector every pixel takes the scalar
// path.
//
// Bound: device-memory bytes. x read once and out written once is
// (C + 1) e B H W bytes for element size e; at (6, 3, 512, 1024) fp32
// that is 50.3 MB, 15.0 us at 3.35 TB/s, against ~3 flops per element.
// The wide loads keep enough bytes in flight per thread to approach that
// rate with few instructions; all offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CHANNELNORM_THREADS 256
#define CHANNELNORM_BLOCKS_PER_SM 8  // resident blocks of 256 threads

template <typename T>
struct Vec;  // one 16-byte vector of T, unpacked to fp32

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> fp32 is a 16-bit shift
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// mode 0: p = 2 (sqrt of the sum of squares); 1: p = 1 (sum of
// magnitudes); 2: any other p > 0 (powf both ways).
__device__ __forceinline__ float term(float v, int mode, float p) {
  return mode == 0 ? v * v : (mode == 1 ? fabsf(v) : powf(fabsf(v), p));
}
__device__ __forceinline__ float finish(float acc, int mode, float inv_p) {
  return mode == 0 ? sqrtf(acc) : (mode == 1 ? acc : powf(acc, inv_p));
}

template <typename T>
__device__ __forceinline__ void scalar_pixel(const T* xb, T* ob, int64_t plane,
                                             int channels, int64_t p, int mode,
                                             float pw, float inv_p) {
  const T* xc = xb + p;
  float acc = 0.f;
  for (int c = 0; c < channels; ++c, xc += plane) {
    const float v = load_f(xc);
    acc = mode == 0 ? fmaf(v, v, acc) : acc + term(v, mode, pw);
  }
  store_f(ob + p, finish(acc, mode, inv_p));
}

// Work items of one batch element: n_head scalar pixels, then n_vec
// vectors (16-byte aligned in every plane), then the scalar tail up to
// the plane's end. Items of all batch elements are walked grid-stride.
template <typename T>
__global__ void __launch_bounds__(CHANNELNORM_THREADS)
channelnorm_kernel(const T* __restrict__ x, T* __restrict__ out,
                   int64_t batch, int channels, int64_t plane, int64_t n_head,
                   int64_t n_vec, int mode, float pw, float inv_p) {
  constexpr int N = Vec<T>::N;
  const int64_t items = plane - (N - 1) * n_vec;  // per batch element
  const int64_t total = batch * items;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = i / items;
    const int64_t k = i - b * items;
    const T* xb = x + b * channels * plane;
    T* ob = out + b * plane;
    if (k < n_head || k >= n_head + n_vec) {
      const int64_t p = k < n_head ? k : k + (N - 1) * n_vec;
      scalar_pixel(xb, ob, plane, channels, p, mode, pw, inv_p);
      continue;
    }
    const int64_t p = n_head + (k - n_head) * N;
    float acc[N], v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = 0.f;
    const T* xc = xb + p;
    for (int c = 0; c < channels; ++c, xc += plane) {
      Vec<T>::load(xc, v);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        acc[j] = mode == 0 ? fmaf(v[j], v[j], acc[j]) : acc[j] + term(v[j], mode, pw);
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = finish(acc[j], mode, inv_p);
    T* o = ob + p;
    if ((reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      Vec<T>::store(o, acc);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) store_f(o + j, acc[j]);
    }
  }
}

template <typename T>
static cudaError_t launch(const void* x, void* out, long long batch,
                          long long channels, long long height, long long width,
                          int mode, float p, float inv_p, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const int64_t plane = (int64_t)height * width;
  int64_t n_head = plane, n_vec = 0;  // everything scalar unless aligned
  if (plane % N == 0) {
    // every plane starts at the same offset modulo 16 bytes: skip to the
    // first 16-byte boundary, then whole vectors, then the tail
    const int64_t mis = (int64_t)((reinterpret_cast<uintptr_t>(x) / sizeof(T)) % N);
    n_head = (N - mis) % N;  // < N <= plane
    n_vec = (plane - n_head) / N;
  }
  const int64_t items = batch * (plane - (N - 1) * n_vec);
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t blocks = (items + CHANNELNORM_THREADS - 1) / CHANNELNORM_THREADS;
  const int64_t cap = (int64_t)sms * CHANNELNORM_BLOCKS_PER_SM;  // one full wave
  if (blocks > cap) blocks = cap;
  channelnorm_kernel<T><<<(unsigned)blocks, CHANNELNORM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), batch, (int)channels,
      plane, n_head, n_vec, mode, p, inv_p);
  return cudaGetLastError();
}

extern "C" {

// x: NCHW-contiguous (batch, channels, height, width), out:
// NCHW-contiguous (batch, 1, height, width), both of dtype (0 = float32,
// 1 = bfloat16); x needs only its element alignment. p > 0; inv_p = 1 / p.
// Launches on `stream` and returns the CUDA error code of the launch (0 on
// success); it does not synchronise.
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
