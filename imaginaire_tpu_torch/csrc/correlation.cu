// FlowNetC cost volume (correlation), forward, for Hopper (sm_90a).
//
//   out[b, dyi * n_d + dxi, y, x] =
//       sum_c x1[b, c, y, x] * x2[b, c, y + dy, x + dx] / C
//
// with dy = -md + dyi * s2, dx = -md + dxi * s2, n_d = 2 md / s2 + 1
// (md = max_displacement, s2 = stride2, md divisible by s2), and x2 read
// as zero outside the frame (the reference zero-pads x2 by pad_size >= md,
// so no displacement reaches past the padding). kernel_size 1, stride1 1:
// the FlowNetC configuration. Tensors are NCHW: x1, x2 (B, C, H, W), out
// (B, n_d * n_d, H, W) in x1's type; products and sums are fp32.
//
// Replaces: imaginaire_tpu/ops/pallas/correlation_kernel.py,
// correlation_pallas (_kernel). The Pallas kernel pre-stages the n_d
// vertically shifted copies of x2 in HBM (a (B, n_d, H, W + 2p, C)
// stack) and walks a sequential grid whose innermost axis accumulates
// channel chunks into a VMEM scratch slab. Hopper blocks run in no order
// and carry nothing between them, so here one block owns a whole output
// slab: one output row y, one vertical displacement dy, a tile of 128
// columns and a group of up to 24 horizontal displacements, and loops
// over the channels itself. Per chunk of channels it stages the x1 row
// tile (chunk x 128) and the x2 row window that the group's horizontal
// displacements reach (chunk x (128 + 23 s2)), both read straight from
// x1 and x2 with zeros outside the frame (no padded copy in device
// memory), in shared memory. Each thread keeps its outputs (one column,
// every second displacement of the group) in fp32 registers across all
// chunks, and writes each once, divided by C, in x1's type.
//
// Bound: operations. One output is C multiply-adds, so one FlowNetC call
// at 512x1024 ((1, 256, 64, 128), n_d = 21) is 925 M multiply-adds, 27.6
// us at the 67 TFLOP/s fp32 peak, against 31.2 MB (9.3 us) of inputs and
// output. The products are fp32 fused multiply-adds on the CUDA cores,
// not TF32 tensor cores, which would round the inputs to 10 bits. What
// the design does about the bound: each value of x1 staged in shared
// memory feeds up to 12 multiply-adds from a register, and the x2 window
// is shared by every displacement of the group, so device memory is read
// about once per dy; the limit left is one shared-memory load per
// multiply-add (a register-blocked or tensor-core design is later work).
// All offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CORR_THREADS 256
#define CORR_TILE_W 128                             // output columns per block
#define CORR_KSLOTS (CORR_THREADS / CORR_TILE_W)    // threads per column
#define CORR_ACC 12                                 // outputs per thread
#define CORR_DX_GROUP (CORR_KSLOTS * CORR_ACC)      // displacements per block
#define CORR_MAX_CHUNK 32                           // channels per stage
#define CORR_SMEM_BYTES (48 * 1024)

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

template <typename T>
__global__ void __launch_bounds__(CORR_THREADS)
correlation_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                   T* __restrict__ out, int channels, int height, int width,
                   int n_d, int max_disp, int stride2, int n_tiles,
                   int n_groups, int chunk, int window) {
  extern __shared__ float smem[];
  float* s1 = smem;                        // [chunk][CORR_TILE_W]
  float* s2 = smem + chunk * CORR_TILE_W;  // [chunk][window]

  // blockIdx.x -> (tile, group, dyi, y), tile fastest; blockIdx.y = b
  int64_t bx = blockIdx.x;
  const int tile = (int)(bx % n_tiles);
  bx /= n_tiles;
  const int group = (int)(bx % n_groups);
  bx /= n_groups;
  const int dyi = (int)(bx % n_d);
  const int y = (int)(bx / n_d);
  const int64_t b = blockIdx.y;

  const int x0 = tile * CORR_TILE_W;
  const int g0 = group * CORR_DX_GROUP;  // first dxi of the group
  const int n_in_group = min(CORR_DX_GROUP, n_d - g0);
  const int yy = y - max_disp + dyi * stride2;
  const int dx_lo = -max_disp + g0 * stride2;
  const int xl = threadIdx.x % CORR_TILE_W;
  const int kslot = threadIdx.x / CORR_TILE_W;
  const int64_t plane = (int64_t)height * width;

  float acc[CORR_ACC];
#pragma unroll
  for (int k = 0; k < CORR_ACC; ++k) acc[k] = 0.f;

  if (yy >= 0 && yy < height) {  // the same for the whole block
    const T* x1_row = x1 + b * channels * plane + (int64_t)y * width;
    const T* x2_row = x2 + b * channels * plane + (int64_t)yy * width;
    for (int c0 = 0; c0 < channels; c0 += chunk) {
      const int cn = min(chunk, channels - c0);
      for (int i = threadIdx.x; i < cn * CORR_TILE_W; i += CORR_THREADS) {
        const int cc = i / CORR_TILE_W;
        const int xx = x0 + (i - cc * CORR_TILE_W);
        s1[i] = xx < width ? load_f(x1_row, (int64_t)(c0 + cc) * plane + xx)
                           : 0.f;
      }
      for (int i = threadIdx.x; i < cn * window; i += CORR_THREADS) {
        const int cc = i / window;
        const int xx = x0 + dx_lo + (i - cc * window);
        s2[i] = (xx >= 0 && xx < width)
                    ? load_f(x2_row, (int64_t)(c0 + cc) * plane + xx)
                    : 0.f;
      }
      __syncthreads();
      const float* r1 = s1 + xl;
      const float* r2 = s2 + xl + kslot * stride2;
      for (int cc = 0; cc < cn; ++cc, r1 += CORR_TILE_W, r2 += window) {
        const float a = *r1;
#pragma unroll
        for (int k = 0; k < CORR_ACC; ++k) {
          if (kslot + CORR_KSLOTS * k < n_in_group) {
            acc[k] = fmaf(a, r2[CORR_KSLOTS * k * stride2], acc[k]);
          }
        }
      }
      __syncthreads();
    }
  }

  const int col = x0 + xl;
  if (col >= width) return;
  T* o = out + (b * n_d * n_d + (int64_t)dyi * n_d + g0) * plane +
         (int64_t)y * width + col;
  const float c = (float)channels;
#pragma unroll
  for (int k = 0; k < CORR_ACC; ++k) {
    const int dxl = kslot + CORR_KSLOTS * k;
    if (dxl < n_in_group) store_f(o, (int64_t)dxl * plane, acc[k] / c);
  }
}

template <typename T>
static cudaError_t launch(const void* x1, const void* x2, void* out,
                          long long batch, long long channels, long long height,
                          long long width, int max_disp, int stride2,
                          cudaStream_t stream) {
  const int n_d = 2 * (max_disp / stride2) + 1;
  const int n_tiles = (int)((width + CORR_TILE_W - 1) / CORR_TILE_W);
  const int n_groups = (n_d + CORR_DX_GROUP - 1) / CORR_DX_GROUP;
  const int span = (n_d < CORR_DX_GROUP ? n_d : CORR_DX_GROUP) - 1;
  const long long window = CORR_TILE_W + (long long)span * stride2;
  const long long per_channel = (CORR_TILE_W + window) * (long long)sizeof(float);
  long long chunk = CORR_SMEM_BYTES / per_channel;
  if (chunk > CORR_MAX_CHUNK) chunk = CORR_MAX_CHUNK;
  if (chunk > channels) chunk = channels;
  if (chunk < 1) return cudaErrorInvalidValue;  // stride2 too large to stage
  const long long blocks = (long long)n_tiles * n_groups * n_d * height;
  if (blocks > 0x7fffffffLL || batch > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)batch);
  const size_t smem = (size_t)(chunk * per_channel);
  correlation_kernel<T><<<grid, CORR_THREADS, smem, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2), static_cast<T*>(out),
      (int)channels, (int)height, (int)width, n_d, max_disp, stride2, n_tiles,
      n_groups, (int)chunk, (int)window);
  return cudaGetLastError();
}

extern "C" {

// x1, x2: NCHW-contiguous (batch, channels, height, width); out:
// NCHW-contiguous (batch, n_d * n_d, height, width) with
// n_d = 2 * max_disp / stride2 + 1; all of dtype (0 = float32,
// 1 = bfloat16). max_disp >= 0, stride2 >= 1, max_disp % stride2 == 0.
// Launches on `stream` and returns the CUDA error code of the launch
// (0 on success); it does not synchronise.
int correlation_fwd(const void* x1, const void* x2, void* out, long long batch,
                    long long channels, long long height, long long width,
                    int max_disp, int stride2, int dtype, void* stream) {
  if (batch < 1 || channels < 1 || height < 1 || width < 1 ||
      channels > 0x7fffffffLL || height > 0x7fffffffLL ||
      width > 0x7fffffffLL || max_disp < 0 || stride2 < 1 ||
      max_disp % stride2 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<float>(x1, x2, out, batch, channels, height, width,
                              max_disp, stride2, s);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(x1, x2, out, batch, channels, height,
                                      width, max_disp, stride2, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* correlation_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
