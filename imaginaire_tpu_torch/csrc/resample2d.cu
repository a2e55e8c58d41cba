// Bilinear backward warp (resample2d), forward and backward, for Hopper
// (sm_90a).
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
// scalar-addressed. On Hopper every pixel is independent.
//
// Bound: device-memory bytes. x read once, flow read once and out
// written once is (2 C e + 2 f) B H W bytes for element sizes e (x)
// and f (flow): with an fp32 flow, (2 C e + 8) B H W. At
// (1, 3, 512, 1024) fp32 that is 16.8 MB, ~5 us at 3.35 TB/s, against
// ~30 flops per pixel: far below the card's operations-per-byte
// balance. Every pixel waits for its flow, then for its corners: two
// dependent trips to memory, so the time is set by how many loads are in
// flight and how few cache lines each of them touches. What the design
// does about it:
//
// - Two pixels a thread (RESAMPLE_PIXELS), 32 columns apart: pixel i of
//   lane l is column x0 + l + 32 i. Every load and store instruction of a
//   warp then covers 32 neighbouring pixels: the flow loads and the output
//   stores are coalesced (128 bytes a warp in fp32), and under a smooth
//   flow a corner gather touches one or two cache lines, as one pixel a
//   thread did. (Four or eight neighbouring pixels a thread with 16-byte
//   vectors spread each gather instruction over four times the lines and
//   took twice the registers; it measured slower than one pixel a thread.)
// - The corner gathers of three channel planes (RESAMPLE_PLANES, an RGB
//   warp's all: 24 for a thread's two pixels) are issued before the first
//   is used: one trip to memory for the flow, one for every corner, at
//   most 64 registers, so an SM holds 4 blocks of 256.
// - A 2-D block tile (64 columns x 8 rows, one warp a row), so that under
//   a smooth flow the corner rows of a block's neighbouring rows are the
//   same rows, and evict-first hints on the flow loads and the output
//   stores, which are touched once, so that the caches keep x.
// - A grid of one wave: at most as many blocks as the card holds at once
//   (the SM count times the blocks an SM takes, found once per device),
//   each walking the tiles grid-stride, so no partial second wave of
//   blocks is launched. The kernel derives its tiles from H and W.
// - Scalar loads and stores only, so the kernel needs no alignment and
//   takes any W; the wrapper copies nothing.
//
// Each choice is measured against its alternatives (pixels a thread,
// planes in flight, neighbouring pixels, registers, cache hints, tile
// shape, one block a tile) by scripts/torch_kernel_probe.py, which builds
// each from an edited copy of this file.
//
// The arithmetic of each pixel is unchanged: the round-to-nearest
// intrinsics (__fadd_rn, __fmul_rn) keep the compiler from contracting a
// multiply-add, so the kernel computes the same fp32 values, in the same
// order, as the plain PyTorch version, which runs each step as its own
// elementwise operation (fp32 outputs equal bit for bit). All
// device-memory offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RESAMPLE_MIN_BLOCKS 4  // blocks an SM holds: at most 64 registers
#define RESAMPLE_PIXELS 2      // pixels a thread, 32 columns apart
#define RESAMPLE_PLANES 3      // channel planes whose corners are in flight
#define RESAMPLE_TILE_ROWS 8   // rows of a block's tile, one warp a row
#define RESAMPLE_THREADS (32 * RESAMPLE_TILE_ROWS)
#define RESAMPLE_TILE_W (32 * RESAMPLE_PIXELS)  // columns of a tile
#define RESAMPLE_MAX_DEVICES 64  // devices whose wave size is kept

// the flow is read once and the output written once: both go by the
// evict-first hints (ld/st.global.cs), which leave the caches to x's
// corners; the corners go through the read-only path
__device__ __forceinline__ float load_f(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcs(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float gather_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float gather_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void store_f(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p),
         __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// floor(v) as an index, clamped to [0, n - 1], and the step (0 or 1) to
// the clamped index of v + 1, exact for any finite v: v is clamped to
// [-1, n] before the int cast.
__device__ __forceinline__ void corner_indices(float fl, int n, int* i0,
                                               int* step) {
  const int i = (int)fminf(fmaxf(fl, -1.f), (float)n);
  *i0 = min(max(i, 0), n - 1);
  *step = min(max(i + 1, 0), n - 1) - *i0;
}

// one thread's pixels (columns x0 + 32 i, i < RESAMPLE_PIXELS, those
// inside the row, of row y of image b), all channel planes
template <typename T, typename F>
__device__ __forceinline__ void warp_pixels(
    const T* __restrict__ x, const F* __restrict__ flow, T* __restrict__ out,
    int64_t b, int y, int x0, int channels, int height, int width) {
  constexpr int PX = RESAMPLE_PIXELS, CG = RESAMPLE_PLANES;
  constexpr int STRIDE = 32;  // columns between a thread's pixels
  const int64_t plane = (int64_t)height * width;
  const int64_t r = (int64_t)y * width + x0;  // the first pixel in its plane
  const F* fb = flow + b * 2 * plane + r;
  bool in[PX];
  float fx[PX], fy[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    in[i] = x0 + STRIDE * i < width;
    fx[i] = in[i] ? load_f(fb + STRIDE * i) : 0.f;
    fy[i] = in[i] ? load_f(fb + plane + STRIDE * i) : 0.f;
  }

  // corner 00's offset in the plane, the steps to corners 01 and 10, and
  // the four weights of each pixel
  int64_t o00[PX];
  int sx[PX], sy[PX];
  float w00[PX], w01[PX], w10[PX], w11[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    const float xf = __fadd_rn((float)(x0 + STRIDE * i), fx[i]);
    const float yf = __fadd_rn((float)y, fy[i]);
    const float xl = floorf(xf);
    const float yl = floorf(yf);
    const float ax = __fsub_rn(xf, xl);  // fractional parts BEFORE clamping
    const float ay = __fsub_rn(yf, yl);
    int x0i, y0i;
    corner_indices(xl, width, &x0i, &sx[i]);
    corner_indices(yl, height, &y0i, &sy[i]);
    sy[i] *= width;
    const float bx = __fsub_rn(1.f, ax);
    const float by = __fsub_rn(1.f, ay);
    w00[i] = __fmul_rn(by, bx);
    w01[i] = __fmul_rn(by, ax);
    w10[i] = __fmul_rn(ay, bx);
    w11[i] = __fmul_rn(ay, ax);
    o00[i] = (int64_t)y0i * width + x0i;
  }

  const T* xb = x + b * channels * plane;
  T* ob = out + b * channels * plane + r;
  for (int c = 0; c < channels; c += CG) {
    // every corner of the group's planes first, then the sums (a pixel
    // outside the row gathers its clamped corners, in the frame, and
    // stores nothing)
    float v[CG][PX][4];
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      if (c + g >= channels) continue;
      const T* xc = xb + (int64_t)(c + g) * plane;
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        const T* p = xc + o00[i];
        v[g][i][0] = gather_f(p);
        v[g][i][1] = gather_f(p + sx[i]);
        v[g][i][2] = gather_f(p + sy[i]);
        v[g][i][3] = gather_f(p + sy[i] + sx[i]);
      }
    }
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      if (c + g >= channels) continue;
      T* oc = ob + (int64_t)(c + g) * plane;
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        float s = __fmul_rn(w00[i], v[g][i][0]);
        s = __fadd_rn(s, __fmul_rn(w01[i], v[g][i][1]));
        s = __fadd_rn(s, __fmul_rn(w10[i], v[g][i][2]));
        s = __fadd_rn(s, __fmul_rn(w11[i], v[g][i][3]));
        if (in[i]) store_f(oc + STRIDE * i, s);
      }
    }
  }
}

// Tile t of the batch is image t / tiles_per_image, row band and column
// band in row-major order; a block walks tiles blockIdx.x, + gridDim.x, ...
// Warp w of a block takes row w of its tile, lane l of it the pixels of
// columns l, l + 32, ... of the tile.
template <typename T, typename F>
__global__ void __launch_bounds__(RESAMPLE_THREADS, RESAMPLE_MIN_BLOCKS)
resample2d_kernel(const T* __restrict__ x, const F* __restrict__ flow,
                  T* __restrict__ out, int batch, int channels, int height,
                  int width) {
  const int row = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_x = (width - 1) / RESAMPLE_TILE_W + 1;
  const int per_image = tiles_x * ((height - 1) / RESAMPLE_TILE_ROWS + 1);
  const int64_t n_tiles = (int64_t)per_image * batch;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t b = t / per_image;
    const int rt = (int)(t - b * per_image);
    const int ty = rt / tiles_x;
    const int y = ty * RESAMPLE_TILE_ROWS + row;
    const int x0 = (rt - ty * tiles_x) * RESAMPLE_TILE_W + lane;
    if (y < height && x0 < width) {
      warp_pixels<T, F>(x, flow, out, b, y, x0, channels, height, width);
    }
  }
}

// the blocks the current device holds at once (its SMs times the blocks
// of this kernel an SM takes), asked of the runtime once per device
template <typename T, typename F>
static cudaError_t one_wave(long long* blocks) {
  static int known[RESAMPLE_MAX_DEVICES];  // 0 until asked
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool kept = device >= 0 && device < RESAMPLE_MAX_DEVICES;
  if (kept && known[device] > 0) {
    *blocks = known[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, resample2d_kernel<T, F>, RESAMPLE_THREADS, 0);
  }
  if (err != cudaSuccess) return err;
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  if (kept) known[device] = n;
  *blocks = n;
  return cudaSuccess;
}

// a grid of one wave, or of one block a tile where there are fewer
template <typename T, typename F>
static cudaError_t launch(const void* x, const void* flow, void* out,
                          long long batch, long long channels, long long height,
                          long long width, long long tiles,
                          cudaStream_t stream) {
  long long blocks = 0;
  const cudaError_t err = one_wave<T, F>(&blocks);
  if (err != cudaSuccess) return err;
  if (tiles < blocks) blocks = tiles;
  resample2d_kernel<T, F><<<(unsigned)blocks, RESAMPLE_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const F*>(flow),
      static_cast<T*>(out), (int)batch, (int)channels, (int)height,
      (int)width);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// Replaces: imaginaire_tpu/ops/resample2d.py, _pallas_bwd (jax.vjp of the
// jnp _bilinear_warp; not Pallas). With g the gradient of the output, per
// output pixel, in fp32 coordinates whatever the input types:
//
//   dflow_x = sum_c g ((1 - ay)(x01 - x00) + ay (x11 - x10))
//   dflow_y = sum_c g ((1 - ax)(x10 - x00) + ax (x11 - x01))
//
// (floor has zero gradient; the corners are the forward's clamped ones,
// so a pixel whose corners clamp to one column gets dflow_x = 0), and,
// when dx is asked for, w_k g scatter-added into each of the four corners
// with fp32 atomics into an fp32 buffer that the wrapper zeroes and casts
// to x's type.
//
// Bound: device-memory bytes. x read once, g read once, flow read once
// and dflow written once is (2 C e + 4 f) B H W bytes (e the element size
// of x and g, f of flow and dflow), plus C B H W (4 + e) bytes for dx's
// fp32 buffer and its cast when dx is asked for; at most ~60 flops a
// pixel and channel. The design is the simple one: one thread a pixel
// (neighbouring threads on neighbouring columns, so the flow, g and
// dflow accesses are coalesced), a loop over the channels, a grid of one
// wave walking the pixels grid-stride. dflow needs no atomics; it is
// summed over the channels in the plain version's order with the
// round-to-nearest intrinsics, so it equals the plain version bit for
// bit. dx's atomics add in an order that changes from run to run.

#define RESAMPLE_BWD_THREADS 256

template <typename T, typename F>
__global__ void __launch_bounds__(RESAMPLE_BWD_THREADS)
resample2d_bwd_kernel(const T* __restrict__ x, const F* __restrict__ flow,
                      const T* __restrict__ g, F* __restrict__ dflow,
                      float* __restrict__ dx, int batch, int channels,
                      int height, int width) {
  const int64_t plane = (int64_t)height * width;
  const int64_t n = plane * batch;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += step) {
    const int64_t b = p / plane;
    const int64_t r = p - b * plane;  // the pixel in its plane
    const int y = (int)(r / width);
    const int xc = (int)(r - (int64_t)y * width);
    const F* fb = flow + b * 2 * plane + r;
    const float xf = __fadd_rn((float)xc, load_f(fb));
    const float yf = __fadd_rn((float)y, load_f(fb + plane));
    const float xl = floorf(xf);
    const float yl = floorf(yf);
    const float ax = __fsub_rn(xf, xl);  // fractional parts BEFORE clamping
    const float ay = __fsub_rn(yf, yl);
    int x0i, y0i, sx, sy;
    corner_indices(xl, width, &x0i, &sx);
    corner_indices(yl, height, &y0i, &sy);
    sy *= width;
    const float bx = __fsub_rn(1.f, ax);
    const float by = __fsub_rn(1.f, ay);
    const int64_t o00 = (int64_t)y0i * width + x0i;
    const T* xb = x + b * channels * plane + o00;
    const T* gb = g + b * channels * plane + r;
    float dfx = 0.f, dfy = 0.f;
    for (int c = 0; c < channels; ++c) {
      const T* xp = xb + (int64_t)c * plane;
      const float v00 = gather_f(xp);
      const float v01 = gather_f(xp + sx);
      const float v10 = gather_f(xp + sy);
      const float v11 = gather_f(xp + sy + sx);
      const float gv = load_f(gb + (int64_t)c * plane);
      const float tx = __fadd_rn(__fmul_rn(by, __fsub_rn(v01, v00)),
                                 __fmul_rn(ay, __fsub_rn(v11, v10)));
      const float ty = __fadd_rn(__fmul_rn(bx, __fsub_rn(v10, v00)),
                                 __fmul_rn(ax, __fsub_rn(v11, v01)));
      dfx = __fadd_rn(dfx, __fmul_rn(gv, tx));
      dfy = __fadd_rn(dfy, __fmul_rn(gv, ty));
      if (dx != nullptr) {
        float* dp = dx + (b * channels + c) * plane + o00;
        atomicAdd(dp, __fmul_rn(__fmul_rn(by, bx), gv));
        atomicAdd(dp + sx, __fmul_rn(__fmul_rn(by, ax), gv));
        atomicAdd(dp + sy, __fmul_rn(__fmul_rn(ay, bx), gv));
        atomicAdd(dp + sy + sx, __fmul_rn(__fmul_rn(ay, ax), gv));
      }
    }
    F* db = dflow + b * 2 * plane + r;
    store_f(db, dfx);
    store_f(db + plane, dfy);
  }
}

// a grid of one wave of the backward kernel (at most), asked of the
// runtime once per device
template <typename T, typename F>
static cudaError_t launch_bwd(const void* x, const void* flow, const void* g,
                              void* dflow, void* dx, long long batch,
                              long long channels, long long height,
                              long long width, cudaStream_t stream) {
  static int known[RESAMPLE_MAX_DEVICES];  // 0 until asked
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool kept = device >= 0 && device < RESAMPLE_MAX_DEVICES;
  long long wave = kept ? known[device] : 0;
  if (wave <= 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, resample2d_bwd_kernel<T, F>, RESAMPLE_BWD_THREADS, 0);
    }
    if (err != cudaSuccess) return err;
    wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (kept) known[device] = (int)wave;
  }
  const long long pixels = batch * height * width;
  long long blocks = (pixels + RESAMPLE_BWD_THREADS - 1) / RESAMPLE_BWD_THREADS;
  if (blocks > wave) blocks = wave;
  resample2d_bwd_kernel<T, F><<<(unsigned)blocks, RESAMPLE_BWD_THREADS, 0,
                                stream>>>(
      static_cast<const T*>(x), static_cast<const F*>(flow),
      static_cast<const T*>(g), static_cast<F*>(dflow),
      static_cast<float*>(dx), (int)batch, (int)channels, (int)height,
      (int)width);
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
      batch > 0x7fffffffLL || channels > 0x7fffffffLL ||
      height > 0x7fffffffLL || width > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  // the kernel keeps a tile's index within its image in an int
  const long long per_image = (width + RESAMPLE_TILE_W - 1) / RESAMPLE_TILE_W *
      ((height + RESAMPLE_TILE_ROWS - 1) / RESAMPLE_TILE_ROWS);
  if (per_image > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long tiles = per_image * batch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (x_dtype == 0 && flow_dtype == 0) {
    err = launch<float, float>(x, flow, out, batch, channels, height, width,
                               tiles, s);
  } else if (x_dtype == 0 && flow_dtype == 1) {
    err = launch<float, __nv_bfloat16>(x, flow, out, batch, channels, height,
                                       width, tiles, s);
  } else if (x_dtype == 1 && flow_dtype == 0) {
    err = launch<__nv_bfloat16, float>(x, flow, out, batch, channels, height,
                                       width, tiles, s);
  } else if (x_dtype == 1 && flow_dtype == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, flow, out, batch, channels,
                                               height, width, tiles, s);
  }
  return (int)err;
}

// The backward. x and g: NCHW-contiguous (batch, channels, height, width)
// of x_dtype; flow and dflow: (batch, 2, height, width) of flow_dtype
// (0 = float32, 1 = bfloat16); dx: NULL, or a zeroed float32 buffer
// shaped like x into which the kernel adds dx. Launches on `stream` and
// returns the CUDA error code of the launch; it does not synchronise.
int resample2d_bwd(const void* x, const void* flow, const void* g,
                   void* dflow, void* dx, long long batch, long long channels,
                   long long height, long long width, int x_dtype,
                   int flow_dtype, void* stream) {
  if (batch < 1 || channels < 1 || height < 1 || width < 1 ||
      batch > 0x7fffffffLL || channels > 0x7fffffffLL ||
      height > 0x7fffffffLL || width > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (x_dtype == 0 && flow_dtype == 0) {
    err = launch_bwd<float, float>(x, flow, g, dflow, dx, batch, channels,
                                   height, width, s);
  } else if (x_dtype == 0 && flow_dtype == 1) {
    err = launch_bwd<float, __nv_bfloat16>(x, flow, g, dflow, dx, batch,
                                           channels, height, width, s);
  } else if (x_dtype == 1 && flow_dtype == 0) {
    err = launch_bwd<__nv_bfloat16, float>(x, flow, g, dflow, dx, batch,
                                           channels, height, width, s);
  } else if (x_dtype == 1 && flow_dtype == 1) {
    err = launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, flow, g, dflow, dx,
                                                   batch, channels, height,
                                                   width, s);
  }
  return (int)err;
}

const char* resample2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
