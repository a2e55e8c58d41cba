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
#define RESAMPLE_PIXELS 2      // pixels a thread, RESAMPLE_STRIDE columns apart
#define RESAMPLE_STRIDE 32     // columns between a thread's pixels
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

// Where pixel (xc, y) samples under the flow (fx, fy): the column x0 and
// row y0 of its corner 00 and its offset o00 in the plane, the steps to
// its corners 01 (sx: 0 or 1) and 10 (sy: 0 or width), and its
// fractional parts ax, ay, taken BEFORE the corners are clamped. The
// plain version's fp32 steps, one by one.
struct Sample {
  int64_t o00;
  int x0, y0, sx, sy;
  float ax, ay;
};

__device__ __forceinline__ Sample sample_at(int xc, int y, float fx, float fy,
                                            int height, int width) {
  const float xf = __fadd_rn((float)xc, fx);
  const float yf = __fadd_rn((float)y, fy);
  const float xl = floorf(xf);
  const float yl = floorf(yf);
  Sample s;
  s.ax = __fsub_rn(xf, xl);
  s.ay = __fsub_rn(yf, yl);
  corner_indices(xl, width, &s.x0, &s.sx);
  corner_indices(yl, height, &s.y0, &s.sy);
  s.o00 = (int64_t)s.y0 * width + s.x0;
  s.sy *= width;
  return s;
}

// Tile t of the batch (tiles of tile_w columns and RESAMPLE_TILE_ROWS
// rows) is image t / per_image, row band and column band in row-major
// order. Warp w of a block takes row w of its tile, lane l of it the
// pixels of columns l, l + 32, ... of the tile: this thread's image b, row
// y and first column x0.
__device__ __forceinline__ void tile_pixel(int64_t t, int tiles_x,
                                           int per_image, int tile_w,
                                           int64_t* b, int* y, int* x0) {
  const int row = threadIdx.x >> 5, lane = threadIdx.x & 31;
  *b = t / per_image;
  const int rt = (int)(t - *b * per_image);
  const int ty = rt / tiles_x;
  *y = ty * RESAMPLE_TILE_ROWS + row;
  *x0 = (rt - ty * tiles_x) * tile_w + lane;
}

// one thread's pixels (columns x0 + 32 i, i < RESAMPLE_PIXELS, those
// inside the row, of row y of image b), all channel planes
template <typename T, typename F>
__device__ __forceinline__ void warp_pixels(
    const T* __restrict__ x, const F* __restrict__ flow, T* __restrict__ out,
    int64_t b, int y, int x0, int channels, int height, int width) {
  constexpr int PX = RESAMPLE_PIXELS, CG = RESAMPLE_PLANES;
  constexpr int STRIDE = RESAMPLE_STRIDE;
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
    const Sample s = sample_at(x0 + STRIDE * i, y, fx[i], fy[i], height, width);
    o00[i] = s.o00;
    sx[i] = s.sx;
    sy[i] = s.sy;
    const float bx = __fsub_rn(1.f, s.ax);
    const float by = __fsub_rn(1.f, s.ay);
    w00[i] = __fmul_rn(by, bx);
    w01[i] = __fmul_rn(by, s.ax);
    w10[i] = __fmul_rn(s.ay, bx);
    w11[i] = __fmul_rn(s.ay, s.ax);
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

// A block walks tiles blockIdx.x, + gridDim.x, ... (tile_pixel).
template <typename T, typename F>
__global__ void __launch_bounds__(RESAMPLE_THREADS, RESAMPLE_MIN_BLOCKS)
resample2d_kernel(const T* __restrict__ x, const F* __restrict__ flow,
                  T* __restrict__ out, int batch, int channels, int height,
                  int width) {
  const int tiles_x = (width - 1) / RESAMPLE_TILE_W + 1;
  const int per_image = tiles_x * ((height - 1) / RESAMPLE_TILE_ROWS + 1);
  const int64_t n_tiles = (int64_t)per_image * batch;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int64_t b;
    int y, x0;
    tile_pixel(t, tiles_x, per_image, RESAMPLE_TILE_W, &b, &y, &x0);
    if (y < height && x0 < width) {
      warp_pixels<T, F>(x, flow, out, b, y, x0, channels, height, width);
    }
  }
}

// The blocks of `kernel` the current device holds at once (its SMs times
// the blocks of the kernel an SM takes), asked of the runtime once per
// device and kept in `known` (0 until asked).
template <typename K>
static cudaError_t one_wave(K kernel, int* known, long long* blocks) {
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
        &per_sm, kernel, RESAMPLE_THREADS, 0);
  }
  if (err != cudaSuccess) return err;
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  if (kept) known[device] = n;
  *blocks = n;
  return cudaSuccess;
}

// `kernel` on a grid of one wave, or of one block a tile where there are
// fewer tiles
template <typename... P, typename... A>
static cudaError_t launch_tiles(void (*kernel)(P...), int* known,
                                long long tiles, cudaStream_t stream,
                                A... args) {
  long long blocks = 0;
  const cudaError_t err = one_wave(kernel, known, &blocks);
  if (err != cudaSuccess) return err;
  if (tiles < blocks) blocks = tiles;
  kernel<<<(unsigned)blocks, RESAMPLE_THREADS, 0, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, typename F>
static cudaError_t launch(const void* x, const void* flow, void* out,
                          long long batch, long long channels, long long height,
                          long long width, long long tiles,
                          cudaStream_t stream) {
  static int known[RESAMPLE_MAX_DEVICES];
  return launch_tiles(resample2d_kernel<T, F>, known, tiles, stream,
                      static_cast<const T*>(x), static_cast<const F*>(flow),
                      static_cast<T*>(out), (int)batch, (int)channels,
                      (int)height, (int)width);
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
// when dx is asked for, w_k g added into each of the four corners with
// fp32 atomics into an fp32 buffer that the wrapper zeroes and casts to
// x's type.
//
// Bound: device-memory bytes. x, g and flow read once and dflow written
// once is (2 C e + 4 f) B H W bytes (e the element size of x and g, f of
// flow and dflow), plus C B H W (4 + e) bytes for dx's fp32 buffer and
// its cast when dx is asked for; at most ~60 flops a pixel and channel.
//
// dflow alone (the training path's call: the previous frame is detached)
// is the forward's problem with one more stream, so it has the forward's
// layout: two pixels a thread 32 columns apart, 64 x 8 tiles of one warp
// a row, a grid of one wave walking the tiles, at most 64 registers and
// no spills; the corners of RESAMPLE_BWD_PLANES planes and those planes'
// g loads are issued before the first is used (one plane: three planes'
// 30 loads a thread spilled past 64 registers and measured slower, two
// no faster), and the flow, g and dflow go by the evict-first hints. That kernel carries no atomics (the
// template flag DX), so no dx store stands between its loads. Its sums
// run in the plain version's order with the round-to-nearest
// intrinsics: dflow equals the plain version bit for bit, with or
// without dx.
//
// dx costs contention, not the number of atomics: a flow that sends
// pixels out of the frame clamps all their corners onto the few pixels of
// its border (onto one of the frame's four corner pixels, for a pixel far
// out on both axes), and atomics onto one address serialise in the L2.
// The dx kernel takes one pixel a thread (RESAMPLE_DX_PIXELS: the lane
// groups below take registers; two pixels measured slower) in 32 x 8
// tiles, one plane at a time (RESAMPLE_DX_PLANES), and cuts the atomics:
// - a pixel's coincident corners (an axis clamped: sx or sy 0) are one
//   address: their weights are added once a pixel, and one term a plane
//   goes out (RESAMPLE_DX_MERGE);
// - the edge lanes of a warp (a corner on the frame's border ring, where
//   the clamped samples land) whose corner k falls on the same address
//   (__match_any_sync on its offset among the edge lanes, once a pixel,
//   the same for every plane) sum their terms by shuffles, and the
//   group's lowest lane issues one atomic (RESAMPLE_DX_WARP_SUM). A lane
//   whose corners are inside the ring takes no part: there no address
//   piles up under a flow of a few pixels, and the match instruction is
//   slow (with every lane matched, the smooth flow's dx took twice as
//   long). Only a warp with a group pays for the sums: the flag is
//   warp-uniform;
// - a lane's corners 01 and 11 are most often the next lane's 00 and 10
//   (a smooth flow): the next lane adds them in, one shuffle each, and
//   one atomic goes out for the two (RESAMPLE_DX_NEIGHBOURS);
// - a zero term (a zero weight: an integer flow's corners 01, 10 and 11)
//   issues no atomic: the buffer starts at +0, and adding +-0 to it
//   changes no value.
// An atomic whose result is unused compiles to a RED. Each choice is
// measured against its alternatives by scripts/torch_kernel_probe.py
// (--probes resample2d_bwd). dx's sums run in
// another order than the plain version's, which changes from run to run
// (the atomics'); it is held to the plain version element by element
// against the magnitude of the terms summed.

#define RESAMPLE_BWD_PLANES 1     // dflow: channel planes in flight
#define RESAMPLE_DX_PIXELS 1      // dx: pixels a thread, 32 columns apart
#define RESAMPLE_DX_PLANES 1      // dx: channel planes in flight
#define RESAMPLE_DX_MERGE 1       // a pixel's coincident corners: one term
#define RESAMPLE_DX_WARP_SUM 1    // a warp's lanes on one address: one atomic
#define RESAMPLE_DX_NEIGHBOURS 1  // a lane's corners 01, 11 in the next lane's

// The sum of v over the lanes of `peers` (this lane's group), in the
// group's lowest lane; the other lanes end with partial sums. A tree:
// each round every lane adds the value of the next remaining lane of its
// group above it, then the lanes of odd rank leave, so the largest
// group's size sets the rounds (log2). Every lane of the warp calls it.
__device__ __forceinline__ float group_sum(unsigned peers, float v, int lane) {
  unsigned above = peers & (0xfffffffeu << lane);
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  while (__any_sync(0xffffffffu, above != 0u)) {
    const int next = __ffs(above) - 1;  // -1 when none is left
    const float t = __shfl_sync(0xffffffffu, v, next < 0 ? lane : next);
    if (next >= 0) v = __fadd_rn(v, t);
    above &= ~__ballot_sync(0xffffffffu, rank & 1u);
    rank >>= 1;
  }
  return v;
}

// the offset of corner k (00, 01, 10, 11) of a sample in its plane
__device__ __forceinline__ int64_t corner_offset(const Sample& s, int k) {
  return s.o00 + ((k & 1) ? s.sx : 0) + ((k & 2) ? s.sy : 0);
}

// one thread's pixels (as warp_pixels'), all channel planes: dflow, and
// with DX the dx terms; with DX every lane of the warp calls it (a lane
// past the row's end carries zero terms)
template <typename T, typename F, bool DX>
__device__ __forceinline__ void bwd_pixels(
    const T* __restrict__ x, const F* __restrict__ flow,
    const T* __restrict__ g, F* __restrict__ dflow, float* __restrict__ dx,
    int64_t b, int y, int x0, int channels, int height, int width) {
  constexpr int PX = DX ? RESAMPLE_DX_PIXELS : RESAMPLE_PIXELS;
  constexpr int CG = DX ? RESAMPLE_DX_PLANES : RESAMPLE_BWD_PLANES;
  constexpr int STRIDE = RESAMPLE_STRIDE;
  const int lane = threadIdx.x & 31;
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
  Sample s[PX];
  float bx[PX], by[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    s[i] = sample_at(x0 + STRIDE * i, y, fx[i], fy[i], height, width);
    bx[i] = __fsub_rn(1.f, s[i].ax);
    by[i] = __fsub_rn(1.f, s[i].ay);
  }

  // DX: each corner's weight (a pixel's coincident corners added into
  // one); the edge lanes whose corner k falls on this edge lane's (a lane
  // alone where its corners are inside the border ring), and whether any
  // lane of the warp has company (warp-uniform); whether corner 01 / 11
  // of the lane to the left is this lane's 00 / 10 (from_left), and this
  // lane's 01 / 11 the right one's 00 / 10 (to_right)
  float w[PX][4];
  unsigned peers[PX][4];
  bool from_left[PX][2], to_right[PX][2];
  bool grouped = false;
  if constexpr (DX) {
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      w[i][0] = __fmul_rn(by[i], bx[i]);
      w[i][1] = __fmul_rn(by[i], s[i].ax);
      w[i][2] = __fmul_rn(s[i].ay, bx[i]);
      w[i][3] = __fmul_rn(s[i].ay, s[i].ax);
      if (RESAMPLE_DX_MERGE && s[i].sx == 0) {
        w[i][0] = __fadd_rn(w[i][0], w[i][1]);
        w[i][2] = __fadd_rn(w[i][2], w[i][3]);
        w[i][1] = w[i][3] = 0.f;
      }
      if (RESAMPLE_DX_MERGE && s[i].sy == 0) {
        w[i][0] = __fadd_rn(w[i][0], w[i][2]);
        w[i][1] = __fadd_rn(w[i][1], w[i][3]);
        w[i][2] = w[i][3] = 0.f;
      }
      // corners on the frame's border ring: where clamped samples pile up
      const bool edge = s[i].x0 == 0 || s[i].y0 == 0 ||
                        s[i].x0 + s[i].sx == width - 1 ||
                        s[i].y0 + (s[i].sy != 0) == height - 1;
      const unsigned edge_lanes = __ballot_sync(0xffffffffu, edge);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        peers[i][k] = 1u << lane;
        if (RESAMPLE_DX_WARP_SUM && edge) {
          peers[i][k] = __match_any_sync(
              edge_lanes, (unsigned long long)corner_offset(s[i], k));
        }
        grouped |= peers[i][k] != 1u << lane;
      }
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        const long long mine0 = corner_offset(s[i], 2 * row);
        const long long mine1 = corner_offset(s[i], 2 * row + 1);
        const long long left1 = __shfl_up_sync(0xffffffffu, mine1, 1);
        const long long right0 = __shfl_down_sync(0xffffffffu, mine0, 1);
        from_left[i][row] = RESAMPLE_DX_NEIGHBOURS && lane > 0 && left1 == mine0;
        to_right[i][row] = RESAMPLE_DX_NEIGHBOURS && lane < 31 && right0 == mine1;
      }
    }
    grouped = __any_sync(0xffffffffu, grouped);
  }

  const T* xb = x + b * channels * plane;
  const T* gb = g + b * channels * plane + r;
  float dfx[PX], dfy[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) dfx[i] = dfy[i] = 0.f;
  for (int c = 0; c < channels; c += CG) {
    // every corner and g of the group's planes first, then the sums
    float v[CG][PX][4], gv[CG][PX];
#pragma unroll
    for (int p = 0; p < CG; ++p) {
      if (c + p >= channels) continue;
      const T* xc = xb + (int64_t)(c + p) * plane;
      const T* gc = gb + (int64_t)(c + p) * plane;
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        const T* q = xc + s[i].o00;
        v[p][i][0] = gather_f(q);
        v[p][i][1] = gather_f(q + s[i].sx);
        v[p][i][2] = gather_f(q + s[i].sy);
        v[p][i][3] = gather_f(q + s[i].sy + s[i].sx);
        gv[p][i] = in[i] ? load_f(gc + STRIDE * i) : 0.f;
      }
    }
#pragma unroll
    for (int p = 0; p < CG; ++p) {
      if (c + p >= channels) continue;
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        const float tx = __fadd_rn(
            __fmul_rn(by[i], __fsub_rn(v[p][i][1], v[p][i][0])),
            __fmul_rn(s[i].ay, __fsub_rn(v[p][i][3], v[p][i][2])));
        const float ty = __fadd_rn(
            __fmul_rn(bx[i], __fsub_rn(v[p][i][2], v[p][i][0])),
            __fmul_rn(s[i].ax, __fsub_rn(v[p][i][3], v[p][i][1])));
        dfx[i] = __fadd_rn(dfx[i], __fmul_rn(gv[p][i], tx));
        dfy[i] = __fadd_rn(dfy[i], __fmul_rn(gv[p][i], ty));
      }
      if constexpr (DX) {
        float* dc = dx + (b * channels + c + p) * plane;
#pragma unroll
        for (int i = 0; i < PX; ++i) {
          // each term goes out once: a lane's 01 / 11 in the next lane's
          // 00 / 10, then a group's terms in its lowest lane
          float t[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) t[k] = __fmul_rn(w[i][k], gv[p][i]);
#pragma unroll
          for (int row = 0; row < 2; ++row) {
            const float up = __shfl_up_sync(0xffffffffu, t[2 * row + 1], 1);
            if (from_left[i][row]) t[2 * row] = __fadd_rn(t[2 * row], up);
            if (to_right[i][row]) t[2 * row + 1] = 0.f;
          }
          if (grouped) {
#pragma unroll
            for (int k = 0; k < 4; ++k) t[k] = group_sum(peers[i][k], t[k], lane);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (lane == __ffs(peers[i][k]) - 1 && t[k] != 0.f) {
              atomicAdd(dc + corner_offset(s[i], k), t[k]);
            }
          }
        }
      }
    }
  }
  F* db = dflow + b * 2 * plane + r;
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    if (in[i]) {
      store_f(db + STRIDE * i, dfx[i]);
      store_f(db + plane + STRIDE * i, dfy[i]);
    }
  }
}

// Tiles of 32 columns a pixel a thread (tile_pixel): the forward's for
// dflow alone. With DX every lane of a row's warp takes part in its votes
// and shuffles: the row's warp enters whole.
template <typename T, typename F, bool DX>
__global__ void __launch_bounds__(RESAMPLE_THREADS, RESAMPLE_MIN_BLOCKS)
resample2d_bwd_kernel(const T* __restrict__ x, const F* __restrict__ flow,
                      const T* __restrict__ g, F* __restrict__ dflow,
                      float* __restrict__ dx, int batch, int channels,
                      int height, int width) {
  constexpr int TILE_W = DX ? 32 * RESAMPLE_DX_PIXELS : RESAMPLE_TILE_W;
  const int tiles_x = (width - 1) / TILE_W + 1;
  const int per_image = tiles_x * ((height - 1) / RESAMPLE_TILE_ROWS + 1);
  const int64_t n_tiles = (int64_t)per_image * batch;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int64_t b;
    int y, x0;
    tile_pixel(t, tiles_x, per_image, TILE_W, &b, &y, &x0);
    if (y < height && (DX || x0 < width)) {
      bwd_pixels<T, F, DX>(x, flow, g, dflow, dx, b, y, x0, channels, height,
                           width);
    }
  }
}

template <typename T, typename F>
static cudaError_t launch_bwd(const void* x, const void* flow, const void* g,
                              void* dflow, void* dx, long long batch,
                              long long channels, long long height,
                              long long width, long long tiles,
                              cudaStream_t stream) {
  static int known[2][RESAMPLE_MAX_DEVICES];  // dflow alone, with dx
  const T* xt = static_cast<const T*>(x);
  const F* ft = static_cast<const F*>(flow);
  const T* gt = static_cast<const T*>(g);
  F* dft = static_cast<F*>(dflow);
  float* dxt = static_cast<float*>(dx);
  if (dx == nullptr) {
    return launch_tiles(resample2d_bwd_kernel<T, F, false>, known[0], tiles,
                        stream, xt, ft, gt, dft, dxt, (int)batch,
                        (int)channels, (int)height, (int)width);
  }
  return launch_tiles(resample2d_bwd_kernel<T, F, true>, known[1], tiles,
                      stream, xt, ft, gt, dft, dxt, (int)batch, (int)channels,
                      (int)height, (int)width);
}

// The tiles of tile_w columns of a (batch, channels, height, width) call
// into *tiles, or
// cudaErrorInvalidValue for a shape the kernels do not take: every size
// at least 1 and an int, and a tile's index within its image an int.
static cudaError_t tile_count(long long batch, long long channels,
                              long long height, long long width,
                              long long tile_w, long long* tiles) {
  if (batch < 1 || channels < 1 || height < 1 || width < 1 ||
      batch > 0x7fffffffLL || channels > 0x7fffffffLL ||
      height > 0x7fffffffLL || width > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const long long per_image = (width + tile_w - 1) / tile_w *
      ((height + RESAMPLE_TILE_ROWS - 1) / RESAMPLE_TILE_ROWS);
  if (per_image > 0x7fffffffLL) return cudaErrorInvalidValue;
  *tiles = per_image * batch;
  return cudaSuccess;
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
  long long tiles = 0;
  cudaError_t err =
      tile_count(batch, channels, height, width, RESAMPLE_TILE_W, &tiles);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaErrorInvalidValue;
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
  long long tiles = 0;
  const long long tile_w =
      dx == nullptr ? RESAMPLE_TILE_W : 32 * RESAMPLE_DX_PIXELS;
  cudaError_t err = tile_count(batch, channels, height, width, tile_w, &tiles);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaErrorInvalidValue;
  if (x_dtype == 0 && flow_dtype == 0) {
    err = launch_bwd<float, float>(x, flow, g, dflow, dx, batch, channels,
                                   height, width, tiles, s);
  } else if (x_dtype == 0 && flow_dtype == 1) {
    err = launch_bwd<float, __nv_bfloat16>(x, flow, g, dflow, dx, batch,
                                           channels, height, width, tiles, s);
  } else if (x_dtype == 1 && flow_dtype == 0) {
    err = launch_bwd<__nv_bfloat16, float>(x, flow, g, dflow, dx, batch,
                                           channels, height, width, tiles, s);
  } else if (x_dtype == 1 && flow_dtype == 1) {
    err = launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        x, flow, g, dflow, dx, batch, channels, height, width, tiles, s);
  }
  return (int)err;
}

const char* resample2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
