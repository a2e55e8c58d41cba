// FlowNetC cost volume (correlation), forward, for Hopper (sm_90a).
//
//   out[b, dyi * n_d + dxi, y, x] =
//       sum_c x1[b, c, y, x] * x2[b, c, y + dy, x + dx] / C
//
// with dy = -md + dyi * s2, dx = -md + dxi * s2, n_d = 2 md // s2 + 1
// (md = max_displacement, s2 = stride2; the grid of the JAX package's
// public op, arange(-md, md + 1, s2), also where s2 does not divide md),
// and x2 read as zero outside the frame (the reference zero-pads x2 by
// pad_size >= md, so no displacement reaches past the padding). kernel_size 1, stride1 1:
// the FlowNetC configuration. Tensors are NCHW: x1, x2 (B, C, H, W), out
// (B, n_d * n_d, H, W) in x1's type; sums are fp32.
//
// Replaces: imaginaire_tpu/ops/pallas/correlation_kernel.py,
// correlation_pallas (_kernel). The design is the one the JAX package pins
// as its `auto` path, _correlation_mxu (imaginaire_tpu/ops/correlation.py):
// for one (b, y, dy) the slab out[x, dxi] is a band of the matrix product
// P = A B with A[x, c] = x1[b, c, y, x] (M = output columns, K = channels)
// and B[c, v] = x2[b, c, y + dy, v] (N = window columns):
// out[x, dxi] = P[x, x - md + dxi s2] / C. Splitting the output columns
// by phase, x = x0 + s2 i + ph, makes the band contiguous in phase units
// (window column j = i + dxi), so an m16 tile of 16 same-phase columns
// needs 16 + n_d - 1 window columns: n_t = ceil((15 + n_d) / 8) n8 tiles
// (5 at FlowNetC's n_d = 21, of which 21 of 40 columns a row are kept).
//
// Bound: operations. One output is C multiply-adds: a FlowNetC call at
// 512x1024 ((1, 256, 64, 128), n_d = 21) is 925 M of them, 27.6 us on the
// CUDA cores at 67 TFLOP/s and 11.2 us as 3xTF32 on the tensor cores at
// 495 TFLOP/s (three products each), against 31.2 MB (9.3 us) of device
// memory. What the design does about it:
//
// - Tensor cores, exact to fp32: mma.sync.m16n8k8 TF32 with the 3xTF32
//   split (a = a_hi + a_lo, each rounded to TF32 as cvt.rna rounds; acc
//   += a_lo b_hi + a_hi b_lo + a_hi b_hi). Plain TF32 keeps 10 bits and
//   misses the 1e-5 fp32 gate; the split leaves ~2^-22 of each product.
//   bf16 inputs are exact in TF32, so they take the one product.
// - The split is made when a fragment is loaded from shared memory, not
//   at staging: cp.async copies bytes and cannot convert, so splitting
//   at staging would take another pass over shared memory, a barrier and
//   twice the space; at load time each A value splits once and feeds all
//   n_t x dys products of its k-step.
// - Reuse: a block owns `rows` output rows y of one phase of y (y, y + s2)
//   and `dys` consecutive vertical displacements, so its x2 rows overlap
//   (rows + dys - 1 of them for rows x dys slabs), one column tile of
//   16 s2 m_tiles outputs and one group of <= 25 horizontal
//   displacements; one warp owns one m16 tile of one phase of one row
//   for all its dys. Up to stride2 16 a block takes all s2 column phases
//   of its tile (at most 16 warps); above, the phases split into groups
//   of `phases`, one group a block: each block stages its tile's columns
//   as FlowNetC's does and computes and stores only its group's phases.
// - Staging: each channel chunk of the x1 rows and the x2 row windows is
//   copied with 16-byte cp.async (zero-filled outside the frame, 4-byte
//   copies where a group of 4 columns is not 16-byte aligned or straddles
//   the frame's edge) into a ring of `stages` buffers, so the next chunks
//   load while the current one multiplies (one barrier per chunk).
//   Shared rows are padded to 8 words mod 32: fragment loads are free of
//   bank conflicts at s2 = 1 and 2-way at s2 = 2 (16-byte-aligned rows
//   keep a column's bank parity, and s2 = 2 puts a fragment's 8 columns
//   on one parity, so no padding avoids it).
// - Epilogue: the band elements of the accumulators go through shared
//   memory, so each displacement plane's row segment is stored coalesced,
//   divided by C, in x1's type.
//
// The tile plan (tile width, phases, chunk, stages, window, shared memory,
// grid) is computed by the wrapper (imaginaire_tpu_torch/ops/correlation.py,
// tile_plan) and passed in; this file checks it for consistency. All
// device-memory offsets are 64-bit.
//
// The direct path. A tile whose columns do not fit shared memory even
// with one vertical displacement and the smallest ring (fp32 from
// stride2 65, where a tile is 1040 columns and its window several
// thousand) takes correlation_direct_fwd instead: one thread an output,
// a loop over the channels with fp32 fused multiply-adds, no staging.
// tile_plan chooses it by shape. It answers what the JAX package's
// public op answers at those strides, without the tiled path's speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define CORR_MAX_DYS 3
#define CORR_MAX_SMEM (227 * 1024)

struct Plan {  // the field order of ops/correlation.py PLAN_FIELDS
  int tile_w;        // output columns of a block: 16 s2 m_tiles
  int m_tiles;       // m16 tiles per phase
  int rows;          // output rows of a block (y, y + s2, ...)
  int dys;           // vertical displacements of a block
  int dx_groups;     // groups of horizontal displacements
  int dx_per_group;  // displacements of a group (<= 25)
  int n_tiles8;      // n8 tiles per m16 tile: ceil((15 + dx_per_group) / 8)
  int window;        // staged x2 columns: s2 (16 (m_tiles - 1) + 8 n_tiles8)
  int stride_x1;     // shared row stride of x1, elements
  int stride_x2;     // shared row stride of x2, elements
  int chunk;         // channels per stage (8, 16 or 32)
  int stages;        // ring depth (2 or 3)
  int threads;       // 32 rows phases m_tiles
  int smem_bytes;
  int x_tiles, y_blocks, dy_groups, grid_x;
  int phases;        // column phases of a block (s2 up to stride2 16)
  int phase_groups;  // blocks across the phases of a tile: ceil(s2 / phases)
};
#define PLAN_LEN 20

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one column of a group that is not a whole 16-byte copy: fp32 by a
// 4-byte cp.async (src-size 0 outside the frame), bf16 by a plain copy
__device__ __forceinline__ void copy_elem(float* dst, const float* row,
                                          int64_t g, int width) {
  const bool in = g >= 0 && g < width;
  cp_async4(dst, in ? row + g : row, in ? 4 : 0);
}
__device__ __forceinline__ void copy_elem(__nv_bfloat16* dst,
                                          const __nv_bfloat16* row, int64_t g,
                                          int width) {
  *dst = (g >= 0 && g < width) ? row[g] : __float2bfloat16_rn(0.f);
}

// columns g0 .. g0 + VEC - 1 of one row (row == nullptr: a channel past C
// or a row outside the frame, all zeros) into dst
template <typename T>
__device__ __forceinline__ void copy_group(T* dst, const T* row, int64_t g0,
                                           int width, const T* any) {
  constexpr int VEC = 16 / sizeof(T);
  if (row == nullptr || g0 + VEC <= 0 || g0 >= width) {
    cp_async16(dst, any, 0);  // zero fill
    return;
  }
  const T* src = row + g0;
  if (g0 >= 0 && g0 + VEC <= width &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src, 16);
    return;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) copy_elem(dst + j, row, g0 + j, width);
}

// v rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest on the
// 10-bit mantissa, ties away from zero), written as two integer ops: the
// cvt instruction measured ~6% slower in this kernel
// (scripts/torch_kernel_probe.py, variant cvt_round)
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ float smem_f(const float* p) { return *p; }
__device__ __forceinline__ float smem_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// d += a b for one m16n8k8 TF32 tile (fp32 accumulate)
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T, int NT>
__global__ void __launch_bounds__(512, 1)
correlation_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                   T* __restrict__ out, int channels, int height, int width,
                   int n_d, int max_disp, int s2, const Plan p) {
  constexpr bool kSplit = std::is_same<T, float>::value;  // bf16 is exact in TF32
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  // blockIdx.x -> (x tile, phase group, dx group, dy group, y block), x
  // tile fastest
  int bx = blockIdx.x;
  const int xt = bx % p.x_tiles;
  bx /= p.x_tiles;
  const int ph0 = (bx % p.phase_groups) * p.phases;  // the block's first phase
  bx /= p.phase_groups;
  const int gx = bx % p.dx_groups;
  bx /= p.dx_groups;
  const int dyg = bx % p.dy_groups;
  const int yb = bx / p.dy_groups;
  const int64_t b = blockIdx.y;

  const int x0 = xt * p.tile_w;
  const int gx0 = gx * p.dx_per_group;
  const int nx = min(p.dx_per_group, n_d - gx0);
  const int dyi0 = dyg * p.dys;
  const int ndy = min(p.dys, n_d - dyi0);
  const int py = yb % s2;
  const int y_base = py + s2 * p.rows * (yb / s2);   // row 0 of the block
  const int yy_base = y_base - max_disp + s2 * dyi0;  // x2 row of slot 0
  const int wx0 = x0 - max_disp + s2 * gx0;           // x2 column of window 0
  const int slots = p.rows + p.dys - 1;
  const int64_t plane = (int64_t)height * width;
  const T* x1_b = x1 + b * channels * plane;
  const T* x2_b = x2 + b * channels * plane;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_mt = p.phases * p.m_tiles;
  const int r = warp / n_mt;   // this warp's row of the block
  const int mt = warp % n_mt;
  const int ph = ph0 + mt % p.phases, m = mt / p.phases;  // phase, m16 tile
  const bool ph_ok = ph < s2;  // the last group of phases may be short
  const int y = y_base + s2 * r;
  bool unit_ok[CORR_MAX_DYS];
#pragma unroll
  for (int g = 0; g < CORR_MAX_DYS; ++g) {
    const int yy = yy_base + s2 * (r + g);
    unit_ok[g] = g < ndy && ph_ok && y < height && yy >= 0 && yy < height;
  }

  const int stage_elems = p.chunk * (p.rows * p.stride_x1 + slots * p.stride_x2);
  const int groups1 = p.tile_w / VEC, groups2 = p.window / VEC;

  // one stage: rows * chunk x1 rows, then slots * chunk x2 rows; a warp
  // copies whole rows (one index decode a row), its lanes the row's
  // 16-byte groups
  const int n_warps = p.threads >> 5;
  const int chunk_shift = __ffs(p.chunk) - 1;  // chunk is a power of two
  const int x1_rows = p.rows * p.chunk;
  auto stage = [&](int chunk_idx) {
    T* s = smem + (chunk_idx % p.stages) * stage_elems;
    const int c0 = chunk_idx * p.chunk;
    const int kc8 = min(p.chunk, (channels - c0 + 7) & ~7);  // rows to fill
    for (int ri = warp; ri < x1_rows + slots * p.chunk; ri += n_warps) {
      const bool is_x1 = ri < x1_rows;
      const int rj = is_x1 ? ri : ri - x1_rows;
      const int cc = rj & (p.chunk - 1), q = rj >> chunk_shift;
      // x1: the block's row q; x2: slot q (yy = y + dy of its units)
      const int yrow = is_x1 ? y_base + s2 * q : yy_base + s2 * q;
      if (cc >= kc8 || yrow < 0 || yrow >= height) continue;  // never read
      const T* row = c0 + cc < channels
          ? (is_x1 ? x1_b : x2_b) + (int64_t)(c0 + cc) * plane + (int64_t)yrow * width
          : nullptr;
      T* dst = is_x1 ? s + rj * p.stride_x1
                     : s + x1_rows * p.stride_x1 + rj * p.stride_x2;
      const int groups = is_x1 ? groups1 : groups2;
      const int64_t g0 = is_x1 ? x0 : wx0;
      for (int grp = lane; grp < groups; grp += 32) {
        copy_group(dst + grp * VEC, row, g0 + grp * VEC, width, x1);
      }
    }
  };

  float acc[CORR_MAX_DYS][NT][4];
#pragma unroll
  for (int g = 0; g < CORR_MAX_DYS; ++g)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][t][e] = 0.f;

  const int n_chunks = (channels + p.chunk - 1) / p.chunk;
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < n_chunks) stage(s);
    cp_async_commit();
  }
  // this lane's fragment columns (A: rows gid and gid + 8 of the m16 tile;
  // B: column gid of each n8 tile), in staged-column units
  const int col_a = s2 * (16 * m + gid) + ph;
  for (int ch = 0; ch < n_chunks; ++ch) {
    // at most stages - 2 newer chunks still in flight
    if (p.stages == 2) cp_async_wait<0>(); else cp_async_wait<1>();
    __syncthreads();  // chunk ch landed; slot (ch - 1) % stages is free
    if (ch + p.stages - 1 < n_chunks) stage(ch + p.stages - 1);
    cp_async_commit();
    if (!(unit_ok[0] || unit_ok[1] || unit_ok[2])) continue;

    const T* s = smem + (ch % p.stages) * stage_elems;
    const T* sa = s + r * p.chunk * p.stride_x1;
    const T* sb0 = s + p.rows * p.chunk * p.stride_x1;
    const int ksteps = min(p.chunk, (channels - ch * p.chunk + 7) & ~7) / 8;
    for (int ks = 0; ks < ksteps; ++ks) {
      // A fragment: (row gid | gid + 8) x (k tig | tig + 4)
      const T* a_k0 = sa + (8 * ks + tig) * p.stride_x1 + col_a;
      const T* a_k4 = a_k0 + 4 * p.stride_x1;
      const float av[4] = {smem_f(a_k0), smem_f(a_k0 + 8 * s2),
                           smem_f(a_k4), smem_f(a_k4 + 8 * s2)};
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a_hi[e] = kSplit ? to_tf32(av[e]) : __float_as_uint(av[e]);
        a_lo[e] = kSplit ? to_tf32(av[e] - __uint_as_float(a_hi[e])) : 0u;
      }
#pragma unroll
      for (int g = 0; g < CORR_MAX_DYS; ++g) {
        if (!unit_ok[g]) continue;
        const T* sb = sb0 + (r + g) * p.chunk * p.stride_x2 +
                      (8 * ks + tig) * p.stride_x2 + col_a;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float bv0 = smem_f(sb + 8 * s2 * t);
          const float bv1 = smem_f(sb + 8 * s2 * t + 4 * p.stride_x2);
          if (kSplit) {
            const uint32_t b0h = to_tf32(bv0), b1h = to_tf32(bv1);
            const uint32_t b0l = to_tf32(bv0 - __uint_as_float(b0h));
            const uint32_t b1l = to_tf32(bv1 - __uint_as_float(b1h));
            mma_tf32(acc[g][t], a_lo, b0h, b1h);
            mma_tf32(acc[g][t], a_hi, b0l, b1l);
            mma_tf32(acc[g][t], a_hi, b0h, b1h);
          } else {
            mma_tf32(acc[g][t], a_hi, __float_as_uint(bv0), __float_as_uint(bv1));
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the epilogue

  // the band of each accumulator tile into E[r][g][dxl][column] (fp32)
  float* E = reinterpret_cast<float*>(smem_raw);
  const int dxg = p.dx_per_group;
  if (y < height && ph_ok) {
#pragma unroll
    for (int g = 0; g < CORR_MAX_DYS; ++g) {
      if (g >= ndy) continue;
      float* eg = E + (r * p.dys + g) * dxg * p.tile_w;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = gid + 8 * (e >> 1);  // i within the m16 tile
          const int dxl = 8 * t + 2 * tig + (e & 1) - row;  // j - i
          if (dxl >= 0 && dxl < nx) {
            eg[dxl * p.tile_w + s2 * (16 * m + row) + ph] = acc[g][t][e];
          }
        }
      }
    }
  }
  __syncthreads();
  const float inv_c = 1.f / (float)channels;
  for (int er = warp; er < p.rows * p.dys * dxg; er += n_warps) {
    const int dxl = er % dxg, g = (er / dxg) % p.dys, rr = er / (dxg * p.dys);
    const int yr = y_base + s2 * rr;
    if (dxl >= nx || g >= ndy || yr >= height) continue;
    const int64_t ch = b * n_d * n_d + (int64_t)(dyi0 + g) * n_d + gx0 + dxl;
    T* o = out + ch * plane + (int64_t)yr * width + x0;
    const float* e = E + er * p.tile_w;
    for (int col = lane; col < p.tile_w && x0 + col < width; col += 32) {
      // the columns of this block's phases (all of them up to stride2 16)
      if (p.phases == s2 || (unsigned)(col % s2 - ph0) < (unsigned)p.phases) {
        store_f(o + col, e[col] * inv_c);
      }
    }
  }
}

template <typename T, int NT>
static cudaError_t launch_nt(const void* x1, const void* x2, void* out,
                             long long batch, long long channels,
                             long long height, long long width, int n_d,
                             int max_disp, int stride2, const Plan& p,
                             cudaStream_t stream) {
  auto kernel = correlation_kernel<T, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)p.grid_x, (unsigned)batch);
  kernel<<<grid, p.threads, p.smem_bytes, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2), static_cast<T*>(out),
      (int)channels, (int)height, (int)width, n_d, max_disp, stride2, p);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch(const void* x1, const void* x2, void* out,
                          long long batch, long long channels, long long height,
                          long long width, int n_d, int max_disp, int stride2,
                          const Plan& p, cudaStream_t stream) {
  switch (p.n_tiles8) {
#define CORR_CASE(NT)                                                        \
  case NT:                                                                   \
    return launch_nt<T, NT>(x1, x2, out, batch, channels, height, width, n_d, \
                            max_disp, stride2, p, stream);
    CORR_CASE(2)
    CORR_CASE(3)
    CORR_CASE(4)
    CORR_CASE(5)
#undef CORR_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// what the kernel relies on, not how tile_plan chose it: the warps and
// fragment columns fit the tile and the staged rows, the shared memory
// holds the ring and the epilogue, and the grid covers every output
static bool plan_ok(const Plan& p, long long height, long long width, int n_d,
                    int stride2, int esize) {
  const int vec = 16 / esize;
  const long long stage_bytes = (long long)p.chunk * esize *
      (p.rows * p.stride_x1 + (p.rows + p.dys - 1) * p.stride_x2);
  const long long epilogue = 4LL * p.rows * p.dys * p.dx_per_group * p.tile_w;
  const bool tile =
      p.m_tiles >= 1 && p.rows >= 1 && p.tile_w == 16 * stride2 * p.m_tiles &&
      p.phases >= 1 && p.phases <= stride2 && p.phase_groups >= 1 &&
      (long long)p.phases * p.phase_groups >= stride2 &&
      p.threads == 32 * p.rows * p.phases * p.m_tiles && p.threads <= 512 &&
      p.dys >= 1 && p.dys <= CORR_MAX_DYS && p.dx_per_group >= 1 &&
      p.dx_per_group <= 8 * p.n_tiles8 - 15 &&
      p.window >= stride2 * (16 * (p.m_tiles - 1) + 8 * p.n_tiles8) &&
      p.window % vec == 0 && p.stride_x1 >= p.tile_w &&
      p.stride_x2 >= p.window && p.stride_x1 % vec == 0 &&
      p.stride_x2 % vec == 0 &&
      (p.chunk == 8 || p.chunk == 16 || p.chunk == 32) &&
      (p.stages == 2 || p.stages == 3);
  const bool smem = p.stages * stage_bytes <= p.smem_bytes &&
                    epilogue <= p.smem_bytes && p.smem_bytes <= CORR_MAX_SMEM;
  const bool covers =
      (long long)p.x_tiles * p.tile_w >= width &&
      (long long)p.dx_groups * p.dx_per_group >= n_d &&
      (long long)p.dy_groups * p.dys >= n_d && p.y_blocks % stride2 == 0 &&
      (long long)p.y_blocks * p.rows >= height &&
      (long long)p.grid_x == (long long)p.x_tiles * p.phase_groups *
                                 p.dx_groups * p.dy_groups * p.y_blocks;
  return tile && smem && covers;
}

// One thread an output (b, dyi * n_d + dxi, y, x): the sum over the
// channels of x1 * x2 at the displaced pixel, zero outside the frame,
// divided by C. Consecutive threads take consecutive x.
template <typename T>
__global__ void __launch_bounds__(256)
correlation_direct_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                          T* __restrict__ out, long long channels,
                          long long height, long long width, int n_d,
                          int max_disp, int stride2, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long x = idx % width;
  long long rest = idx / width;
  const long long y = rest % height;
  rest /= height;
  const int d = (int)(rest % ((long long)n_d * n_d));
  const long long b = rest / ((long long)n_d * n_d);
  const long long yy = y - max_disp + (long long)(d / n_d) * stride2;
  const long long xx = x - max_disp + (long long)(d % n_d) * stride2;
  float acc = 0.f;
  if (yy >= 0 && yy < height && xx >= 0 && xx < width) {
    const long long hw = height * width;
    const T* p1 = x1 + b * channels * hw + y * width + x;
    const T* p2 = x2 + b * channels * hw + yy * width + xx;
    for (long long c = 0; c < channels; ++c) {
      acc = fmaf(smem_f(p1 + c * hw), smem_f(p2 + c * hw), acc);
    }
  }
  store_f(out + idx, acc / (float)channels);
}

extern "C" {

// The direct path (see the head of this file): x1, x2, out and dtype as
// correlation_fwd's; one thread an output. Launches on `stream` and
// returns the CUDA error code of the launch; it does not synchronise.
int correlation_direct_fwd(const void* x1, const void* x2, void* out,
                           long long batch, long long channels,
                           long long height, long long width, int max_disp,
                           int stride2, int dtype, void* stream) {
  if (batch < 1 || channels < 1 || height < 1 || width < 1 || max_disp < 0 ||
      stride2 < 1 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_d = 2 * max_disp / stride2 + 1;
  const long long total = batch * n_d * n_d * height * width;
  const long long blocks = (total + 255) / 256;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    correlation_direct_kernel<float><<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const float*>(x1), static_cast<const float*>(x2),
        static_cast<float*>(out), channels, height, width, n_d, max_disp,
        stride2, total);
  } else {
    correlation_direct_kernel<__nv_bfloat16><<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x1),
        static_cast<const __nv_bfloat16*>(x2),
        static_cast<__nv_bfloat16*>(out), channels, height, width, n_d,
        max_disp, stride2, total);
  }
  return (int)cudaGetLastError();
}

// x1, x2: NCHW-contiguous (batch, channels, height, width); out:
// NCHW-contiguous (batch, n_d * n_d, height, width) with
// n_d = 2 * max_disp / stride2 + 1 (integer division); all of dtype
// (0 = float32, 1 = bfloat16). max_disp >= 0, stride2 >= 1.
// plan: PLAN_LEN ints in the order of struct Plan, from the wrapper's
// tile_plan. Launches on `stream` and returns the CUDA error code of the
// launch (0 on success); it does not synchronise.
int correlation_fwd(const void* x1, const void* x2, void* out, long long batch,
                    long long channels, long long height, long long width,
                    int max_disp, int stride2, int dtype, const int* plan,
                    void* stream) {
  if (batch < 1 || batch > 65535 || channels < 1 || height < 1 || width < 1 ||
      channels > 0x7fffffffLL || height > 0x7fffffffLL ||
      width > 0x7fffffffLL || max_disp < 0 || stride2 < 1 ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Plan p;
  int* fields = reinterpret_cast<int*>(&p);
  for (int i = 0; i < PLAN_LEN; ++i) fields[i] = plan[i];
  const int n_d = 2 * max_disp / stride2 + 1;
  if (!plan_ok(p, height, width, n_d, stride2, dtype == 0 ? 4 : 2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<float>(x1, x2, out, batch, channels, height, width, n_d,
                              max_disp, stride2, p, s);
  }
  return (int)launch<__nv_bfloat16>(x1, x2, out, batch, channels, height, width,
                                    n_d, max_disp, stride2, p, s);
}

const char* correlation_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
