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
// each (b, c) plane is one contiguous run of H*W elements, reduced and
// applied by one group of threads; no statistic leaves the group except
// mean and rstd.
//
// Bound: device-memory bytes. The forward's least traffic is x, every
// gamma_i and beta_i read once and out written once, (2 + 2 n_pairs)
// elements an element of x; the backward's is x, g and every gamma_i
// read and dx and dgamma written, (4 + n_pairs) elements. Both do a
// handful of flops an element, far below the card's operations-per-byte
// balance. What held the first design (one block a plane, scalar loads,
// a shared-memory cache) at 19-57% of that bound on the H100, and what
// this design does about it:
//
// - Bytes in flight. Scalar 2-byte loads left bf16 hardly faster than
//   fp32. A thread now issues every 16-byte load of its share of x (8
//   bf16 or 4 fp32; the backward also g and gamma_0) before the first
//   reduction, and streams gamma, beta, out, dx and dgamma 16 bytes at a
//   time. The vector paths need every pointer 16-byte aligned and H*W a
//   multiple of the vector; a ragged plane or a misaligned view takes
//   the scalar stream path (one element a load), chosen by the wrapper's
//   plan, never after a failed launch.
// - Latency of the reductions. Small planes paid two block barriers for
//   256-1024 elements. A plane of at most 128 vectors (16x16; 32x32 in
//   bf16) is now one warp's: several planes a block, sums by shuffles
//   only, no barrier and no shared memory (PATH_WARP).
// - Occupancy. The backward's fp32 shared-memory cache of a 128x128
//   plane (128 KiB) left one block an SM. A larger plane is now held in
//   registers in its own type (bf16 packed two to a register), one block
//   a plane, 4 vectors a thread (PATH_BLOCK): the forward keeps x; the
//   backward keeps x, g and gamma_0 and recomputes x_hat and g_hat in
//   fp32 from them. One block holds 4096 vectors forward (1024 threads)
//   and 2048 backward (512 threads, the register bound of three cached
//   arrays), so the fp32 backward at 128x128 splits its plane over a
//   thread-block cluster of 2, whose partial sums meet in distributed
//   shared memory; it beats re-reading the plane there. Wherever one
//   block holds the plane a cluster lost to it (its barrier costs more
//   than a block's), so no other plan takes one. A plane larger than the
//   block path holds is re-read for the later passes (PATH_STREAM).
// - Host cost. Nothing uses dynamic shared memory, so no launch sets a
//   function attribute; cudaLaunchKernelEx launches every path.
//
// The plan (path, vector width, vectors a thread holds, cluster size,
// threads, planes a block, grid) is chosen by shape in Python
// (imaginaire_tpu_torch/ops/spade_modulation.py, modulation_plan) and
// passed in; plan_ok checks what the kernels rely on and the C interface
// refuses any other plan.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

#define SPADE_MAX_PAIRS 4
#define SPADE_STREAM_THREADS 512
#define SPADE_PLAN_LEN 7
#define SPADE_BLOCK_NV 4  // vectors a thread holds on PATH_BLOCK

enum { PATH_WARP = 0, PATH_BLOCK = 1, PATH_STREAM = 2 };

struct Plan {  // the field order of ops/spade_modulation.py PLAN_FIELDS
  int path, vec, per_thread, cluster, threads, planes_per_block, grid;
};

struct PairPtrs {
  const void* gamma[SPADE_MAX_PAIRS];
  const void* beta[SPADE_MAX_PAIRS];
};

struct FwdArgs {
  const void* x;
  PairPtrs pairs;
  int n_pairs;
  void* out;
  float* mean;
  float* rstd;
  long long n_planes;
  long long plane;  // elements a plane
  float inv_plane;
  float eps;
};

struct BwdArgs {
  const void* x;
  PairPtrs pairs;
  int n_pairs;
  const float* mean;
  const float* rstd;
  const void* g;
  void* dx;
  void* dgamma;
  long long n_planes;
  long long plane;
  float inv_plane;
};

// The most threads a block of a cached kernel may have: its registers
// hold `arrays` arrays of NV 16-byte vectors (4 registers each), and the
// bound keeps that cache and the working set within the register file
// without spilling (1024 threads: 64 registers a thread, 512: 128).
// modulation_plan reads the same table.
__host__ __device__ constexpr int max_threads(int nv, int arrays) {
  return nv * arrays * 4 <= 16 ? 1024 : 512;
}

// VEC elements of T moved as one load or store.
template <typename T, int VEC>
struct Pack;

template <>
struct Pack<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ void unpack(Raw r, float* f) { f[0] = r; }
  static __device__ __forceinline__ Raw pack(const float* f) { return f[0]; }
};

template <>
struct Pack<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ void unpack(Raw r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Pack<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ void unpack(Raw r, float* f) {
    f[0] = __bfloat162float(r);
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return __float2bfloat16_rn(f[0]);
  }
};

// two bf16 of one 32-bit word, element 0 in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <>
struct Pack<__nv_bfloat16, 8> {
  using Raw = uint4;  // 8 bf16, packed two to a register
  static __device__ __forceinline__ void unpack(Raw r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);  // bf16 -> fp32 is exact
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                      pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  }
};

template <typename T, int VEC>
__device__ __forceinline__ typename Pack<T, VEC>::Raw load_vec(const T* p, long long v) {
  return reinterpret_cast<const typename Pack<T, VEC>::Raw*>(p)[v];
}
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, long long v, const float* f) {
  reinterpret_cast<typename Pack<T, VEC>::Raw*>(p)[v] = Pack<T, VEC>::pack(f);
}

// v rounded to bf16 (nearest even) and widened back to fp32
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The modulate half of one element in T's arithmetic.
template <typename T>
struct Mod;

template <>
struct Mod<float> {
  static __device__ __forceinline__ float add(float a, float b) { return a + b; }
  static __device__ __forceinline__ float apply(float xhat, float gs, float bs) {
    return xhat * (1.f + gs) + bs;
  }
};

template <>
struct Mod<__nv_bfloat16> {
  // each step an fp32 operation on bf16 values, rounded to bf16; the
  // separate roundings also keep the compiler from contracting the
  // product and the add into one fused multiply-add
  static __device__ __forceinline__ float add(float a, float b) { return round_bf16(a + b); }
  static __device__ __forceinline__ float apply(float xhat, float gs, float bs) {
    const float y = round_bf16(xhat);
    const float prod = round_bf16(y * round_bf16(1.f + gs));
    return prod + bs;  // rounded by the bf16 store
  }
};

// Butterfly sum over the warp. Every lane ends with the same bits: at
// each step the two lanes of a pair add the same two partials.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Sum of each v[k] over the plane's group of threads, returned to every
// thread of the group in the same bits: CL = 0, a warp (shuffles only);
// CL = 1, the block (one barrier); CL > 1, a cluster of CL blocks whose
// warps' partials meet through distributed shared memory (one cluster
// barrier). `slot` holds one partial per warp of this block and is used
// by one call only; warps * CL <= 32.
template <int CL, int N>
__device__ __forceinline__ void group_sum(float (&v)[N], float (*slot)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
  if constexpr (CL >= 1) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < N; ++k) slot[warp][k] = v[k];
    }
    if constexpr (CL == 1) {
      __syncthreads();
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] = warp_sum(lane < warps ? slot[lane][k] : 0.f);
    } else {
      cluster_arrive();
      cluster_wait();
      cg::cluster_group cluster = cg::this_cluster();
      const int rank = lane / warps, w = lane - rank * warps;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float p = 0.f;
        if (lane < warps * CL) p = *cluster.map_shared_rank(&slot[w][k], rank);
        v[k] = warp_sum(p);
      }
    }
  }
}

// The plane a thread works on and its place in the plane's group.
template <int CL>
struct Group {
  long long plane;  // index of the plane
  int index;        // this thread's index in the group
  int size;         // threads of the group
  __device__ __forceinline__ Group() {
    if constexpr (CL == 0) {
      plane = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
      index = threadIdx.x & 31;
      size = 32;
    } else {
      const int rank = CL == 1 ? 0 : (int)cg::this_cluster().block_rank();
      plane = blockIdx.x / CL;
      index = rank * blockDim.x + threadIdx.x;
      size = CL * blockDim.x;
    }
  }
};

// x_hat * (1 + sum gamma) + sum beta for vector v of a plane, stored to out.
template <typename T, int VEC>
__device__ __forceinline__ void modulate_vec(const float* xf, float mean, float rstd,
                                             const T* const* gam, const T* const* bet,
                                             int n_pairs, T* out, long long v) {
  using P = Pack<T, VEC>;
  float gs[VEC], bs[VEC], t[VEC], o[VEC];
  P::unpack(load_vec<T, VEC>(gam[0], v), gs);
  P::unpack(load_vec<T, VEC>(bet[0], v), bs);
#pragma unroll
  for (int k = 1; k < SPADE_MAX_PAIRS; ++k) {
    if (k < n_pairs) {
      P::unpack(load_vec<T, VEC>(gam[k], v), t);
#pragma unroll
      for (int e = 0; e < VEC; ++e) gs[e] = Mod<T>::add(gs[e], t[e]);
      P::unpack(load_vec<T, VEC>(bet[k], v), t);
#pragma unroll
      for (int e = 0; e < VEC; ++e) bs[e] = Mod<T>::add(bs[e], t[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) o[e] = Mod<T>::apply((xf[e] - mean) * rstd, gs[e], bs[e]);
  store_vec<T, VEC>(out, v, o);
}

// The plane's pointer in each of the n_pairs tensors of src.
template <typename T>
__device__ __forceinline__ void plane_ptrs(const void* const* src, int n_pairs, long long base,
                                           const T** dst) {
#pragma unroll
  for (int k = 0; k < SPADE_MAX_PAIRS; ++k) {
    dst[k] = k < n_pairs ? static_cast<const T*>(src[k]) + base : nullptr;
  }
}

// Forward, PATH_WARP (CL = 0) and PATH_BLOCK (CL = 1): the group's
// threads hold the plane's x in registers, NV vectors each (vector
// gi + j * group size), so x is read once.
template <typename T, int VEC, int NV, int CL>
__global__ void __launch_bounds__(max_threads(NV, 1))
spade_modulation_fwd_cached(FwdArgs a) {
  static_assert(CL <= 1, "the forward splits no plane over a cluster");
  using P = Pack<T, VEC>;
  __shared__ float slots[2][32][1];
  const Group<CL> grp;
  if (CL == 0 && grp.plane >= a.n_planes) return;  // a warp's own exit
  const int pv = (int)(a.plane / VEC);
  const long long base = grp.plane * a.plane;
  const T* xp = static_cast<const T*>(a.x) + base;

  typename P::Raw xr[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = grp.index + j * grp.size;
    if (v < pv) xr[j] = load_vec<T, VEC>(xp, v);
  }
  float s[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (grp.index + j * grp.size < pv) {
      float f[VEC];
      P::unpack(xr[j], f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) s[0] += f[e];
    }
  }
  group_sum<CL, 1>(s, slots[0]);
  const float mean = s[0] * a.inv_plane;

  float ss[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (grp.index + j * grp.size < pv) {
      float f[VEC];
      P::unpack(xr[j], f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = f[e] - mean;
        ss[0] += d * d;
      }
    }
  }
  group_sum<CL, 1>(ss, slots[1]);
  const float var = ss[0] * a.inv_plane;
  const float rstd = 1.f / sqrtf(var + a.eps);
  if (grp.index == 0) {
    a.mean[grp.plane] = mean;
    a.rstd[grp.plane] = rstd;
  }

  const T* gam[SPADE_MAX_PAIRS];
  const T* bet[SPADE_MAX_PAIRS];
  plane_ptrs<T>(a.pairs.gamma, a.n_pairs, base, gam);
  plane_ptrs<T>(a.pairs.beta, a.n_pairs, base, bet);
  T* op = static_cast<T*>(a.out) + base;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = grp.index + j * grp.size;
    if (v < pv) {
      float f[VEC];
      P::unpack(xr[j], f);
      modulate_vec<T, VEC>(f, mean, rstd, gam, bet, a.n_pairs, op, v);
    }
  }
}

// Forward, PATH_STREAM: one block a plane, x re-read for each pass (from
// L2 when it still holds it). VEC = 1 is the scalar path.
template <typename T, int VEC>
__global__ void __launch_bounds__(SPADE_STREAM_THREADS)
spade_modulation_fwd_stream(FwdArgs a) {
  using P = Pack<T, VEC>;
  __shared__ float slots[2][32][1];
  const long long pv = a.plane / VEC;
  const long long base = (long long)blockIdx.x * a.plane;
  const T* xp = static_cast<const T*>(a.x) + base;

  float s[1] = {0.f};
#pragma unroll 4
  for (long long v = threadIdx.x; v < pv; v += blockDim.x) {
    float f[VEC];
    P::unpack(load_vec<T, VEC>(xp, v), f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[0] += f[e];
  }
  group_sum<1, 1>(s, slots[0]);
  const float mean = s[0] * a.inv_plane;

  float ss[1] = {0.f};
#pragma unroll 4
  for (long long v = threadIdx.x; v < pv; v += blockDim.x) {
    float f[VEC];
    P::unpack(load_vec<T, VEC>(xp, v), f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float d = f[e] - mean;
      ss[0] += d * d;
    }
  }
  group_sum<1, 1>(ss, slots[1]);
  const float var = ss[0] * a.inv_plane;
  const float rstd = 1.f / sqrtf(var + a.eps);
  if (threadIdx.x == 0) {
    a.mean[blockIdx.x] = mean;
    a.rstd[blockIdx.x] = rstd;
  }

  const T* gam[SPADE_MAX_PAIRS];
  const T* bet[SPADE_MAX_PAIRS];
  plane_ptrs<T>(a.pairs.gamma, a.n_pairs, base, gam);
  plane_ptrs<T>(a.pairs.beta, a.n_pairs, base, bet);
  T* op = static_cast<T*>(a.out) + base;
#pragma unroll 2
  for (long long v = threadIdx.x; v < pv; v += blockDim.x) {
    float f[VEC];
    P::unpack(load_vec<T, VEC>(xp, v), f);
    modulate_vec<T, VEC>(f, mean, rstd, gam, bet, a.n_pairs, op, v);
  }
}

// Backward of one plane: with g_hat = g (1 + sum gamma) (fp32),
//   dx     = rstd (g_hat - mean(g_hat) - x_hat mean(g_hat x_hat))
//   dgamma = g x_hat  (the one gradient of every gamma_i)
// both spatial means reduced in fp32 over the plane's group. Where the
// terms of dx cancel, its value carries the rounding of the two means,
// which the group sums in another order than PyTorch does.

// The first pass over one vector: dgamma stored, the two sums grown.
template <typename T, int VEC>
__device__ __forceinline__ void bwd_first(const float* xf, const float* gf, const float* cf,
                                          float mean, float rstd, const T* const* gam,
                                          int n_pairs, T* dgp, long long v, float (&s)[2]) {
  float gs[VEC], t[VEC], dg[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) gs[e] = 1.f + cf[e];
#pragma unroll
  for (int k = 1; k < SPADE_MAX_PAIRS; ++k) {
    if (k < n_pairs) {
      Pack<T, VEC>::unpack(load_vec<T, VEC>(gam[k], v), t);
#pragma unroll
      for (int e = 0; e < VEC; ++e) gs[e] += t[e];
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float xhat = (xf[e] - mean) * rstd;
    const float ghat = __fmul_rn(gf[e], gs[e]);
    s[0] += ghat;
    s[1] += __fmul_rn(ghat, xhat);
    dg[e] = gf[e] * xhat;
  }
  store_vec<T, VEC>(dgp, v, dg);
}

// The second pass over one vector: dx from x_hat and g_hat recomputed in
// fp32, the plain version's operations in its order, none contracted.
template <typename T, int VEC>
__device__ __forceinline__ void bwd_second(const float* xf, const float* gf, const float* cf,
                                           float mean, float rstd, float m1, float m2,
                                           const T* const* gam, int n_pairs, T* dxp,
                                           long long v) {
  float gs[VEC], t[VEC], dx[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) gs[e] = 1.f + cf[e];
#pragma unroll
  for (int k = 1; k < SPADE_MAX_PAIRS; ++k) {
    if (k < n_pairs) {
      Pack<T, VEC>::unpack(load_vec<T, VEC>(gam[k], v), t);
#pragma unroll
      for (int e = 0; e < VEC; ++e) gs[e] += t[e];
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float xhat = (xf[e] - mean) * rstd;
    const float ghat = __fmul_rn(gf[e], gs[e]);
    dx[e] = __fmul_rn(rstd, __fsub_rn(__fsub_rn(ghat, m1), __fmul_rn(xhat, m2)));
  }
  store_vec<T, VEC>(dxp, v, dx);
}

// Backward, PATH_WARP (CL = 0) and PATH_BLOCK (CL = 1, or a cluster of
// CL = 2 blocks): the group holds x, g and gamma_0 in registers (NV
// vectors each a thread); gammas past the first are re-read in the
// second pass. In a cluster each block arrives once it has read the
// others' partials and waits before it leaves, so no block's shared
// memory goes while another reads it.
template <typename T, int VEC, int NV, int CL>
__global__ void __launch_bounds__(max_threads(NV, 3))
spade_modulation_bwd_cached(BwdArgs a) {
  using P = Pack<T, VEC>;
  __shared__ float slots[32][2];
  const Group<CL> grp;
  if (CL == 0 && grp.plane >= a.n_planes) return;
  const int pv = (int)(a.plane / VEC);
  const long long base = grp.plane * a.plane;
  const float mean = a.mean[grp.plane];
  const float rstd = a.rstd[grp.plane];
  const T* xp = static_cast<const T*>(a.x) + base;
  const T* gp = static_cast<const T*>(a.g) + base;
  const T* gam[SPADE_MAX_PAIRS];
  plane_ptrs<T>(a.pairs.gamma, a.n_pairs, base, gam);

  typename P::Raw xr[NV], gr[NV], cr[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = grp.index + j * grp.size;
    if (v < pv) {
      xr[j] = load_vec<T, VEC>(xp, v);
      gr[j] = load_vec<T, VEC>(gp, v);
      cr[j] = load_vec<T, VEC>(gam[0], v);
    }
  }
  float s[2] = {0.f, 0.f};
  T* dgp = static_cast<T*>(a.dgamma) + base;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = grp.index + j * grp.size;
    if (v < pv) {
      float xf[VEC], gf[VEC], cf[VEC];
      P::unpack(xr[j], xf);
      P::unpack(gr[j], gf);
      P::unpack(cr[j], cf);
      bwd_first<T, VEC>(xf, gf, cf, mean, rstd, gam, a.n_pairs, dgp, v, s);
    }
  }
  group_sum<CL, 2>(s, slots);
  if constexpr (CL > 1) cluster_arrive();
  const float m1 = s[0] * a.inv_plane;
  const float m2 = s[1] * a.inv_plane;

  T* dxp = static_cast<T*>(a.dx) + base;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = grp.index + j * grp.size;
    if (v < pv) {
      float xf[VEC], gf[VEC], cf[VEC];
      P::unpack(xr[j], xf);
      P::unpack(gr[j], gf);
      P::unpack(cr[j], cf);
      bwd_second<T, VEC>(xf, gf, cf, mean, rstd, m1, m2, gam, a.n_pairs, dxp, v);
    }
  }
  if constexpr (CL > 1) cluster_wait();
}

// Backward, PATH_STREAM: one block a plane, x, g and the gammas re-read
// for the second pass. VEC = 1 is the scalar path.
template <typename T, int VEC>
__global__ void __launch_bounds__(SPADE_STREAM_THREADS)
spade_modulation_bwd_stream(BwdArgs a) {
  using P = Pack<T, VEC>;
  __shared__ float slots[32][2];
  const long long pv = a.plane / VEC;
  const long long base = (long long)blockIdx.x * a.plane;
  const float mean = a.mean[blockIdx.x];
  const float rstd = a.rstd[blockIdx.x];
  const T* xp = static_cast<const T*>(a.x) + base;
  const T* gp = static_cast<const T*>(a.g) + base;
  const T* gam[SPADE_MAX_PAIRS];
  plane_ptrs<T>(a.pairs.gamma, a.n_pairs, base, gam);

  float s[2] = {0.f, 0.f};
  T* dgp = static_cast<T*>(a.dgamma) + base;
#pragma unroll 2
  for (long long v = threadIdx.x; v < pv; v += blockDim.x) {
    float xf[VEC], gf[VEC], cf[VEC];
    P::unpack(load_vec<T, VEC>(xp, v), xf);
    P::unpack(load_vec<T, VEC>(gp, v), gf);
    P::unpack(load_vec<T, VEC>(gam[0], v), cf);
    bwd_first<T, VEC>(xf, gf, cf, mean, rstd, gam, a.n_pairs, dgp, v, s);
  }
  group_sum<1, 2>(s, slots);
  const float m1 = s[0] * a.inv_plane;
  const float m2 = s[1] * a.inv_plane;

  T* dxp = static_cast<T*>(a.dx) + base;
#pragma unroll 2
  for (long long v = threadIdx.x; v < pv; v += blockDim.x) {
    float xf[VEC], gf[VEC], cf[VEC];
    P::unpack(load_vec<T, VEC>(xp, v), xf);
    P::unpack(load_vec<T, VEC>(gp, v), gf);
    P::unpack(load_vec<T, VEC>(gam[0], v), cf);
    bwd_second<T, VEC>(xf, gf, cf, mean, rstd, m1, m2, gam, a.n_pairs, dxp, v);
  }
}

// Clusters the block path takes: 2 only for the fp32 backward
// (block_clusters in ops/spade_modulation.py).
static bool cluster_ok(int cluster, int elem_bytes, bool backward) {
  return cluster == 1 || (cluster == 2 && backward && elem_bytes == 4);
}

template <bool B>
using KernelOf = void (*)(typename std::conditional<B, BwdArgs, FwdArgs>::type);

template <typename T, int VEC, int NV, int CL, bool B>
static KernelOf<B> cached_kernel() {
  if constexpr (B) {
    return spade_modulation_bwd_cached<T, VEC, NV, CL>;
  } else {
    return spade_modulation_fwd_cached<T, VEC, NV, CL>;
  }
}

template <typename T, int VEC, bool B>
static KernelOf<B> stream_kernel() {
  if constexpr (B) {
    return spade_modulation_bwd_stream<T, VEC>;
  } else {
    return spade_modulation_fwd_stream<T, VEC>;
  }
}

// The kernel a (checked) plan runs.
template <typename T, bool B>
static KernelOf<B> kernel_for(const Plan& p) {
  constexpr int V = 16 / sizeof(T);
  if (p.path == PATH_STREAM) {
    return p.vec == 1 ? stream_kernel<T, 1, B>() : stream_kernel<T, V, B>();
  }
  if (p.path == PATH_WARP) {
    switch (p.per_thread) {
      case 1: return cached_kernel<T, V, 1, 0, B>();
      case 2: return cached_kernel<T, V, 2, 0, B>();
      case 4: return cached_kernel<T, V, 4, 0, B>();
    }
    return nullptr;
  }
  if constexpr (B && std::is_same<T, float>::value) {
    if (p.cluster == 2) return cached_kernel<T, V, SPADE_BLOCK_NV, 2, B>();
  }
  return cached_kernel<T, V, SPADE_BLOCK_NV, 1, B>();
}

// Whether the kernels can run plan p on n_planes planes of `plane`
// elements of elem_bytes each (`aligned`: every pointer 16-byte aligned).
// It checks what the kernels rely on (vector width and alignment, warps,
// capacity, cluster, grid), not how modulation_plan chose the plan.
static bool plan_ok(const Plan& p, long long n_planes, long long plane, int elem_bytes,
                    bool aligned, bool backward) {
  const int native = 16 / elem_bytes;
  const int arrays = backward ? 3 : 1;
  if (p.vec != 1 && p.vec != native) return false;
  if (p.vec > 1 && (!aligned || plane % p.vec != 0)) return false;
  if (p.threads < 32 || p.threads > 1024 || p.threads % 32 != 0) return false;
  const long long pv = plane / p.vec;
  long long grid;
  switch (p.path) {
    case PATH_WARP:
      if (p.vec == 1 || p.cluster != 1 || p.planes_per_block != p.threads / 32) return false;
      if (p.per_thread != 1 && p.per_thread != 2 && p.per_thread != 4) return false;
      if (pv > 32LL * p.per_thread || p.threads > max_threads(p.per_thread, arrays))
        return false;
      grid = (n_planes + p.planes_per_block - 1) / p.planes_per_block;
      break;
    case PATH_BLOCK:
      if (p.vec == 1 || p.planes_per_block != 1) return false;
      if (!cluster_ok(p.cluster, elem_bytes, backward) || p.per_thread != SPADE_BLOCK_NV ||
          p.threads * p.cluster > 1024)
        return false;
      if (pv > (long long)p.threads * p.cluster * p.per_thread ||
          p.threads > max_threads(p.per_thread, arrays))
        return false;
      grid = n_planes * p.cluster;
      break;
    case PATH_STREAM:
      if (p.cluster != 1 || p.planes_per_block != 1 || p.per_thread != 0 ||
          p.threads > SPADE_STREAM_THREADS)
        return false;
      grid = n_planes;
      break;
    default:
      return false;
  }
  return grid == p.grid && grid <= 0x7fffffffLL;
}

template <typename Args>
static cudaError_t launch(void (*kernel)(Args), const Plan& p, Args args,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.grid);
  cfg.blockDim = dim3((unsigned)p.threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.path == PATH_BLOCK && p.cluster > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

static bool args_ok(int n_pairs, long long n_planes, long long plane) {
  return n_pairs >= 1 && n_pairs <= SPADE_MAX_PAIRS && n_planes >= 1 &&
         n_planes <= 0x7fffffffLL && plane >= 1;
}

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

static Plan read_plan(const int* fields) {
  Plan p;
  int* out = &p.path;
  for (int i = 0; i < SPADE_PLAN_LEN; ++i) out[i] = fields[i];
  return p;
}

extern "C" {

// x, gammas[k], betas[k] and out: NCHW-contiguous tensors of one type
// (dtype 0 = float32, 1 = bfloat16) with n_planes = B*C planes of
// plane = H*W elements; mean and rstd: n_planes floats each, written.
// plan: SPADE_PLAN_LEN ints in the order of struct Plan, from the
// wrapper's modulation_plan. Launches on `stream` and returns the CUDA
// error code of the launch (0 on success; cudaErrorInvalidValue for bad
// arguments, cudaErrorInvalidConfiguration for a plan the kernels cannot
// run); it does not synchronise.
int spade_modulation_fwd(const void* x, const void* const* gammas,
                         const void* const* betas, int n_pairs, void* out,
                         float* mean, float* rstd, long long n_planes,
                         long long plane, float eps, int dtype, const int* plan,
                         void* stream) {
  if (!args_ok(n_pairs, n_planes, plane) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  FwdArgs a = {};
  bool aligned = aligned16(x) && aligned16(out);
  for (int k = 0; k < n_pairs; ++k) {
    a.pairs.gamma[k] = gammas[k];
    a.pairs.beta[k] = betas[k];
    aligned = aligned && aligned16(gammas[k]) && aligned16(betas[k]);
  }
  const Plan p = read_plan(plan);
  if (!plan_ok(p, n_planes, plane, dtype == 0 ? 4 : 2, aligned, false))
    return (int)cudaErrorInvalidConfiguration;
  a.x = x;
  a.n_pairs = n_pairs;
  a.out = out;
  a.mean = mean;
  a.rstd = rstd;
  a.n_planes = n_planes;
  a.plane = plane;
  a.inv_plane = 1.f / (float)plane;
  a.eps = eps;
  KernelOf<false> kernel =
      dtype == 0 ? kernel_for<float, false>(p) : kernel_for<__nv_bfloat16, false>(p);
  if (kernel == nullptr) return (int)cudaErrorInvalidConfiguration;
  return (int)launch(kernel, p, a, static_cast<cudaStream_t>(stream));
}

// The backward of spade_modulation_fwd. x, gammas[k], g (the gradient of
// out), dx and dgamma: NCHW-contiguous tensors of one type; mean and
// rstd: the forward's n_planes floats each; plan as for the forward.
// Writes dx and dgamma (the gradient of every gamma_i; the gradient of
// every beta_i is g itself).
int spade_modulation_bwd(const void* x, const void* const* gammas, int n_pairs,
                         const float* mean, const float* rstd, const void* g,
                         void* dx, void* dgamma, long long n_planes,
                         long long plane, int dtype, const int* plan, void* stream) {
  if (!args_ok(n_pairs, n_planes, plane) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  BwdArgs a = {};
  bool aligned = aligned16(x) && aligned16(g) && aligned16(dx) && aligned16(dgamma);
  for (int k = 0; k < n_pairs; ++k) {
    a.pairs.gamma[k] = gammas[k];
    aligned = aligned && aligned16(gammas[k]);
  }
  const Plan p = read_plan(plan);
  if (!plan_ok(p, n_planes, plane, dtype == 0 ? 4 : 2, aligned, true))
    return (int)cudaErrorInvalidConfiguration;
  a.x = x;
  a.n_pairs = n_pairs;
  a.mean = mean;
  a.rstd = rstd;
  a.g = g;
  a.dx = dx;
  a.dgamma = dgamma;
  a.n_planes = n_planes;
  a.plane = plane;
  a.inv_plane = 1.f / (float)plane;
  KernelOf<true> kernel =
      dtype == 0 ? kernel_for<float, true>(p) : kernel_for<__nv_bfloat16, true>(p);
  if (kernel == nullptr) return (int)cudaErrorInvalidConfiguration;
  return (int)launch(kernel, p, a, static_cast<cudaStream_t>(stream));
}

const char* spade_modulation_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
