// StyleGAN2's convolution epilogue for sm_90a, one pass forward and one
// backward:
//
//   y = gain * lrelu(x * demod[b, c] + wn[b or 0, hw] + bias[c])
//
// with demod, wn (the weighted noise, w * noise) and bias each optional.
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA,
// which fuses it by itself.  Eager PyTorch runs it as seven full-size
// passes forward (the demodulation, the noise, the bias, the compare, the
// slope, the select, the gain) and about ten backward, the broadcast ones
// through ATen's unvectorised path; at car512 with 64 images they moved
// about 1 s of every 4.9 s of step 2's device time (PERF.md).  GAN2Shape's
// reference StyleGAN2 ran the bias and activation as one CUDA kernel
// (fused_bias_act); this is its counterpart with the demodulation and the
// noise taken in.
//
// Layout: x, y, g and the gradients (B, C, HW) contiguous, f32 or bf16;
// demod (B, C) f32; wn (1 or B, HW) in x's type; bias (C) f32.
//
// Arithmetic: every multiply and add is rounded on its own (__fmul_rn,
// __fadd_rn), in the plain chain's order, and in bf16 rounded to bf16 after
// each operation and where the plain chain casts demod and bias, so the
// forward and grad_x equal ops/fused_act.py:bias_act_plain and its autograd
// value for value.  The slope applies where the pre-activation is < 0: an
// exact 0 passes with slope 1, and a NaN takes the slope, as torch.where
// does.
//
// The mask.  The forward writes one bit an element, pre >= 0, for the
// backward (a 32nd of an f32 tensor, where the plain chain keeps a byte an
// element): element i is bit (i / 4) % 32 of word 4 * (i / 128) + i % 4,
// so that a warp's 32 lanes, 4 consecutive elements each, write a chunk of
// 128 elements as four ballots.  The backward and the double backward
// read it; nothing recomputes the pre-activation.
//
// What bounds it: bytes.  Forward: x read and y written, 8 B an f32
// element, and the mask bit.  Backward: g and the mask read, grad_x
// written, and x read where demod's gradient is asked for: 8-12 B.  At
// 3.35 TB/s car512's 512^2 layer of 64 images (2^30 elements, 64 channels)
// takes 2.56 ms forward and 3.85 ms backward at the bound.
//
// Determinism: grad_demod (per (b, c) plane, over HW) and grad_bias (per c,
// over b and HW) are summed in an order that the shape alone fixes: a
// group of threads per plane, each thread's strided partial, then a tree;
// grad_bias's per-plane partials are summed over b in order by a second
// kernel.  No atomics: two calls give the same bits.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 4096;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static float get(const float* p, long long i) { return p[i]; }
  __device__ static void put(float* p, long long i, float v) { p[i] = v; }
  __device__ static float round(float v) { return v; }
  __device__ static void get4(const float* p, long long i, float v[4]) {
    float4 q = *reinterpret_cast<const float4*>(p + i);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ static void put4(float* p, long long i, const float v[4]) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  typedef __nv_bfloat16 T;
  __device__ static float get(const T* p, long long i) {
    return __bfloat162float(p[i]);
  }
  __device__ static void put(T* p, long long i, float v) {
    p[i] = __float2bfloat16_rn(v);
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static void get4(const T* p, long long i, float v[4]) {
    uint2 q = *reinterpret_cast<const uint2*>(p + i);
    __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&q.x);
    __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&q.y);
    v[0] = __low2float(a);
    v[1] = __high2float(a);
    v[2] = __low2float(b);
    v[3] = __high2float(b);
  }
  __device__ static void put4(T* p, long long i, const float v[4]) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<unsigned*>(&a);
    q.y = *reinterpret_cast<unsigned*>(&b);
    *reinterpret_cast<uint2*>(p + i) = q;
  }
};

// the mask bit of element i (see the header)
__device__ __forceinline__ bool mask_bit(const unsigned* mask, long long i) {
  return (mask[4 * (i >> 7) + (i & 3)] >> ((i >> 2) & 31)) & 1u;
}

// Forward, one warp a chunk of 128 elements, 4 consecutive ones a lane.
// `vec`: HW % 4 == 0 and every full-size pointer aligned to 4 elements, so
// a lane's 4 elements share a plane and load as one vector.  mask_in: the
// mask to apply instead of pre >= 0 (the double backward); mask_out: where
// to write pre >= 0 (nullptr: no gradient will be asked for).
// I is the index type: 32-bit where n fits, which keeps the plane
// divisions cheap.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads) bias_act_kernel(
    const T* __restrict__ x, const float* __restrict__ demod,
    const T* __restrict__ wn, const float* __restrict__ bias,
    const unsigned* __restrict__ mask_in, T* __restrict__ y,
    unsigned* __restrict__ mask_out, I n, int C, int HW, int wn_batch,
    float slope, float gain, bool vec) {
  typedef Elem<T> E;
  const int lane = threadIdx.x & 31;
  const I chunks = (n + 127) / 128;
  const I stride = (I)gridDim.x * kWarps;
  for (I ch = (I)blockIdx.x * kWarps + (threadIdx.x >> 5); ch < chunks;
       ch += stride) {
    const I i0 = ch * 128 + 4 * (I)lane;
    const bool full = vec && i0 + 4 <= n;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (full) {
      E::get4(x, i0, v);
    } else {
      for (int k = 0; k < 4; ++k) {
        if (i0 + k < n) v[k] = E::get(x, i0 + k);
      }
    }
    unsigned given[4] = {0u, 0u, 0u, 0u};
    if (mask_in != nullptr) {
      uint4 w = reinterpret_cast<const uint4*>(mask_in)[ch];
      given[0] = w.x;
      given[1] = w.y;
      given[2] = w.z;
      given[3] = w.w;
    }
    // each element's demodulation, weighted noise and bias: a lane's
    // 4 elements share one plane where `full`
    float d[4], w[4], bb[4];
    if (full) {
      const I plane = i0 / HW;
      const float dp = demod != nullptr ? E::round(demod[plane]) : 0.f;
      const float bp = bias != nullptr ? E::round(bias[plane % C]) : 0.f;
      if (wn != nullptr) {
        E::get4(wn, (wn_batch ? (plane / C) * HW : 0) + i0 - plane * HW, w);
      }
      for (int k = 0; k < 4; ++k) {
        d[k] = dp;
        bb[k] = bp;
      }
    } else {
      for (int k = 0; k < 4; ++k) {
        const I i = i0 + k < n ? i0 + k : 0;
        const I plane = i / HW;
        d[k] = demod != nullptr ? E::round(demod[plane]) : 0.f;
        bb[k] = bias != nullptr ? E::round(bias[plane % C]) : 0.f;
        w[k] = wn != nullptr
                   ? E::get(wn, (wn_batch ? (plane / C) * HW : 0) + i -
                                    plane * HW)
                   : 0.f;
      }
    }
    bool pos[4];
    for (int k = 0; k < 4; ++k) {
      float a = v[k];
      if (demod != nullptr) a = E::round(__fmul_rn(a, d[k]));
      if (wn != nullptr) a = E::round(__fadd_rn(a, w[k]));
      if (bias != nullptr) a = E::round(__fadd_rn(a, bb[k]));
      pos[k] = i0 + k < n &&
               (mask_in != nullptr ? ((given[k] >> lane) & 1u) : a >= 0.f);
      if (!pos[k]) a = E::round(__fmul_rn(a, slope));
      v[k] = E::round(__fmul_rn(a, gain));
    }
    if (full) {
      E::put4(y, i0, v);
    } else {
      for (int k = 0; k < 4; ++k) {
        if (i0 + k < n) E::put(y, i0 + k, v[k]);
      }
    }
    if (mask_out != nullptr) {
      const unsigned b0 = __ballot_sync(kFull, pos[0]);
      const unsigned b1 = __ballot_sync(kFull, pos[1]);
      const unsigned b2 = __ballot_sync(kFull, pos[2]);
      const unsigned b3 = __ballot_sync(kFull, pos[3]);
      if (lane == 0) {
        reinterpret_cast<uint4*>(mask_out)[ch] = make_uint4(b0, b1, b2, b3);
      }
    }
  }
}

// Sum `v` over the G threads of each aligned group (G a power of two up
// to kThreads) in a fixed tree; every thread of the group gets the sum.
// `scratch` holds kWarps floats; all threads of the block take part.
__device__ __forceinline__ float group_sum(float v, int G, float* scratch) {
  for (int off = (G < 32 ? G : 32) / 2; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  }
  if (G <= 32) return v;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  const int first = warp & ~(G / 32 - 1);
  float s = scratch[first];
  for (int w = 1; w < G / 32; ++w) s = __fadd_rn(s, scratch[first + w]);
  return s;
}

// Backward, G threads a (b, c) plane, kThreads / G planes a block.
//   gpre = g * gain, times slope where the mask bit is 0 (two roundings,
//          as autograd takes them);
//   gx   = gpre * demod[b, c] (gpre without demod);
//   gd   = sum over the plane of gpre * x;
//   part = sum over the plane of gpre (bias_sum_kernel sums it over b).
// Each output is optional (nullptr).  `vec`: HW % 4 == 0 and the full-size
// pointers aligned to 4 elements.
template <typename T>
__global__ void __launch_bounds__(kThreads) bias_act_grad_kernel(
    const T* __restrict__ g, const unsigned* __restrict__ mask,
    const T* __restrict__ x, const float* __restrict__ demod,
    T* __restrict__ gx, T* __restrict__ gpre_out, float* __restrict__ gd,
    float* __restrict__ part, int P, int HW, int G, float slope, float gain,
    bool vec) {
  typedef Elem<T> E;
  __shared__ float scratch[kWarps];
  const int per_block = kThreads / G;
  const int p = blockIdx.x * per_block + threadIdx.x / G;
  const int t = threadIdx.x % G;
  const bool live = p < P;
  const long long base = (long long)(live ? p : 0) * HW;
  const float d = (live && demod != nullptr) ? E::round(demod[p]) : 0.f;
  float sum_d = 0.f, sum_b = 0.f;
  if (live) {
    if (vec) {
      for (int j = 4 * t; j < HW; j += 4 * G) {
        const long long i = base + j;
        float gv[4], xv[4];
        E::get4(g, i, gv);
        if (gd != nullptr) E::get4(x, i, xv);
        const uint4 w = reinterpret_cast<const uint4*>(mask)[i >> 7];
        const unsigned bit = (i >> 2) & 31;
        const unsigned words[4] = {w.x, w.y, w.z, w.w};
        float out[4], pre[4];
        for (int k = 0; k < 4; ++k) {
          float a = E::round(__fmul_rn(gv[k], gain));
          if (!((words[k] >> bit) & 1u)) a = E::round(__fmul_rn(a, slope));
          pre[k] = a;
          out[k] = demod != nullptr ? E::round(__fmul_rn(a, d)) : a;
          if (gd != nullptr) {
            sum_d = __fadd_rn(sum_d, E::round(__fmul_rn(a, xv[k])));
          }
          sum_b = __fadd_rn(sum_b, a);
        }
        if (gx != nullptr) E::put4(gx, i, out);
        if (gpre_out != nullptr) E::put4(gpre_out, i, pre);
      }
    } else {
      for (int j = t; j < HW; j += G) {
        const long long i = base + j;
        float a = E::round(__fmul_rn(E::get(g, i), gain));
        if (!mask_bit(mask, i)) a = E::round(__fmul_rn(a, slope));
        if (gx != nullptr) {
          E::put(gx, i, demod != nullptr ? __fmul_rn(a, d) : a);
        }
        if (gpre_out != nullptr) E::put(gpre_out, i, a);
        if (gd != nullptr) {
          sum_d = __fadd_rn(sum_d, E::round(__fmul_rn(a, E::get(x, i))));
        }
        sum_b = __fadd_rn(sum_b, a);
      }
    }
  }
  if (gd != nullptr) {
    sum_d = group_sum(sum_d, G, scratch);
    if (live && t == 0) gd[p] = E::round(sum_d);
  }
  if (part != nullptr) {
    sum_b = group_sum(sum_b, G, scratch);
    if (live && t == 0) part[p] = sum_b;
  }
}

// grad_bias[c] = the (B, C) plane partials summed over b in order.
template <typename T>
__global__ void bias_sum_kernel(const float* __restrict__ part,
                                float* __restrict__ gb, int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s = __fadd_rn(s, part[(long long)b * C + c]);
  gb[c] = Elem<T>::round(s);
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int launch_forward(const void* x, const float* demod, const void* wn,
                   const float* bias, const unsigned* mask_in, void* y,
                   unsigned* mask_out, long long n, int C, int HW,
                   int wn_batch, float slope, float gain,
                   cudaStream_t stream) {
  const int vb = 4 * (int)sizeof(T);
  const bool vec = HW % 4 == 0 && aligned(x, vb) && aligned(y, vb) &&
                   aligned(wn, vb);
  const long long chunks = (n + 127) / 128;
  long long blocks = (chunks + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(wn);
  T* yt = static_cast<T*>(y);
  if (n <= 0x7fffffffLL) {
    bias_act_kernel<T, unsigned><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xt, demod, wt, bias, mask_in, yt, mask_out, (unsigned)n, C, HW,
        wn_batch, slope, gain, vec);
  } else {
    bias_act_kernel<T, unsigned long long>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(
            xt, demod, wt, bias, mask_in, yt, mask_out,
            (unsigned long long)n, C, HW, wn_batch, slope, gain, vec);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_grad(const void* g, const unsigned* mask, const void* x,
                const float* demod, void* gx, void* gpre, float* gd,
                float* gb, float* part, int B, int C, int HW, float slope,
                float gain, cudaStream_t stream) {
  const int vb = 4 * (int)sizeof(T);
  const bool vec = HW % 4 == 0 && aligned(g, vb) && aligned(x, vb) &&
                   aligned(gx, vb) && aligned(gpre, vb);
  const int units = vec ? HW / 4 : HW;
  int G = 1;
  while (G < units && G < kThreads) G *= 2;
  const int P = B * C;
  const int per_block = kThreads / G;
  const unsigned blocks = (unsigned)((P + per_block - 1) / per_block);
  bias_act_grad_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(g), mask, static_cast<const T*>(x), demod,
      static_cast<T*>(gx), static_cast<T*>(gpre), gd,
      gb != nullptr ? part : nullptr, P, HW, G, slope, gain, vec);
  if (gb != nullptr) {
    bias_sum_kernel<T><<<(unsigned)((C + kThreads - 1) / kThreads), kThreads,
                         0, stream>>>(part, gb, B, C);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The forward.  bf16: x, wn and y are bf16 (else f32).  demod, wn, bias,
// mask_in and mask_out may each be nullptr.
// mask_out holds 4 * ceil(n / 128) words and is 16-byte aligned, as is
// mask_in, as fresh allocations are.
extern "C" int g2s_bias_act(const void* x, const float* demod, const void* wn,
                            const float* bias, const unsigned* mask_in,
                            void* y, unsigned* mask_out, int bf16, int B,
                            int C, int HW, int wn_batch, float slope,
                            float gain, cudaStream_t stream) {
  const long long n = (long long)B * C * HW;
  if (n == 0) return 0;
  if (!aligned(mask_in, 16) || !aligned(mask_out, 16)) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (bf16) {
    return launch_forward<__nv_bfloat16>(x, demod, wn, bias, mask_in, y,
                                         mask_out, n, C, HW, wn_batch, slope,
                                         gain, stream);
  }
  return launch_forward<float>(x, demod, wn, bias, mask_in, y, mask_out, n,
                               C, HW, wn_batch, slope, gain, stream);
}

// The backward.  bf16: g, x, gx and gpre are bf16 (else f32).  gx, gpre
// (gx before the demodulation), gd and gb may each be nullptr; x is read
// only for gd, demod only for gx; part holds B * C floats where gb is
// asked for.
extern "C" int g2s_bias_act_grad(const void* g, const unsigned* mask,
                                 const void* x, const float* demod, void* gx,
                                 void* gpre, float* gd, float* gb,
                                 float* part, int bf16, int B, int C, int HW,
                                 float slope, float gain,
                                 cudaStream_t stream) {
  if ((long long)B * C * HW == 0) return 0;
  if (!aligned(mask, 16)) return (int)cudaErrorMisalignedAddress;
  if (bf16) {
    return launch_grad<__nv_bfloat16>(g, mask, x, demod, gx, gpre, gd, gb,
                                      part, B, C, HW, slope, gain, stream);
  }
  return launch_grad<float>(g, mask, x, demod, gx, gpre, gd, gb, part, B, C,
                            HW, slope, gain, stream);
}
