// 2x2-window fetch and its transpose, the splat, for sm_90a.
//
// Replaces the Pallas kernels gan2shape_tpu/ops/splat_window.py:_fetch_pallas
// and :_splat_pallas.  The TPU kernels decompose the gather by displacement
// value (masked lane rolls) because a TPU gather costs ~17 ns per index; a
// GPU reads any address from L2/HBM at full rate, so here each thread simply
// owns one (batch, point) and reads or scatter-adds its clipped 2x2 window
// for every channel.  Any channel count C is accepted (the TPU gate C == 3 is
// not carried over).
//
// Layout (matches gan2shape_torch/ops/splat_window.py):
//   src  (B, C, H, W) f32
//   iy/ix (B, P) int32 window starts, clipped here to [0, H-2] x [0, W-2]
//   out  (B, 4C, P) f32, plane (a*2+s)*C+ch holds src[b, ch, iy+a, ix+s]
//
// What bounds them on an H100: bytes.  The fetch reads src once through the
// cache (neighbouring points read overlapping windows) and writes 4C floats per
// point; the splat reads those 4C floats and adds into dsrc.  Neither does
// more than a handful of integer operations per byte.
//
// The splat is deterministic: the same inputs give the same bits on every
// call, whatever the starts, as the JAX splat's fixed summation order does.
// Float atomics would add colliding windows in an order that changes from run
// to run, so it sums in integers, whose addition does not depend on the order:
//   1. splat_amax_kernel: the largest |g| of each (batch, channel) plane, as
//      float bits (which order like the values for |g| >= 0), one atomicMax
//      a block of 4096 values; its blocks also zero the int64 sums.
//   2. splat2x2_kernel: each addend becomes round(g * 2^k) in an int64, added
//      by 64-bit integer atomicAdd.  k is a power of two chosen per plane from
//      its largest value M < 2^e: k = 53 - ceil(log2 P) - e.  A pixel of a
//      plane receives at most one tap of each of the P points, so every
//      partial sum stays within 2^53 and converts to double exactly; each
//      addend is quantised to 2^-k <= M * 2^(ceil(log2 P) - 52), at P = 128^2
//      M * 2^-38, far below the f32 sum's own rounding.  Two lanes of a warp
//      whose windows touch (the right column of one is the left column of the
//      next, as on every smooth warp) add that column once, in registers.
//   3. splat_convert_kernel: sum * 2^-k, rounded once to f32, two a thread.
// A plane that holds an inf or a NaN comes out all NaN.  Scratch: the int64
// sums and the per-plane maxima (zeroed by a memset before pass 1).
// gan2shape_torch/ops/splat_window.py:splat2x2_fixed_plain is the same
// arithmetic in torch; the kernel equals it bit for bit.
//
// The price of repeatability is bytes: g is read twice (pass 1 from HBM,
// pass 2 mostly from L2) and the sums are 8 bytes a value, written, added
// and read back, so on the method's calls the three passes take 1.6-2.1x
// the time of the one f32 atomicAdd kernel they replaced.  Measured on the H100
// (PERF.md): the lane pairing pays on the method's smooth starts; privatising
// a block's region in shared memory and flushing it once paid on random
// starts but lost on the method's calls.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNonFinite = 0x7f800000u;  // |g| bits at or above: inf, NaN
constexpr int kThreads = 256;
constexpr int kAmaxChunk = 16 * kThreads;  // values of a plane an amax block
constexpr int kGroup = 4;  // channels whose taps the splat loads at once

__global__ void fetch2x2_kernel(const float* __restrict__ src,
                                const int* __restrict__ iy,
                                const int* __restrict__ ix,
                                float* __restrict__ out,
                                int B, int C, int H, int W, int P) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * P) return;
  int b = (int)(t / P);
  int p = (int)(t % P);
  int y0 = min(max(iy[t], 0), H - 2);
  int x0 = min(max(ix[t], 0), W - 2);
  long long plane = (long long)H * W;
  const float* s = src + (long long)b * C * plane + (long long)y0 * W + x0;
  float* o = out + (long long)b * 4 * C * P + p;
  for (int a = 0; a < 2; ++a) {
    for (int sx = 0; sx < 2; ++sx) {
      for (int ch = 0; ch < C; ++ch) {
        o[(long long)((a * 2 + sx) * C + ch) * P] =
            s[ch * plane + a * W + sx];
      }
    }
  }
}

// 2^k as a double, exactly (|k| < 1023 here)
__device__ __forceinline__ double pow2(int k) {
  return __longlong_as_double((long long)(1023 + k) << 52);
}

// the scale exponent k of a plane whose largest |g| has the bits `amax`
__device__ __forceinline__ int scale_exponent(unsigned amax, int log2p) {
  int e = max((int)(amax >> 23), 1) - 126;  // largest |g| < 2^e
  return 53 - log2p - e;
}

// the largest |g| of each plane, from blocks of kAmaxChunk values of one
// plane (4 float4 a thread where P % 4 == 0 and g is 16-byte aligned), one
// atomicMax a block; the blocks also zero the int64 sums, grid-stride
__global__ void splat_amax_kernel(const float* __restrict__ g,
                                  unsigned* __restrict__ amax,
                                  unsigned long long* __restrict__ acc,
                                  long long n_acc, int C, int P, int chunks,
                                  bool vec4) {
  long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < n_acc; i += stride) {
    acc[i] = 0ull;
  }
  long long plane = blockIdx.x / chunks;  // b * 4C + tap * C + ch
  int lo = (int)(blockIdx.x % chunks) * kAmaxChunk;
  int hi = min(P, lo + kAmaxChunk);
  const float* gp = g + plane * P;
  unsigned m = 0;
  if (vec4) {
    const float4* g4 = reinterpret_cast<const float4*>(gp);
#pragma unroll
    for (int k = 0; k < kAmaxChunk / (4 * kThreads); ++k) {
      int i = lo / 4 + k * kThreads + threadIdx.x;
      if (i < hi / 4) {
        float4 v = g4[i];
        m = max(max(m, __float_as_uint(v.x) & 0x7fffffffu),
                max(__float_as_uint(v.y) & 0x7fffffffu,
                    __float_as_uint(v.z) & 0x7fffffffu));
        m = max(m, __float_as_uint(v.w) & 0x7fffffffu);
      }
    }
  } else {
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      m = max(m, __float_as_uint(gp[i]) & 0x7fffffffu);
    }
  }
  __shared__ unsigned warp_max[kThreads / 32];
  m = __reduce_max_sync(kFull, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    if (m != 0) atomicMax(amax + (plane / (4 * C)) * C + plane % C, m);
  }
}

__global__ void splat2x2_kernel(const float* __restrict__ g,
                                const int* __restrict__ iy,
                                const int* __restrict__ ix,
                                const unsigned* __restrict__ amax,
                                unsigned long long* __restrict__ acc,
                                int B, int C, int H, int W, int P,
                                int log2p) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool live = t < (long long)B * P;  // every lane runs the shuffles below
  long long plane = (long long)H * W;
  int b = 0, p = 0;
  long long base = -1;  // the window's top-left cell in acc, channel 0
  if (live) {
    b = (int)(t / P);
    p = (int)(t % P);
    int y0 = min(max(iy[t], 0), H - 2);
    int x0 = min(max(ix[t], 0), W - 2);
    base = (long long)b * C * plane + (long long)y0 * W + x0;
  }
  // my right column is my right neighbour's left column: it adds mine
  int lane = threadIdx.x & 31;
  long long left = __shfl_up_sync(kFull, base, 1);
  long long right = __shfl_down_sync(kFull, base, 1);
  bool take = live && lane > 0 && left >= 0 && left + 1 == base;
  bool give = live && lane < 31 && right == base + 1;
  const float* gp = g + (long long)b * 4 * C * P + p;
  // kGroup channels at a time: every load first, then the adds, so a
  // thread waits on memory once a group rather than once a channel
  for (int c0 = 0; c0 < C; c0 += kGroup) {
    int nc = min(kGroup, C - c0);  // the same in every lane
    unsigned m[kGroup];
    float v[kGroup][4] = {};
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      m[j] = kNonFinite;
      if (live && j < nc) {
        m[j] = amax[b * C + c0 + j];
#pragma unroll
        for (int tap = 0; tap < 4; ++tap) {
          v[j][tap] = gp[(long long)(tap * C + c0 + j) * P];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j >= nc) break;
      bool add = m[j] < kNonFinite;  // false on dead lanes
      double s = pow2(scale_exponent(m[j], log2p));
      for (int a = 0; a < 2; ++a) {
        long long q0 = 0, q1 = 0;
        if (add) {
          q0 = __double2ll_rn(__dmul_rn((double)v[j][a * 2], s));
          q1 = __double2ll_rn(__dmul_rn((double)v[j][a * 2 + 1], s));
        }
        long long from_left = __shfl_up_sync(kFull, q1, 1);
        if (take) q0 += from_left;
        unsigned long long* d = acc + base + (c0 + j) * plane + a * W;
        if (add && q0 != 0) atomicAdd(d, (unsigned long long)q0);
        if (add && !give && q1 != 0) {
          atomicAdd(d + 1, (unsigned long long)q1);
        }
      }
    }
  }
}

__device__ __forceinline__ float to_f32(unsigned long long q, unsigned m,
                                        int log2p) {
  return m >= kNonFinite
      ? __uint_as_float(0x7fc00000u)
      : __double2float_rn(__dmul_rn(__ll2double_rn((long long)q),
                                    pow2(-scale_exponent(m, log2p))));
}

// two sums a thread: a 16-byte load and an 8-byte store (g2s_splat2x2
// checks the alignment)
__global__ void splat_convert_kernel(const unsigned long long* __restrict__ acc,
                                     const unsigned* __restrict__ amax,
                                     float* __restrict__ out, long long n,
                                     long long plane, int log2p) {
  long long i = 2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  if (i + 1 < n) {
    ulonglong2 q = *reinterpret_cast<const ulonglong2*>(acc + i);
    float2 o;
    o.x = to_f32(q.x, amax[i / plane], log2p);
    o.y = to_f32(q.y, amax[(i + 1) / plane], log2p);
    *reinterpret_cast<float2*>(out + i) = o;
  } else {
    out[i] = to_f32(acc[i], amax[i / plane], log2p);
  }
}

int ceil_log2(long long p) {
  int l = 0;
  while ((1LL << l) < p) ++l;
  return l;
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int g2s_fetch2x2(const float* src, const int* iy, const int* ix,
                            float* out, int B, int C, int H, int W, int P,
                            cudaStream_t stream) {
  long long n = (long long)B * P;
  if (n == 0) return 0;
  fetch2x2_kernel<<<blocks_for(n), kThreads, 0, stream>>>(src, iy, ix, out,
                                                          B, C, H, W, P);
  return (int)cudaGetLastError();
}

// scratch: B*C*H*W int64 sums, then B*C uint32 plane maxima; zeroed here
// (the sums by splat_amax_kernel).  The convert pass reads two sums and
// writes two values at once: scratch must be 16-byte and dsrc 8-byte
// aligned, as fresh allocations are.
extern "C" int g2s_splat2x2(const float* g, const int* iy, const int* ix,
                            float* dsrc, void* scratch, int B, int C, int H,
                            int W, int P, cudaStream_t stream) {
  long long plane = (long long)H * W;
  long long n = (long long)B * C * plane;
  if (n == 0) return 0;
  if (reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dsrc) % 8 != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  unsigned long long* acc = (unsigned long long*)scratch;
  unsigned* amax = (unsigned*)(acc + n);
  cudaError_t err = cudaMemsetAsync(amax, 0, (size_t)B * C * sizeof(unsigned),
                                    stream);
  if (err != cudaSuccess) return (int)err;
  int log2p = ceil_log2(P);
  if (P == 0) {
    err = cudaMemsetAsync(acc, 0, n * sizeof(long long), stream);
    if (err != cudaSuccess) return (int)err;
  } else {
    int chunks = (P + kAmaxChunk - 1) / kAmaxChunk;
    bool vec4 = P % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
    splat_amax_kernel<<<(unsigned)((long long)B * 4 * C * chunks), kThreads,
                        0, stream>>>(g, amax, acc, n, C, P, chunks, vec4);
    splat2x2_kernel<<<blocks_for((long long)B * P), kThreads, 0, stream>>>(
        g, iy, ix, amax, acc, B, C, H, W, P, log2p);
  }
  splat_convert_kernel<<<blocks_for((n + 1) / 2), kThreads, 0, stream>>>(
      acc, amax, dsrc, n, plane, log2p);
  return (int)cudaGetLastError();
}
