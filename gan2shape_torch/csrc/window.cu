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
// The splat uses atomicAdd: the order in which colliding windows add into one
// source pixel changes from run to run, so its result is not bitwise
// reproducible; it is held to a tolerance against the plain version.
//
// A deterministic gather design (a tile kernel that lists, per output tile,
// the points whose windows land on it and stores each output once in the
// plain version's order, with no memset and no atomics, plus a kernel that
// adds with atomics the windows out of its reach) was measured against this
// one on an H100 on the starts that training produces, and lost at B=16 and
// at B=1.  Those starts are smooth fields (windows 0-1 px from their pixel,
// or moved together by a few px in step 3): their atomics rarely collide,
// while the gather pays for finding and ordering each pixel's points and for
// a second launch.  Its design and numbers are in PERF.md.

#include <cuda_runtime.h>

namespace {

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

__global__ void splat2x2_kernel(const float* __restrict__ g,
                                const int* __restrict__ iy,
                                const int* __restrict__ ix,
                                float* __restrict__ dsrc,
                                int B, int C, int H, int W, int P) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * P) return;
  int b = (int)(t / P);
  int p = (int)(t % P);
  int y0 = min(max(iy[t], 0), H - 2);
  int x0 = min(max(ix[t], 0), W - 2);
  long long plane = (long long)H * W;
  const float* gp = g + (long long)b * 4 * C * P + p;
  float* d = dsrc + (long long)b * C * plane + (long long)y0 * W + x0;
  for (int a = 0; a < 2; ++a) {
    for (int sx = 0; sx < 2; ++sx) {
      for (int ch = 0; ch < C; ++ch) {
        atomicAdd(d + ch * plane + a * W + sx,
                  gp[(long long)((a * 2 + sx) * C + ch) * P]);
      }
    }
  }
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int g2s_fetch2x2(const float* src, const int* iy, const int* ix,
                            float* out, int B, int C, int H, int W, int P,
                            cudaStream_t stream) {
  long long n = (long long)B * P;
  if (n == 0) return 0;
  unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  fetch2x2_kernel<<<blocks, kThreads, 0, stream>>>(src, iy, ix, out, B, C, H,
                                                   W, P);
  return (int)cudaGetLastError();
}

// dsrc must be zeroed by the caller.
extern "C" int g2s_splat2x2(const float* g, const int* iy, const int* ix,
                            float* dsrc, int B, int C, int H, int W, int P,
                            cudaStream_t stream) {
  long long n = (long long)B * P;
  if (n == 0) return 0;
  unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  splat2x2_kernel<<<blocks, kThreads, 0, stream>>>(g, iy, ix, dsrc, B, C, H,
                                                   W, P);
  return (int)cudaGetLastError();
}
