// Rasterizer winner pass of the warped grid mesh, for sm_90a.
//
// Replaces the Pallas kernels of gan2shape_tpu/ops/rasterize.py:
//   _raster_mega_pallas_v2 (the 128-px path), _dense_winner_pallas (64 px and
//   any width that is not a multiple of 128), and _raster_mega_pallas, which
//   has the same contract (reached through raster_mega in ops/rasterize.py,
//   on the rasterizer check's path).  All three return, per
//   output pixel, the min packed key (quantized depth << 17 | face id) over
//   the candidate tests; _decode_key turns it into (cell, parity, covered).
//
// Two kernels:
//   1. placement (two launches of place_kernel): one thread per face and
//      parity computes the half-pixel bbox slot and the 10-channel int16
//      payload exactly as _build_winner_buffers does.  Pass 0 atomicMin's the
//      packed (32767 - r0q) << 16 | cell key into the slot (nearest face
//      wins); pass 1 lets only the winning face write its payload.  Faces
//      outside the padded viewport are dropped, which is what the unique dump
//      slots of the JAX version amount to.  _raster_mega_pallas_v2 also drops
//      faces displaced more than DY_CAP = 96 rows; this kernel, like the
//      buffers path it is held to, keeps them.
//   2. candidate tests: one thread per output pixel runs the
//      2 parities x 4 phases x window^2 tests of _winner_tests and writes the
//      int32 min key.
//
// Bit-exactness with the plain version: every float operation on the key path
// is written with an explicit round-to-nearest intrinsic in the order the
// JAX expression evaluates it, this file is built with --fmad=false, division
// stays IEEE, and rounding is rintf (half to even, as jnp.round/torch.round).
//
// What bounds it on an H100: bytes.  At B=16, 128 px, window 3 the payload
// buffers are 47 MB of int16 (2 parities x 4 phases x 10 channels of the
// padded grid): placement writes them, the tests read them, ~14 us each at
// 3.35 TB/s.  The tests' arithmetic (~25 f32 operations per candidate, ~17
// more for the few that cover the pixel, 72 candidates per pixel) is about
// half of that time at the f32 rate.  Each test thread re-reads its
// neighbours' slots, which the L1/L2 caches serve.  No gradient flows here:
// the caller re-interpolates the winner's vertices differentiably.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFaceBits = 17;
constexpr int kSentinel = 0x7fffffff;
constexpr int kChannels = 10;
constexpr int kThreads = 256;

struct Quant {
  float r_lo;
  float r_step;
  float near;
  float depth_scale;
};

__device__ __forceinline__ int16_t fx16(float v, float anchor) {
  float q = rintf(__fmul_rn(__fsub_rn(v, anchor), 256.0f));
  q = fminf(fmaxf(q, -32767.0f), 32767.0f);
  return (int16_t)(int)q;
}

__device__ __forceinline__ int16_t rq16(float z, float r_lo, float r_step) {
  float r = __fdiv_rn(1.0f, fmaxf(z, 1e-6f));
  float q = rintf(__fdiv_rn(__fsub_rn(r, r_lo), r_step));
  q = fminf(fmaxf(q, 0.0f), 32767.0f);
  return (int16_t)(int)q;
}

// floor(2 * min(a, b, c)) as int32, saturated like the plain version
__device__ __forceinline__ int half_pixel_floor(float a, float b, float c) {
  float m = __fmul_rn(2.0f, fminf(fminf(a, b), c));
  m = fminf(fmaxf(floorf(m), -1073741824.0f), 1073741824.0f);
  return (int)m;
}

// pass 0: atomicMin the collision key into kbuf; pass 1: the winner writes.
// kbuf: (2, B, 4, hp, wp) int32; buf: (2, B, 4, 10, hp, wp) int16.
__global__ void place_kernel(const float* __restrict__ vx,
                             const float* __restrict__ vy,
                             const float* __restrict__ vz, int B, int H,
                             int W, int pad, float r_lo, float r_step,
                             int* __restrict__ kbuf,
                             int16_t* __restrict__ buf, int pass) {
  int n_faces = (H - 1) * (W - 1);
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)2 * B * n_faces) return;
  int cell = (int)(t % n_faces);
  int b = (int)((t / n_faces) % B);
  int parity = (int)(t / ((long long)n_faces * B));
  int i = cell / (W - 1);
  int j = cell % (W - 1);
  int hp = H + 2 * pad;
  int wp = W + 2 * pad;

  // upper triangle (tl, bl, tr), lower (tr, bl, br): grid_faces order
  int r0, c0, r1, c1, r2, c2;
  if (parity == 0) {
    r0 = i; c0 = j; r1 = i + 1; c1 = j; r2 = i; c2 = j + 1;
  } else {
    r0 = i; c0 = j + 1; r1 = i + 1; c1 = j; r2 = i + 1; c2 = j + 1;
  }
  long long base = (long long)b * H * W;
  long long v0 = base + (long long)r0 * W + c0;
  long long v1 = base + (long long)r1 * W + c1;
  long long v2 = base + (long long)r2 * W + c2;
  float x0 = vx[v0], y0 = vy[v0], z0 = vz[v0];
  float x1 = vx[v1], y1 = vy[v1], z1 = vz[v1];
  float x2 = vx[v2], y2 = vy[v2], z2 = vz[v2];

  int bx2 = half_pixel_floor(x0, x1, x2);
  int by2 = half_pixel_floor(y0, y1, y2);
  bool inb = bx2 >= -2 * pad && bx2 < 2 * (wp - pad) && by2 >= -2 * pad &&
             by2 < 2 * (hp - pad);
  if (!inb) return;
  int s_x = bx2 + 2 * pad;  // in [0, 2*wp) when inb
  int s_y = by2 + 2 * pad;
  int qy = s_y / 2, sy = s_y % 2;
  int qx = s_x / 2, sx = s_x % 2;
  int16_t r0q = rq16(z0, r_lo, r_step);
  int zkey = ((32767 - (int)r0q) << 16) | cell;

  long long plane = (long long)hp * wp;
  long long phase = ((long long)parity * B + b) * 4 + sy * 2 + sx;
  long long pix = (long long)qy * wp + qx;
  int* slot = kbuf + phase * plane + pix;
  if (pass == 0) {
    atomicMin(slot, zkey);
    return;
  }
  if (*slot != zkey) return;
  float ax = (float)(qx - pad);
  float ay = (float)(qy - pad);
  int16_t ch[kChannels] = {
      fx16(x0, ax), fx16(y0, ay), fx16(x1, ax), fx16(y1, ay),
      fx16(x2, ax), fx16(y2, ay), r0q, rq16(z1, r_lo, r_step),
      rq16(z2, r_lo, r_step), (int16_t)cell};
  int16_t* dst = buf + phase * kChannels * plane + pix;
  for (int k = 0; k < kChannels; ++k) dst[k * plane] = ch[k];
}

// _cand_key_int, operation for operation.
__device__ __forceinline__ int cand_key(const float* c, int ox, int oy,
                                        int parity, int n_faces,
                                        const Quant& q) {
  float dx0 = c[0], dy0 = c[1], dx1 = c[2], dy1 = c[3], dx2 = c[4],
        dy2 = c[5], r0q = c[6], r1q = c[7], r2q = c[8], cell = c[9];
  float px2 = __fsub_rn((float)(256 * ox), dx2);
  float py2 = __fsub_rn((float)(256 * oy), dy2);
  float a = __fsub_rn(dy1, dy2);
  float bq = __fsub_rn(dx0, dx2);
  float e = __fsub_rn(dx2, dx1);
  float d = __fsub_rn(dy0, dy2);
  float denom = __fadd_rn(__fmul_rn(a, bq), __fmul_rn(e, d));
  bool ok_den = fabsf(denom) > 0.5f;
  float safe = ok_den ? denom : 1.0f;
  float l0 = __fdiv_rn(__fadd_rn(__fmul_rn(a, px2), __fmul_rn(e, py2)), safe);
  float f = __fsub_rn(dy2, dy0);
  float l1 = __fdiv_rn(__fadd_rn(__fmul_rn(f, px2), __fmul_rn(bq, py2)), safe);
  float l2 = __fsub_rn(__fsub_rn(1.0f, l0), l1);
  const float eps = -1e-5f;
  bool inside = l0 >= eps && l1 >= eps && l2 >= eps && ok_den && cell >= 0.0f;
  if (!inside) return kSentinel;
  float t0 = __fmul_rn(l0, __fadd_rn(q.r_lo, __fmul_rn(r0q, q.r_step)));
  float t1 = __fmul_rn(l1, __fadd_rn(q.r_lo, __fmul_rn(r1q, q.r_step)));
  float t2 = __fmul_rn(l2, __fadd_rn(q.r_lo, __fmul_rn(r2q, q.r_step)));
  float inv_z = __fadd_rn(__fadd_rn(t0, t1), t2);
  float z = __fdiv_rn(1.0f, fmaxf(inv_z, 1e-12f));
  float zq = __fmul_rn(__fsub_rn(z, q.near), q.depth_scale);
  zq = fminf(fmaxf(zq, 0.0f), 16383.0f);
  return ((int)zq << kFaceBits) | ((int)cell + parity * n_faces);
}

__global__ void tests_kernel(const int16_t* __restrict__ buf, int B, int H,
                             int W, int pad, int window, Quant q,
                             int* __restrict__ key_out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * H * W) return;
  int x = (int)(t % W);
  int y = (int)((t / W) % H);
  int b = (int)(t / ((long long)H * W));
  int hp = H + 2 * pad;
  int wp = W + 2 * pad;
  int n_faces = (H - 1) * (W - 1);
  long long plane = (long long)hp * wp;
  int best = kSentinel;
  float c[kChannels];
  for (int parity = 0; parity < 2; ++parity) {
    for (int oy = 0; oy < window; ++oy) {
      for (int sy = 0; sy < 2; ++sy) {
        for (int ox = 0; ox < window; ++ox) {
          for (int sx = 0; sx < 2; ++sx) {
            long long phase = ((long long)parity * B + b) * 4 + sy * 2 + sx;
            const int16_t* src = buf + phase * kChannels * plane +
                                 (long long)(y + pad - oy) * wp +
                                 (x + pad - ox);
            for (int k = 0; k < kChannels; ++k) c[k] = (float)src[k * plane];
            int key = cand_key(c, ox, oy, parity, n_faces, q);
            best = min(best, key);
          }
        }
      }
    }
  }
  key_out[t] = best;
}

}  // namespace

// One launch of place_kernel for `pass`; the caller runs pass 0, then pass 1,
// on the same kbuf and buf, which must hold kSentinel and -1 before pass 0.
extern "C" int g2s_raster_place(const float* vx, const float* vy,
                                const float* vz, int* kbuf, int16_t* buf,
                                int B, int H, int W, int pad, float r_lo,
                                float r_step, int pass, cudaStream_t stream) {
  long long n = (long long)2 * B * (H - 1) * (W - 1);
  if (n == 0) return 0;
  unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  place_kernel<<<blocks, kThreads, 0, stream>>>(vx, vy, vz, B, H, W, pad,
                                                r_lo, r_step, kbuf, buf, pass);
  return (int)cudaGetLastError();
}

extern "C" int g2s_raster_tests(const int16_t* buf, int* key, int B, int H,
                                int W, int pad, int window, float r_lo,
                                float r_step, float near, float depth_scale,
                                cudaStream_t stream) {
  long long n = (long long)B * H * W;
  if (n == 0) return 0;
  unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  Quant q{r_lo, r_step, near, depth_scale};
  tests_kernel<<<blocks, kThreads, 0, stream>>>(buf, B, H, W, pad, window, q,
                                                key);
  return (int)cudaGetLastError();
}
