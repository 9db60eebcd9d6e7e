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
// Three kernels, in two stages:
//   1. placement, one C call (g2s_raster_place) that issues a memset and two
//      launches: the payload slot of each face and parity is its half-pixel
//      bbox start, its 10-channel int16 payload that of
//      _build_winner_buffers, and a slot that several faces reach holds the
//      nearest, the one with the least (32767 - r0q) << 16 | cell key.
//      place_collide_kernel (a thread per face) merges every face's key into
//      an int32 scratch plane by atomicMax, after a memset has cleared it
//      (the scratch holds 2^31 - key, so 0 is empty); place_write_kernel (a
//      thread per slot) reads its slot's key and writes -1, or the winner's
//      payload rebuilt from the cell in the key, to the 10 channel planes.
//      Faces outside the padded viewport are dropped, which is what the
//      unique dump slots of the JAX version amount to.
//      _raster_mega_pallas_v2 also drops faces displaced more than DY_CAP =
//      96 rows; this placement, like the buffers path it is held to, keeps
//      them.
//   2. candidate tests (tests_kernel): the 2 parities x 4 phases x window^2
//      tests of _winner_tests per output pixel, and its int32 min key.  A
//      block owns a 32 x 16 tile of one batch element (32 x 8 where the call
//      has too few tiles to fill the card).  For each of the 8 (parity, sy,
//      sx) phases it decodes the slab of slots its pixels test (the tile plus
//      a window-1 halo) and lists in shared memory only the slots that some
//      offset can accept, with every term of _cand_key_int that does not
//      depend on the offset (a, bq, e, denom, f, the three r_lo + r * r_step
//      terms, the face id).  Empty and degenerate slots, most of the slab,
//      cost nothing more.  Then one thread per listed slot runs its window^2
//      offset tests: px2, py2 and the two numerators; a sign test that
//      proves the candidate outside before its divisions (surely_negative);
//      the two divisions, l2 and the inside test; and, where inside, the
//      depth terms.  It merges the key into its pixel's minimum with a
//      shared-memory atomicMin, which does not depend on order.  window is
//      at most 5 (the grid mode's cap); the C entry refuses larger ones.
//
// How a phase's payloads reach the block.  Each thread reads its slots' 10
// int16 channels with plain loads into registers and decodes them there;
// only the listed slots' terms go to shared memory.  Three ways were timed
// in turns on an H100 at B=16, 128 px (numbers in PERF.md): on the 32 x 16
// tiles loading phase k at the top of phase k was fastest.  Loading phase
// k+1 into registers while phase k tests was 8-23% slower: its 30 live
// registers pushed the 64 that 4 blocks an SM allow into spills, and with 4
// blocks an SM the others' tests already hide one block's loads.  The 32 x
// 8 tiles of small calls keep that prefetch: there a block is alone on its
// SM with 96 registers and no spill, and at B=1 it saved 7% at window 5
// and nothing at window 3.  Staging the slab into shared memory by 4-byte
// cp.async, double-buffered, was 14% slower at window 3 and 42% at window
// 5, where the staged slab takes a block from 37 to 65 KB and an SM from 4
// resident blocks to 3.  TMA cannot address the pinned
// payload layout: a tensor map's row pitch must be a multiple of 16 bytes,
// and a padded plane's row is W + 2 window + 2 int16, 280 bytes at W = 128,
// window 5.
//
// Bit-exactness with the plain version: every float operation on the key path
// is written with an explicit round-to-nearest intrinsic in the order the
// JAX expression evaluates it, this file is built with --fmad=false, division
// stays IEEE, and rounding is rintf (half to even, as jnp.round/torch.round).
// Hoisting a term out of the offset loop does not change its value, and the
// early reject drops only candidates that the inside test rejects.
//
// What bounds it on an H100.  Placement: bytes.  At B=16, 128 px, window 3
// the payload buffers are 47 MB of int16 (2 parities x 4 phases x 10
// channels of the padded grid): placement writes them, the tests read them,
// ~14 us each at 3.35 TB/s (~15 us at window 5).  About a fifth of the
// slots hold a face, but every slot must be written, so the write pass owns
// the slots and writes each once, coalesced, with no fill first.  On an
// H100 (700 W) it took 0.031 ms where torch.full of the same 47 MB takes
// 0.023 (writes run near 2.1 TB/s); the memset of the 9.5 MB key scratch
// 0.0034 and the collide pass 0.006, against 0.114 ms for a placement of a
// thread per face in both passes after two fills, whose winners' 10
// scattered 2-byte stores alone took 0.077.  Two variants lost there: a
// thread per 8 slots with one 16-byte store per channel (0.038 ms: 101
// registers cut the threads in flight to a third), and a key scratch kept
// between calls and cleared by the write pass instead of a memset (as fast
// at B=16, 1 us faster at B=1: not worth state that outlives the call).
// The tests' arithmetic is small: ~15 f32 operations per slot that holds a
// face, ~8 per offset test of such a slot and ~18 more where the candidate
// covers its pixel, a few us at the f32 rate, so bytes bound both windows.
// (An older count of ~25 per candidate, empty slots included, and ~17 per
// covering one put window 5 at ~20 us of operations; chip_smoke keeps it as
// a yardstick.)  A
// thread per pixel that decodes each of its candidates' slots from 10
// scalar int16 loads ran 10-24x the bytes bound: every warp paid the whole
// test for every candidate, since some lane's slot was always full.
// Listing the full slots (about a fifth of the slab) and decoding each once
// per block does the tests' arithmetic only where it can matter; each slot
// is read 1.2x (window 3) to 1.4x (window 5) per phase.  No gradient flows
// here: the caller re-interpolates the winner's vertices differentiably.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFaceBits = 17;
constexpr int kSentinel = 0x7fffffff;
constexpr int kChannels = 10;
constexpr int kThreads = 256;
constexpr int kWriteThreads = 128;  // the write pass's blocks, as timed

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

// A slot's collision key as the key buffer holds it: 2^31 - zkey, where
// zkey = (32767 - r0q) << 16 | cell is the merge key of the plain version.
// Nearest-wins, the minimum zkey, is the maximum of this, every face's value
// is at least 1, and 0 marks an empty slot, so a memset clears the buffer.
__device__ __forceinline__ unsigned slot_key(int zkey) {
  return 0x80000000u - (unsigned)zkey;
}

// The three vertex ids of face (parity, b, i, j): upper triangle (tl, bl, tr),
// lower (tr, bl, br), in grid_faces order.
__device__ __forceinline__ void face_vertices(int parity, int b, int i, int j,
                                              int H, int W, long long v[3]) {
  const long long base = (long long)b * H * W + (long long)i * W + j;
  v[0] = parity == 0 ? base : base + 1;
  v[1] = base + W;
  v[2] = parity == 0 ? base + 1 : base + W + 1;
}

// Collide pass: one thread per face of (parity, b) = blockIdx.y.  Loads what
// the slot and its key need (x and y of the three vertices and z0), drops
// faces outside the padded viewport, and atomicMax'es the face's key into
// its slot.  kbuf: (2, B, 4, hp, wp) unsigned, all 0 before the launch.
__global__ void place_collide_kernel(const float* __restrict__ vx,
                                     const float* __restrict__ vy,
                                     const float* __restrict__ vz, int B,
                                     int H, int W, int pad, float r_lo,
                                     float r_step,
                                     unsigned* __restrict__ kbuf) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= (H - 1) * (W - 1)) return;
  const int b = blockIdx.y % B;
  const int parity = blockIdx.y / B;
  const int hp = H + 2 * pad;
  const int wp = W + 2 * pad;
  long long v[3];
  face_vertices(parity, b, cell / (W - 1), cell % (W - 1), H, W, v);
  const int bx2 = half_pixel_floor(vx[v[0]], vx[v[1]], vx[v[2]]);
  const int by2 = half_pixel_floor(vy[v[0]], vy[v[1]], vy[v[2]]);
  if (!(bx2 >= -2 * pad && bx2 < 2 * (wp - pad) && by2 >= -2 * pad &&
        by2 < 2 * (hp - pad)))
    return;
  const int s_x = bx2 + 2 * pad;  // in [0, 2 * wp)
  const int s_y = by2 + 2 * pad;
  const long long phase = ((long long)parity * B + b) * 4 + (s_y & 1) * 2 +
                          (s_x & 1);
  const int zkey = ((32767 - (int)rq16(vz[v[0]], r_lo, r_step)) << 16) | cell;
  atomicMax(kbuf + (phase * hp + (s_y >> 1)) * wp + (s_x >> 1),
            slot_key(zkey));
}

// Write pass: one thread per slot (qy, qx) of phase ((parity * B) + b) * 4 +
// sy * 2 + sx = blockIdx.y, consecutive threads along qx, so each of a
// warp's 10 stores covers 32 consecutive int16 of one channel plane and
// every slot is written once.  An empty slot gets -1 in every channel; a won
// one the winner's payload, from the cell in its key and the slot's own
// parity and batch element.  Empty slots run the arithmetic on cell 0 and
// keep -1, so no warp branches.  buf: (2, B, 2, 2, 10, hp, wp) int16, whole.
__global__ void place_write_kernel(const float* __restrict__ vx,
                                   const float* __restrict__ vy,
                                   const float* __restrict__ vz, int B, int H,
                                   int W, int pad, float r_lo, float r_step,
                                   const unsigned* __restrict__ kbuf,
                                   int16_t* __restrict__ buf) {
  const int wp = W + 2 * pad;
  const int plane = (H + 2 * pad) * wp;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= plane) return;
  const int phase = blockIdx.y;
  const unsigned key = kbuf[(long long)phase * plane + pix];
  const bool won = key != 0;
  const int zkey = won ? (int)(0x80000000u - key) : 0;
  const int cell = zkey & 0xffff;
  long long v[3];
  face_vertices(phase / (4 * B), (phase >> 2) % B, cell / (W - 1),
                cell % (W - 1), H, W, v);
  // the slot's integer-pixel anchor, as the collide pass placed the face
  const float ax = (float)(pix % wp - pad);
  const float ay = (float)(pix / wp - pad);
  const int16_t ch[kChannels] = {
      fx16(vx[v[0]], ax), fx16(vy[v[0]], ay), fx16(vx[v[1]], ax),
      fx16(vy[v[1]], ay), fx16(vx[v[2]], ax), fx16(vy[v[2]], ay),
      (int16_t)(32767 - (zkey >> 16)),  // r0q, as the key holds it
      rq16(vz[v[1]], r_lo, r_step), rq16(vz[v[2]], r_lo, r_step),
      (int16_t)cell};
  int16_t* dst = buf + (long long)phase * kChannels * plane + pix;
#pragma unroll
  for (int k = 0; k < kChannels; ++k)
    dst[k * plane] = won ? ch[k] : (int16_t)-1;
}

// True only where l = RN(n / safe) < -1e-5, so the candidate is outside.
// Proof: the signs of n and safe differ and |n| > RN(4e-5 |safe|) >=
// 4e-5 |safe| (1 - 2^-24) (4e-5f is 4e-5 within 2^-24 relative), so the exact
// quotient is below -3.9999e-5 and, rounding being monotone, so is l: below
// eps = -1e-5 with a margin far above any rounding.  A zero n is never
// rejected.  |safe| > 0.5 on every slot that reaches this test.
__device__ __forceinline__ bool surely_negative(float n, float safe) {
  return (__float_as_int(n) ^ __float_as_int(safe)) < 0 &&
         fabsf(n) > __fmul_rn(4e-5f, fabsf(safe));
}

constexpr int kTestsTileX = 32;
// 32 x 16 tiles where a call has at least two of them for each of an H100's
// 132 SMs, 32 x 8 tiles (twice as many blocks) below that
constexpr int kSmallGridTiles = 264;

// One block: a kTestsTileX x TY tile of output pixels of one batch element.
// For each of the 8 (parity, sy, sx) phases the block
//   1. decodes the slab of slots its pixels test (the tile plus a WIN-1 halo
//      above and left; each thread owns slots threadIdx.x + j * kThreads) and
//      appends every slot that some offset can accept to a list in shared
//      memory, with the terms of _cand_key_int that do not depend on the
//      offset: a, bq, e, f, denom (safe), dx2, dy2, the three
//      r_lo + r * r_step terms and the face id.  Empty slots (cell < 0) and
//      degenerate ones (|denom| <= 0.5) cannot win at any offset, and they
//      are most slots, so they cost nothing further.
//   2. runs, one listed slot per thread, the WIN^2 offset-dependent tests of
//      that slot and merges each covering candidate's key into its pixel's
//      minimum with a shared-memory atomicMin.  The list's order depends on
//      the atomics, but a minimum does not depend on order, so the keys are
//      the same from run to run.
// Each phase's int16 payloads are loaded into registers at the top of the
// phase (32 x 16 tiles) or while the previous phase tests (32 x 8 tiles).
template <int WIN, int TY>
__global__ void __launch_bounds__(kThreads, TY == 16 ? 4 : 1)
tests_kernel(const int16_t* __restrict__ buf, int B, int H, int W, int pad,
             Quant q, int* __restrict__ key_out) {
  constexpr int TX = kTestsTileX;
  constexpr int SW = TX + WIN - 1;
  constexpr int SH = TY + WIN - 1;
  constexpr int NS = SW * SH;
  constexpr int PER = (NS + kThreads - 1) / kThreads;
  constexpr int NPIX = TX * TY;
  // load phase k+1 while phase k tests only on the small tiles, whose blocks
  // are alone on their SM and have registers to spare (see the file's note)
  constexpr bool PREFETCH = TY == 8;
  // the phase's list of slots that can cover a pixel; pos = slab index
  __shared__ float s_dx2[NS], s_dy2[NS], s_a[NS], s_e[NS], s_f[NS], s_bq[NS],
      s_safe[NS], s_z0[NS], s_z1[NS], s_z2[NS];
  __shared__ int s_key[NS], s_pos[NS];
  __shared__ int s_best[NPIX];
  __shared__ int s_count[2];

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TY;
  const int tx0 = blockIdx.x * TX;
  const int hp = H + 2 * pad;
  const int wp = W + 2 * pad;
  const int n_faces = (H - 1) * (W - 1);
  const long long plane = (long long)hp * wp;
  // padded row and column of slab slot 0: the slot that pixel (ty0, tx0)
  // tests at offset (WIN-1, WIN-1)
  const int r0 = ty0 + pad - (WIN - 1);
  const int c0 = tx0 + pad - (WIN - 1);

  int16_t raw[PER][kChannels];
  auto load = [&](int k) {
    const long long phase = ((long long)(k >> 2) * B + b) * 4 + (k & 3);
    const int16_t* src = buf + phase * kChannels * plane;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int i = threadIdx.x + j * kThreads;
      int r = r0 + i / SW, c = c0 + i % SW;
      bool in = i < NS && r < hp && c < wp;
      const int16_t* p = src + (long long)r * wp + c;
#pragma unroll
      for (int ch = 0; ch < kChannels; ++ch)
        raw[j][ch] = in ? p[ch * plane] : (int16_t)-1;
    }
  };

  for (int i = threadIdx.x; i < NPIX; i += kThreads) s_best[i] = kSentinel;
  if (threadIdx.x < 2) s_count[threadIdx.x] = 0;
  const float eps = -1e-5f;
  if (PREFETCH) load(0);
  for (int k = 0; k < 8; ++k) {
    const int parity = k >> 2;
    // phase k-1's tests are done with the list; s_count[k & 1] is zero
    __syncthreads();
    if (!PREFETCH) load(k);
    if (threadIdx.x == 0) s_count[(k + 1) & 1] = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int16_t* rw = raw[j];
      if (i >= NS || rw[9] < 0) continue;
      // _cand_key_int's offset-free terms, operation for operation
      float dx0 = rw[0], dy0 = rw[1], dx1 = rw[2], dy1 = rw[3], dx2 = rw[4],
            dy2 = rw[5], r0q = rw[6], r1q = rw[7], r2q = rw[8], cell = rw[9];
      float a = __fsub_rn(dy1, dy2);
      float bq = __fsub_rn(dx0, dx2);
      float e = __fsub_rn(dx2, dx1);
      float d = __fsub_rn(dy0, dy2);
      float denom = __fadd_rn(__fmul_rn(a, bq), __fmul_rn(e, d));
      if (!(fabsf(denom) > 0.5f)) continue;
      const int o = atomicAdd(&s_count[k & 1], 1);
      s_dx2[o] = dx2;
      s_dy2[o] = dy2;
      s_a[o] = a;
      s_e[o] = e;
      s_f[o] = __fsub_rn(dy2, dy0);
      s_bq[o] = bq;
      s_safe[o] = denom;
      s_z0[o] = __fadd_rn(q.r_lo, __fmul_rn(r0q, q.r_step));
      s_z1[o] = __fadd_rn(q.r_lo, __fmul_rn(r1q, q.r_step));
      s_z2[o] = __fadd_rn(q.r_lo, __fmul_rn(r2q, q.r_step));
      s_key[o] = (int)cell + parity * n_faces;
      s_pos[o] = i;
    }
    if (PREFETCH && k < 7) load(k + 1);
    __syncthreads();
    const int n = s_count[k & 1];
    for (int o = threadIdx.x; o < n; o += kThreads) {
      const float dx2 = s_dx2[o], dy2 = s_dy2[o], a = s_a[o], e = s_e[o],
                  f = s_f[o], bq = s_bq[o], safe = s_safe[o];
      const int cell_key = s_key[o];
      // the tile pixel that tests this slot at offset (oy, ox) is
      // (sr + oy, sc + ox)
      const int sr = s_pos[o] / SW - (WIN - 1);
      const int sc = s_pos[o] % SW - (WIN - 1);
#pragma unroll
      for (int oy = 0; oy < WIN; ++oy) {
        const int py = sr + oy;
        if (py < 0 || py >= TY) continue;
#pragma unroll
        for (int ox = 0; ox < WIN; ++ox) {
          const int px = sc + ox;
          if (px < 0 || px >= TX) continue;
          // the offset-dependent part of _cand_key_int, in its order
          float px2 = __fsub_rn((float)(256 * ox), dx2);
          float py2 = __fsub_rn((float)(256 * oy), dy2);
          float n0 = __fadd_rn(__fmul_rn(a, px2), __fmul_rn(e, py2));
          if (surely_negative(n0, safe)) continue;
          float n1 = __fadd_rn(__fmul_rn(f, px2), __fmul_rn(bq, py2));
          if (surely_negative(n1, safe)) continue;
          float l0 = __fdiv_rn(n0, safe);
          float l1 = __fdiv_rn(n1, safe);
          float l2 = __fsub_rn(__fsub_rn(1.0f, l0), l1);
          if (!(l0 >= eps && l1 >= eps && l2 >= eps)) continue;
          float t0 = __fmul_rn(l0, s_z0[o]);
          float t1 = __fmul_rn(l1, s_z1[o]);
          float t2 = __fmul_rn(l2, s_z2[o]);
          float inv_z = __fadd_rn(__fadd_rn(t0, t1), t2);
          float z = __fdiv_rn(1.0f, fmaxf(inv_z, 1e-12f));
          float zq = __fmul_rn(__fsub_rn(z, q.near), q.depth_scale);
          zq = fminf(fmaxf(zq, 0.0f), 16383.0f);
          atomicMin(&s_best[py * TX + px], ((int)zq << kFaceBits) | cell_key);
        }
      }
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < NPIX; l += kThreads) {
    const int y = ty0 + l / TX, x = tx0 + l % TX;
    if (y < H && x < W) key_out[((long long)b * H + y) * W + x] = s_best[l];
  }
}

template <int WIN>
void launch_tests(const int16_t* buf, int* key, int B, int H, int W, int pad,
                  Quant q, cudaStream_t stream) {
  const int gx = (W + kTestsTileX - 1) / kTestsTileX;
  if ((long long)gx * ((H + 15) / 16) * B >= kSmallGridTiles) {
    dim3 grid(gx, (H + 15) / 16, B);
    tests_kernel<WIN, 16><<<grid, kThreads, 0, stream>>>(buf, B, H, W, pad,
                                                         q, key);
  } else {
    dim3 grid(gx, (H + 7) / 8, B);
    tests_kernel<WIN, 8><<<grid, kThreads, 0, stream>>>(buf, B, H, W, pad, q,
                                                        key);
  }
}

}  // namespace

// The whole placement on `stream`: clear the key scratch kbuf (2, B, 4, hp,
// wp) unsigned, the collide pass, then the write pass, which fills buf
// (2, B, 2, 2, 10, hp, wp) int16 whole.  0 < B <= 8191 (the grid's y), H
// and W > 1 and (H - 1) (W - 1) <= 65536 (a cell fits the key's 16 bits).
extern "C" int g2s_raster_place(const float* vx, const float* vy,
                                const float* vz, unsigned* kbuf, int16_t* buf,
                                int B, int H, int W, int pad, float r_lo,
                                float r_step, cudaStream_t stream) {
  const int n_cells = (H - 1) * (W - 1);
  const int plane = (H + 2 * pad) * (W + 2 * pad);
  cudaError_t err = cudaMemsetAsync(
      kbuf, 0, (size_t)2 * B * 4 * plane * sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  dim3 faces((n_cells + kThreads - 1) / kThreads, 2 * B);
  place_collide_kernel<<<faces, kThreads, 0, stream>>>(vx, vy, vz, B, H, W,
                                                       pad, r_lo, r_step,
                                                       kbuf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 slots((plane + kWriteThreads - 1) / kWriteThreads, 2 * B * 4);
  place_write_kernel<<<slots, kWriteThreads, 0, stream>>>(
      vx, vy, vz, B, H, W, pad, r_lo, r_step, kbuf, buf);
  return (int)cudaGetLastError();
}

// window in [1, 5]; anything else is refused (cudaErrorInvalidValue).
extern "C" int g2s_raster_tests(const int16_t* buf, int* key, int B, int H,
                                int W, int pad, int window, float r_lo,
                                float r_step, float near, float depth_scale,
                                cudaStream_t stream) {
  if ((long long)B * H * W == 0) return 0;
  Quant q{r_lo, r_step, near, depth_scale};
  switch (window) {
    case 1: launch_tests<1>(buf, key, B, H, W, pad, q, stream); break;
    case 2: launch_tests<2>(buf, key, B, H, W, pad, q, stream); break;
    case 3: launch_tests<3>(buf, key, B, H, W, pad, q, stream); break;
    case 4: launch_tests<4>(buf, key, B, H, W, pad, q, stream); break;
    case 5: launch_tests<5>(buf, key, B, H, W, pad, q, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
