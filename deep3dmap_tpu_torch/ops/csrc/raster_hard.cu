// Hard z-buffer depth rasterizer of a warped pixel-grid mesh, for Hopper
// (sm_90a).  Built by deep3dmap_tpu_torch/ops/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared
// and called through ctypes by deep3dmap_tpu_torch/ops/raster.py.
//
// Replaces the Pallas TPU kernel deep3dmap_tpu/ops/raster_pallas.py
// (_raster_kernel, reached through raster_grid_depth_hard).  The mesh is the
// (H, W) grid of projected vertices: quad (r, c) splits into triangle
// A = (v[r][c], v[r][c+1], v[r+1][c]) and B = (v[r+1][c+1], v[r+1][c],
// v[r][c+1]).  Every pixel keeps the least perspective-correct depth of the
// triangles that cover it, or `background` where none does.
//
// Bound on an H100: the larger of the bytes (three float32 grids in, one
// out: 16 B per pixel, over 3.35 TB/s) and the operations the function
// needs (~15 float32 operations for each pixel centre inside a valid
// triangle's bounding box, over 67 TFLOP/s).  A grid mesh's triangles are
// about a pixel wide, so the bytes bound it.
//
// Design.  The TPU kernel tests a 1024-pixel tile against 128-triangle
// chunks as dense (1024, 128) vector work and skips chunks by their integer
// row range.  Here:
//   * one thread per pixel; a block of 256 threads covers 256 consecutive
//     pixels of one image, i.e. a band of rows [ty0, ty1];
//   * a chunk is one row of quads (2(W-1) triangles); row_bounds_kernel
//     first finds every grid row's y-range, so a block skips a quad row whose
//     range misses its band without reading its vertices;
//   * for a quad row that survives, the block builds its triangles straight
//     from the vertex grids (no triangle list in device memory), drops those
//     that are degenerate, behind the camera or whose own y-range misses the
//     band, and compacts the rest into shared memory with their per-triangle
//     terms precomputed;
//   * each thread folds a running min in a register and writes once.
// Culling is conservative: in float, floor(ymin) - 1 <= ty1 and
// ceil(ymax) + 1 >= ty0 (one row more than the TPU kernel keeps on each side),
// and no coordinate is converted to an integer, so a vertex clamped to
// z = 1e-7 (x, y ~ 1e7 pixels or more) cannot overflow a cast.
//
// Numerics.  Coverage is decided by float32 compares, so a pixel on a
// shared edge belongs to whichever triangle the rounding gives it.  Every
// operation here is an explicit round-to-nearest intrinsic in the order of
// raster_pallas.py:107-120 (and --fmad=false besides), so no multiply-add is
// fused and the division is IEEE: the kernel gives the plain PyTorch version
// (raster.py) the same pixels.  The min over triangles is exact, so the
// order in which they are visited does not matter.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;       // pixels per block
constexpr int kRowsPerBoundsBlock = 8;
constexpr float kEps = 1e-7f;
constexpr float kDegenerate = 1e-9f;

// Per grid row (b, r): min and max of the projected y over the W vertices.
__global__ void row_bounds_kernel(const float* __restrict__ py,
                                  float* __restrict__ rowlo,
                                  float* __restrict__ rowhi, int n_rows, int W) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBoundsBlock + warp;
  if (row >= n_rows) return;
  const float* y = py + (size_t)row * W;
  float lo = INFINITY, hi = -INFINITY;
  for (int c = lane; c < W; c += 32) {
    lo = fminf(lo, y[c]);   // fminf/fmaxf skip NaN: such a vertex's
    hi = fmaxf(hi, y[c]);   // triangles fail the denominator test anyway
  }
  for (int off = 16; off > 0; off /= 2) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) {
    rowlo[row] = lo;
    rowhi[row] = hi;
  }
}

__device__ __forceinline__ bool overlaps(float lo, float hi, float ty0,
                                         float ty1) {
  return floorf(lo) - 1.0f <= ty1 && ceilf(hi) + 1.0f >= ty0;
}

__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ px, const float* __restrict__ py,
              const float* __restrict__ pz, const float* __restrict__ rowlo,
              const float* __restrict__ rowhi, float* __restrict__ out, int H,
              int W, float background) {
  // compacted triangles of the current slice of a quad row: vertex 2 and the
  // terms of raster_pallas.py:107-113 that depend on the triangle alone
  __shared__ float s_x2[kThreads], s_y2[kThreads];
  __shared__ float s_a0[kThreads], s_b0[kThreads];   // y1 - y2, x2 - x1
  __shared__ float s_a1[kThreads], s_b1[kThreads];   // y2 - y0, x0 - x2
  __shared__ float s_invd[kThreads];
  __shared__ float s_z0[kThreads], s_z1[kThreads], s_z2[kThreads];
  __shared__ int s_count;

  const int b = blockIdx.y;
  const int HW = H * W;
  const int p0 = blockIdx.x * kThreads;
  const int lin = p0 + threadIdx.x;
  const float pxp = (float)(lin % W);
  const float pyp = (float)(lin / W);
  const float ty0 = (float)(p0 / W);
  const float ty1 = (float)(min(p0 + kThreads - 1, HW - 1) / W);

  const float* X = px + (size_t)b * HW;
  const float* Y = py + (size_t)b * HW;
  const float* Z = pz + (size_t)b * HW;
  const float* lo_b = rowlo + (size_t)b * H;
  const float* hi_b = rowhi + (size_t)b * H;
  const int n_tri = 2 * (W - 1);

  float zbuf = INFINITY;
  for (int r = 0; r + 1 < H; ++r) {
    // block-uniform: skip the quad row when its y-range misses the band
    if (!overlaps(fminf(lo_b[r], lo_b[r + 1]), fmaxf(hi_b[r], hi_b[r + 1]),
                  ty0, ty1))
      continue;
    for (int k0 = 0; k0 < n_tri; k0 += kThreads) {
      if (threadIdx.x == 0) s_count = 0;
      __syncthreads();
      const int k = k0 + threadIdx.x;
      if (k < n_tri) {
        const int c = k >> 1;
        int i0, i1, i2;
        if ((k & 1) == 0) {   // A = (v00, v01, v10)
          i0 = r * W + c; i1 = r * W + c + 1; i2 = (r + 1) * W + c;
        } else {              // B = (v11, v10, v01)
          i0 = (r + 1) * W + c + 1; i1 = (r + 1) * W + c; i2 = r * W + c + 1;
        }
        const float x0 = X[i0], x1 = X[i1], x2 = X[i2];
        const float y0 = Y[i0], y1 = Y[i1], y2 = Y[i2];
        const float z0 = Z[i0], z1 = Z[i1], z2 = Z[i2];
        const float a0 = __fsub_rn(y1, y2), b0 = __fsub_rn(x2, x1);
        const float a1 = __fsub_rn(y2, y0), b1 = __fsub_rn(x0, x2);
        // denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        const float denom = __fadd_rn(__fmul_rn(a0, b1),
                                      __fmul_rn(b0, __fsub_rn(y0, y2)));
        const bool ok = fabsf(denom) > kDegenerate && z0 > kEps &&
                        z1 > kEps && z2 > kEps;
        const float tlo = fminf(fminf(y0, y1), y2);
        const float thi = fmaxf(fmaxf(y0, y1), y2);
        if (ok && overlaps(tlo, thi, ty0, ty1)) {
          const int s = atomicAdd(&s_count, 1);
          s_x2[s] = x2; s_y2[s] = y2;
          s_a0[s] = a0; s_b0[s] = b0; s_a1[s] = a1; s_b1[s] = b1;
          s_invd[s] = __fdiv_rn(1.0f, denom);
          s_z0[s] = z0; s_z1[s] = z1; s_z2[s] = z2;
        }
      }
      __syncthreads();
      const int n = s_count;
      for (int t = 0; t < n; ++t) {
        const float dx2 = __fsub_rn(pxp, s_x2[t]);
        const float dy2 = __fsub_rn(pyp, s_y2[t]);
        const float inv_d = s_invd[t];
        const float l0 = __fmul_rn(
            __fadd_rn(__fmul_rn(s_a0[t], dx2), __fmul_rn(s_b0[t], dy2)), inv_d);
        const float l1 = __fmul_rn(
            __fadd_rn(__fmul_rn(s_a1[t], dx2), __fmul_rn(s_b1[t], dy2)), inv_d);
        const float l2 = __fsub_rn(__fsub_rn(1.0f, l0), l1);
        if (l0 >= 0.0f && l1 >= 0.0f && l2 >= 0.0f) {
          // perspective-correct depth: interpolate 1/z
          const float inv_z = __fadd_rn(
              __fadd_rn(__fdiv_rn(l0, s_z0[t]), __fdiv_rn(l1, s_z1[t])),
              __fdiv_rn(l2, s_z2[t]));
          zbuf = fminf(zbuf, __fdiv_rn(1.0f, fmaxf(inv_z, kEps)));
        }
      }
      __syncthreads();
    }
  }
  if (lin < HW) out[(size_t)b * HW + lin] = isinf(zbuf) ? background : zbuf;
}

}  // namespace

// px, py, pz: (B, H, W) float32, contiguous, on the device (projected x, y
// in pixels and camera depth, clamped to >= 1e-7).  rowlo, rowhi: (B, H)
// float32 scratch.  out: (B, H, W) float32.  Launches on `stream` and returns
// cudaGetLastError() (0 when both launches were accepted).
extern "C" int d3m_raster_grid_depth_hard(const float* px, const float* py,
                                          const float* pz, float* rowlo,
                                          float* rowhi, float* out, int B,
                                          int H, int W, float background,
                                          void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rows = B * H;
  row_bounds_kernel<<<(n_rows + kRowsPerBoundsBlock - 1) / kRowsPerBoundsBlock,
                      32 * kRowsPerBoundsBlock, 0, s>>>(py, rowlo, rowhi,
                                                        n_rows, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  raster_kernel<<<grid, kThreads, 0, s>>>(px, py, pz, rowlo, rowhi, out, H, W,
                                          background);
  return (int)cudaGetLastError();
}
