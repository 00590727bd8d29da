// Hard z-buffer depth rasterizer of a warped pixel-grid mesh, for Hopper
// (sm_90a).  Built by deep3dmap_tpu_torch/ops/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared
// and called through ctypes by deep3dmap_tpu_torch/ops/raster.py.
//
// Replaces the Pallas TPU kernel deep3dmap_tpu/ops/raster_pallas.py
// (_raster_kernel, reached through raster_grid_depth_hard), and the
// projection in front of it.  The mesh is the (H, W) grid of projected
// vertices: quad (r, c) splits into triangle A = (v[r][c], v[r][c+1],
// v[r+1][c]) and B = (v[r+1][c+1], v[r+1][c], v[r][c+1]).  Every pixel keeps
// the least perspective-correct depth of the triangles that cover it, or
// `background` where none does.
//
// Bound on an H100: the larger of the bytes (the (B, H, W, 3) float32 points
// read and one float32 depth written: 16 B per pixel, over 3.35 TB/s) and
// the operations the function needs (~15 float32 operations for each pixel
// centre inside a valid triangle's bounding box, over 67 TFLOP/s).  A grid
// mesh's triangles are about a pixel wide, so the bytes bound it.
//
// Design.  The TPU kernel tests a 1024-pixel tile against 128-triangle
// chunks as dense vector work; a pixel-parallel port of it tests each pixel
// against every triangle of its band, ~600x the tests the function needs.
// Here the work follows the triangles instead:
//   * one entry, one stream, five device ops: a memset marks every output
//     word 0xFFFFFFFF (uncovered), a memset zeroes the overflow count,
//     tri_kernel, big_kernel, finalize_kernel;
//   * tri_kernel runs kLanes threads per triangle (neighbouring lane groups
//     on neighbouring quads, so the vertex loads coalesce).  Each lane
//     projects the three vertices itself (no projected grids in memory; the
//     group's loads are one broadcast), computes the triangle's terms, takes
//     a conservative bounding box (cull_box) and tests every kLanes-th pixel
//     centre in it.  A hit folds its depth into the output with atomicMin
//     on the float's bits: depths are positive and finite, so the unsigned
//     order is the float order, and a min is exact, so the order of the
//     atomics changes no bit.  One thread per triangle would leave ~8 warps
//     on an SM, each looping over ~16 pixels alone: latency-bound;
//   * a triangle whose box holds more than kFastPixels pixels is appended to
//     an overflow list instead; big_kernel, a fixed grid, splits each
//     listed triangle's box over gridDim / count blocks (at least one).
//     The count is read on the device only;
//   * finalize_kernel writes `background` over the words still uncovered.
// Nothing is staged in shared memory: a triangle touches ~1-4 pixels and a
// vertex is read by at most 6 triangles from L1/L2, so there is no tile to
// stage and no tensor-core work; what the card offers here is its L2 atomics
// and 132 SMs, filled in one wave (505 blocks at 128^2, B = 1).
//
// The box (cull_box, stated in Python by ops/raster.py::cull_box, which the
// CPU tests hold against the plain inside test) must hold every pixel the
// plain version's rounded inside test accepts.  A point outside the box by
// d has a barycentric <= -d / 2E in exact arithmetic (E: the triangle's
// extent), while rounding moves each one by up to ~2^-20 m E / |denom| for
// coordinates up to m (the differences pixel - vertex carry their
// magnitude).  So the box is, in float, [floor(min - u) - 1,
// ceil(max + u) + 1] on each axis with u = 2^-16 m E^2 / |denom| (a few
// thousandths of a pixel for a mesh triangle, the whole image for a sliver
// or for a wedge reaching 1e7 pixels away), clipped to the image before any
// cast, and the whole image where denom is not finite.
//
// Numerics.  Coverage is decided by float32 compares, so a pixel on a
// shared edge belongs to whichever triangle the rounding gives it.  Every
// operation here is an explicit round-to-nearest intrinsic, in the order of
// raster.py::project (z = clamp(p2, min=EPS), three divisions, then
// (p0*K00 + p1*K01) + p2*K02) and of raster_pallas.py:107-120 (and
// --fmad=false besides), so no multiply-add is fused and every division is
// IEEE: the kernel gives the plain PyTorch version (raster.py) the same
// pixels, bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;            // tri_kernel's threads per triangle
constexpr int kBigBlocks = 264;      // big_kernel's grid: 2 per SM
constexpr int kFastPixels = 64;      // larger boxes go to big_kernel
constexpr float kEps = 1e-7f;
constexpr float kDegenerate = 1e-9f;
constexpr float kMarginScale = 0x1p-16f;
constexpr unsigned kUncovered = 0xFFFFFFFFu;

struct Tri {
  float x2, y2, a0, b0, a1, b1, inv_d, z0, z1, z2;
  int x_lo, y_lo, nx, ny;   // the box; nx * ny pixels, 0 when dropped
};

// raster.py::project for vertex i of (B*H*W, 3) points
__device__ __forceinline__ void vertex(const float* __restrict__ P,
                                       const float* __restrict__ K, size_t i,
                                       float& x, float& y, float& z) {
  const float p0 = P[3 * i], p1 = P[3 * i + 1], p2 = P[3 * i + 2];
  z = p2 < kEps ? kEps : p2;   // torch.clamp(min=EPS): NaN stays NaN
  const float q0 = __fdiv_rn(p0, z), q1 = __fdiv_rn(p1, z),
              q2 = __fdiv_rn(p2, z);
  x = __fadd_rn(__fadd_rn(__fmul_rn(q0, K[0]), __fmul_rn(q1, K[1])),
                __fmul_rn(q2, K[2]));
  y = __fadd_rn(__fadd_rn(__fmul_rn(q0, K[3]), __fmul_rn(q1, K[4])),
                __fmul_rn(q2, K[5]));
}

// [lo, hi] on one axis of extent n, clipped in float; returns the count
__device__ __forceinline__ int axis_box(float cmin, float cmax, float u, int n,
                                       int& lo) {
  const float flo = fmaxf(floorf(__fsub_rn(cmin, u)) - 1.0f, 0.0f);
  const float fhi = fminf(ceilf(__fadd_rn(cmax, u)) + 1.0f, (float)(n - 1));
  if (!(fhi >= flo)) {   // off the image: no cast of a far coordinate
    lo = 0;
    return 0;
  }
  lo = (int)flo;
  return (int)fhi - lo + 1;
}

// Triangle t (all A triangles of item b first, as grid_mesh_triangles
// orders them): its terms and its box.
__device__ Tri load_tri(const float* __restrict__ P, const float* __restrict__ K,
                        int t, int H, int W) {
  const int nq = (H - 1) * (W - 1);
  const int b = t / (2 * nq), k = t % (2 * nq), q = k % nq;
  const int r = q / (W - 1), c = q % (W - 1);
  const size_t base = (size_t)b * H * W;
  size_t i0, i1, i2;
  if (k < nq) {   // A = (v00, v01, v10)
    i0 = base + (size_t)r * W + c; i1 = i0 + 1; i2 = i0 + W;
  } else {        // B = (v11, v10, v01)
    i0 = base + (size_t)(r + 1) * W + c + 1; i1 = i0 - 1; i2 = i0 - W;
  }
  float x0, y0, x1, y1, x2, y2;
  Tri T;
  vertex(P, K, i0, x0, y0, T.z0);
  vertex(P, K, i1, x1, y1, T.z1);
  vertex(P, K, i2, x2, y2, T.z2);
  T.x2 = x2; T.y2 = y2;
  T.a0 = __fsub_rn(y1, y2); T.b0 = __fsub_rn(x2, x1);
  T.a1 = __fsub_rn(y2, y0); T.b1 = __fsub_rn(x0, x2);
  // denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2); a NaN coordinate
  // makes it NaN and fails `ok` before any box is taken
  const float denom = __fadd_rn(__fmul_rn(T.a0, T.b1),
                                __fmul_rn(T.b0, __fsub_rn(y0, y2)));
  const bool ok = fabsf(denom) > kDegenerate && T.z0 > kEps &&
                  T.z1 > kEps && T.z2 > kEps;
  T.inv_d = __fdiv_rn(1.0f, denom);
  T.x_lo = T.y_lo = T.nx = T.ny = 0;
  if (!ok) return T;
  const float xmin = fminf(fminf(x0, x1), x2), xmax = fmaxf(fmaxf(x0, x1), x2);
  const float ymin = fminf(fminf(y0, y1), y2), ymax = fmaxf(fmaxf(y0, y1), y2);
  if (!isfinite(denom)) {   // the barycentrics overflow: the whole image
    T.nx = W; T.ny = H;
    return T;
  }
  // u bounds how far the rounded inside test can reach past the triangle:
  // its error over |l| at distance d is ~2^-18 m E^2 / (|denom| d) for
  // coordinates up to m and extent E (a sliver's or a far wedge's apex
  // rounds coarsely); inf when it overflows, which clips to the image
  const float ext = fmaxf(__fsub_rn(xmax, xmin), __fsub_rn(ymax, ymin));
  const float m = fmaxf(fmaxf(fmaxf(fabsf(xmin), fabsf(xmax)),
                              fmaxf(fabsf(ymin), fabsf(ymax))),
                        (float)max(W, H));
  const float u = __fmul_rn(__fmul_rn(m, kMarginScale),
                            __fmul_rn(ext, __fdiv_rn(ext, fabsf(denom))));
  T.nx = axis_box(xmin, xmax, u, W, T.x_lo);
  T.ny = axis_box(ymin, ymax, u, H, T.y_lo);
  return T;
}

// raster_pallas.py:107-120 for one pixel centre; folds a hit into `out`
__device__ __forceinline__ void test_pixel(const Tri& T, int px, int py,
                                           unsigned* __restrict__ out_b, int W) {
  const float dx2 = __fsub_rn((float)px, T.x2);
  const float dy2 = __fsub_rn((float)py, T.y2);
  const float l0 = __fmul_rn(
      __fadd_rn(__fmul_rn(T.a0, dx2), __fmul_rn(T.b0, dy2)), T.inv_d);
  const float l1 = __fmul_rn(
      __fadd_rn(__fmul_rn(T.a1, dx2), __fmul_rn(T.b1, dy2)), T.inv_d);
  const float l2 = __fsub_rn(__fsub_rn(1.0f, l0), l1);
  if (l0 >= 0.0f && l1 >= 0.0f && l2 >= 0.0f) {
    // perspective-correct depth: interpolate 1/z
    const float inv_z = __fadd_rn(
        __fadd_rn(__fdiv_rn(l0, T.z0), __fdiv_rn(l1, T.z1)),
        __fdiv_rn(l2, T.z2));
    const float z = __fdiv_rn(1.0f, fmaxf(inv_z, kEps));
    atomicMin(out_b + (size_t)py * W + px, __float_as_uint(z));
  }
}

__global__ void __launch_bounds__(kThreads)
tri_kernel(const float* __restrict__ P, const float* __restrict__ K,
           unsigned* __restrict__ out, int* __restrict__ big,
           int* __restrict__ n_big, int n_tri, int H, int W) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int t = g / kLanes, lane = g % kLanes;
  if (t >= n_tri) return;
  const Tri T = load_tri(P, K, t, H, W);
  const int n = T.nx * T.ny;
  if (n == 0) return;
  if (n > kFastPixels) {
    if (lane == 0) big[atomicAdd(n_big, 1)] = t;
    return;
  }
  unsigned* out_b = out + (size_t)(t / (2 * (H - 1) * (W - 1))) * H * W;
  int i = lane, j = 0;   // pixel `lane` of the box, row-major
  while (i >= T.nx) { i -= T.nx; ++j; }
  while (j < T.ny) {
    test_pixel(T, T.x_lo + i, T.y_lo + j, out_b, W);
    i += kLanes;
    while (i >= T.nx) { i -= T.nx; ++j; }
  }
}

__global__ void __launch_bounds__(kThreads)
big_kernel(const float* __restrict__ P, const float* __restrict__ K,
           unsigned* __restrict__ out, const int* __restrict__ big,
           const int* __restrict__ n_big, int H, int W) {
  const int count = *n_big;
  if (count == 0) return;
  // a few large triangles share the grid; many take a block each in turn
  const int split = max(1, (int)gridDim.x / count);
  for (int w = blockIdx.x; w < count * split; w += gridDim.x) {
    const int t = big[w / split];
    const Tri T = load_tri(P, K, t, H, W);   // every thread: same terms
    unsigned* out_b = out + (size_t)(t / (2 * (H - 1) * (W - 1))) * H * W;
    const int n = T.nx * T.ny;
    for (int p = (w % split) * kThreads + threadIdx.x; p < n;
         p += split * kThreads)
      test_pixel(T, T.x_lo + p % T.nx, T.y_lo + p / T.nx, out_b, W);
  }
}

__global__ void __launch_bounds__(kThreads)
finalize_kernel(unsigned* __restrict__ out, size_t n, float background) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n && out[i] == kUncovered) out[i] = __float_as_uint(background);
}

}  // namespace

// points: (B, H, W, 3) float32 camera points, K: (3, 3) float32, both
// contiguous on the device; out: (B, H, W) float32; big: B*2*(H-1)*(W-1)
// int32 scratch (the overflow list); n_big: one int32 (its count).
// Enqueues its five device ops on `stream` and returns the first CUDA error
// (0 when every op was accepted).
extern "C" int d3m_raster_grid_depth_hard(const float* points, const float* K,
                                          float* out, int* big, int* n_big,
                                          int B, int H, int W,
                                          float background, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n_pix = (size_t)B * H * W;
  unsigned* o = reinterpret_cast<unsigned*>(out);
  cudaError_t err = cudaMemsetAsync(o, 0xFF, n_pix * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(n_big, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (H > 1 && W > 1) {
    const int n_tri = 2 * B * (H - 1) * (W - 1);
    tri_kernel<<<(kLanes * n_tri + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        points, K, o, big, n_big, n_tri, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    big_kernel<<<kBigBlocks, kThreads, 0, s>>>(points, K, o, big, n_big, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  finalize_kernel<<<(unsigned)((n_pix + kThreads - 1) / kThreads), kThreads, 0,
                    s>>>(o, n_pix, background);
  return (int)cudaGetLastError();
}
