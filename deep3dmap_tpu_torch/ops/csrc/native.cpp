// deep3dmap_tpu_torch native host ops (CPython C API + numpy): the port's
// copy of deep3dmap_tpu/native/csrc/native.cpp, built by g++ at first use
// (ops/native.py).  These are CPU loops of the evaluation and mesh export --
// z-buffered mesh rasterization and marching tetrahedra -- not device
// kernels: nothing here touches the GPU.
//
// Exports:
//   rasterize_mesh(verts f32 (N,3), faces i64 (F,3), colors f32 (N,C),
//                  h, w) -> (image f32 (h,w,C), depth f32 (h,w))
//       Orthographic-style z-buffer rasterization: verts already in pixel
//       coords (x, y, z), z smaller = nearer.  Barycentric color interp.
//   render_depth(verts, faces, h, w) -> depth f32 (h,w)  [0 where empty]
//   marching_tets(vol f32 (X,Y,Z), level) -> (verts f32 (V,3), faces i64)
//       Marching-tetrahedra isosurface (same 6-tet decomposition as the
//       numpy implementation in core/utils/marching_cubes.py).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <algorithm>
#include <cmath>
#include <cstring>
#include <limits>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  double x, y, z;
};

static inline V3 lerp(const V3& a, const V3& b, double va, double vb,
                      double level) {
  double d = vb - va;
  double t = std::fabs(d) < 1e-12 ? 0.5 : (level - va) / d;
  t = std::min(1.0, std::max(0.0, t));
  return {a.x + t * (b.x - a.x), a.y + t * (b.y - a.y), a.z + t * (b.z - a.z)};
}

// ---------------------------------------------------------------------------
// rasterize_mesh
// ---------------------------------------------------------------------------
static PyObject* rasterize_mesh(PyObject*, PyObject* args) {
  PyArrayObject *verts_o, *faces_o, *colors_o;
  int h, w;
  if (!PyArg_ParseTuple(args, "O!O!O!ii", &PyArray_Type, &verts_o,
                        &PyArray_Type, &faces_o, &PyArray_Type, &colors_o, &h,
                        &w))
    return nullptr;

  PyArrayObject* verts = (PyArrayObject*)PyArray_FROM_OTF(
      (PyObject*)verts_o, NPY_FLOAT32, NPY_ARRAY_C_CONTIGUOUS);
  PyArrayObject* faces = (PyArrayObject*)PyArray_FROM_OTF(
      (PyObject*)faces_o, NPY_INT64, NPY_ARRAY_C_CONTIGUOUS);
  PyArrayObject* colors = (PyArrayObject*)PyArray_FROM_OTF(
      (PyObject*)colors_o, NPY_FLOAT32, NPY_ARRAY_C_CONTIGUOUS);
  if (!verts || !faces || !colors) return nullptr;

  npy_intp nF = PyArray_DIM(faces, 0);
  npy_intp C = PyArray_DIM(colors, 1);
  const float* V = (const float*)PyArray_DATA(verts);
  const int64_t* F = (const int64_t*)PyArray_DATA(faces);
  const float* Col = (const float*)PyArray_DATA(colors);

  npy_intp img_dims[3] = {h, w, C};
  npy_intp dep_dims[2] = {h, w};
  PyArrayObject* img =
      (PyArrayObject*)PyArray_ZEROS(3, img_dims, NPY_FLOAT32, 0);
  PyArrayObject* dep =
      (PyArrayObject*)PyArray_ZEROS(2, dep_dims, NPY_FLOAT32, 0);
  float* I = (float*)PyArray_DATA(img);
  float* D = (float*)PyArray_DATA(dep);

  std::vector<float> zbuf((size_t)h * w,
                          std::numeric_limits<float>::infinity());

  for (npy_intp f = 0; f < nF; ++f) {
    int64_t i0 = F[f * 3], i1 = F[f * 3 + 1], i2 = F[f * 3 + 2];
    float x0 = V[i0 * 3], y0 = V[i0 * 3 + 1], z0 = V[i0 * 3 + 2];
    float x1 = V[i1 * 3], y1 = V[i1 * 3 + 1], z1 = V[i1 * 3 + 2];
    float x2 = V[i2 * 3], y2 = V[i2 * 3 + 1], z2 = V[i2 * 3 + 2];

    int xmin = std::max(0, (int)std::floor(std::min({x0, x1, x2})));
    int xmax = std::min(w - 1, (int)std::ceil(std::max({x0, x1, x2})));
    int ymin = std::max(0, (int)std::floor(std::min({y0, y1, y2})));
    int ymax = std::min(h - 1, (int)std::ceil(std::max({y0, y1, y2})));
    if (xmin > xmax || ymin > ymax) continue;

    double denom = (double)(x1 - x0) * (y2 - y0) - (double)(x2 - x0) * (y1 - y0);
    if (std::fabs(denom) < 1e-12) continue;

    for (int py = ymin; py <= ymax; ++py) {
      for (int px = xmin; px <= xmax; ++px) {
        double w1 = ((double)(px - x0) * (y2 - y0) -
                     (double)(x2 - x0) * (py - y0)) / denom;
        double w2 = ((double)(x1 - x0) * (py - y0) -
                     (double)(px - x0) * (y1 - y0)) / denom;
        double w0 = 1.0 - w1 - w2;
        if (w0 < -1e-9 || w1 < -1e-9 || w2 < -1e-9) continue;
        float z = (float)(w0 * z0 + w1 * z1 + w2 * z2);
        size_t idx = (size_t)py * w + px;
        if (z < zbuf[idx]) {
          zbuf[idx] = z;
          D[idx] = z;
          for (npy_intp c = 0; c < C; ++c)
            I[idx * C + c] = (float)(w0 * Col[i0 * C + c] +
                                     w1 * Col[i1 * C + c] +
                                     w2 * Col[i2 * C + c]);
        }
      }
    }
  }

  Py_DECREF(verts);
  Py_DECREF(faces);
  Py_DECREF(colors);
  return Py_BuildValue("NN", (PyObject*)img, (PyObject*)dep);
}

// ---------------------------------------------------------------------------
// marching tetrahedra
// ---------------------------------------------------------------------------
static const int TETS[6][4] = {{0, 5, 1, 3}, {0, 5, 3, 7}, {0, 5, 7, 4},
                               {0, 7, 3, 2}, {0, 7, 2, 6}, {0, 7, 6, 4}};
static const int CORNER[8][3] = {{0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
                                 {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1}};

struct VKey {
  int64_t a, b, c;
  bool operator==(const VKey& o) const {
    return a == o.a && b == o.b && c == o.c;
  }
};
struct VKeyHash {
  size_t operator()(const VKey& k) const {
    size_t h = (size_t)k.a * 73856093u;
    h ^= (size_t)k.b * 19349663u;
    h ^= (size_t)k.c * 83492791u;
    return h;
  }
};

static PyObject* marching_tets(PyObject*, PyObject* args) {
  PyArrayObject* vol_o;
  double level;
  if (!PyArg_ParseTuple(args, "O!d", &PyArray_Type, &vol_o, &level))
    return nullptr;
  PyArrayObject* vol = (PyArrayObject*)PyArray_FROM_OTF(
      (PyObject*)vol_o, NPY_FLOAT32, NPY_ARRAY_C_CONTIGUOUS);
  if (!vol) return nullptr;
  int X = (int)PyArray_DIM(vol, 0), Y = (int)PyArray_DIM(vol, 1),
      Z = (int)PyArray_DIM(vol, 2);
  const float* Vd = (const float*)PyArray_DATA(vol);
  auto at = [&](int x, int y, int z) -> double {
    return Vd[((size_t)x * Y + y) * Z + z];
  };

  std::vector<double> verts;
  std::vector<int64_t> faces;
  std::unordered_map<VKey, int64_t, VKeyHash> vmap;

  auto add_vert = [&](const V3& p) -> int64_t {
    VKey k{(int64_t)llround(p.x * 1e5), (int64_t)llround(p.y * 1e5),
           (int64_t)llround(p.z * 1e5)};
    auto it = vmap.find(k);
    if (it != vmap.end()) return it->second;
    int64_t id = (int64_t)(verts.size() / 3);
    vmap.emplace(k, id);
    verts.push_back(p.x);
    verts.push_back(p.y);
    verts.push_back(p.z);
    return id;
  };
  auto add_tri = [&](const V3& a, const V3& b, const V3& c) {
    int64_t ia = add_vert(a), ib = add_vert(b), ic = add_vert(c);
    if (ia == ib || ib == ic || ia == ic) return;
    faces.push_back(ia);
    faces.push_back(ib);
    faces.push_back(ic);
  };

  Py_BEGIN_ALLOW_THREADS;
  for (int x = 0; x < X - 1; ++x) {
    for (int y = 0; y < Y - 1; ++y) {
      for (int z = 0; z < Z - 1; ++z) {
        double cv[8];
        V3 cp[8];
        bool all_above = true, all_below = true;
        for (int c = 0; c < 8; ++c) {
          int cx = x + CORNER[c][0], cy = y + CORNER[c][1],
              cz = z + CORNER[c][2];
          cv[c] = at(cx, cy, cz);
          cp[c] = {(double)cx, (double)cy, (double)cz};
          all_above &= cv[c] > level;
          all_below &= cv[c] < level;
        }
        if (all_above || all_below) continue;

        for (int t = 0; t < 6; ++t) {
          const int* T = TETS[t];
          int in_mask = 0, n_in = 0;
          for (int i = 0; i < 4; ++i)
            if (cv[T[i]] < level) {
              in_mask |= 1 << i;
              n_in++;
            }
          if (n_in == 0 || n_in == 4) continue;

          int sel[4], other[4], ns = 0, no = 0;
          bool flip = n_in > 2;  // treat minority side as "selected"
          int want = flip ? 0 : 1;
          for (int i = 0; i < 4; ++i) {
            if (((in_mask >> i) & 1) == want)
              sel[ns++] = T[i];
            else
              other[no++] = T[i];
          }
          if (ns == 1) {  // 1 vs 3: one triangle
            V3 e0 = lerp(cp[sel[0]], cp[other[0]], cv[sel[0]], cv[other[0]], level);
            V3 e1 = lerp(cp[sel[0]], cp[other[1]], cv[sel[0]], cv[other[1]], level);
            V3 e2 = lerp(cp[sel[0]], cp[other[2]], cv[sel[0]], cv[other[2]], level);
            add_tri(e0, e1, e2);
          } else if (ns == 2) {  // 2 vs 2: quad -> two triangles
            V3 eac = lerp(cp[sel[0]], cp[other[0]], cv[sel[0]], cv[other[0]], level);
            V3 ead = lerp(cp[sel[0]], cp[other[1]], cv[sel[0]], cv[other[1]], level);
            V3 ebc = lerp(cp[sel[1]], cp[other[0]], cv[sel[1]], cv[other[0]], level);
            V3 ebd = lerp(cp[sel[1]], cp[other[1]], cv[sel[1]], cv[other[1]], level);
            add_tri(eac, ead, ebc);
            add_tri(ebc, ead, ebd);
          }
        }
      }
    }
  }
  Py_END_ALLOW_THREADS;

  npy_intp vdims[2] = {(npy_intp)(verts.size() / 3), 3};
  npy_intp fdims[2] = {(npy_intp)(faces.size() / 3), 3};
  PyArrayObject* va = (PyArrayObject*)PyArray_SimpleNew(2, vdims, NPY_FLOAT32);
  PyArrayObject* fa = (PyArrayObject*)PyArray_SimpleNew(2, fdims, NPY_INT64);
  float* vp = (float*)PyArray_DATA(va);
  for (size_t i = 0; i < verts.size(); ++i) vp[i] = (float)verts[i];
  if (!faces.empty())
    std::memcpy(PyArray_DATA(fa), faces.data(), faces.size() * sizeof(int64_t));

  Py_DECREF(vol);
  return Py_BuildValue("NN", (PyObject*)va, (PyObject*)fa);
}

static PyMethodDef methods[] = {
    {"rasterize_mesh", rasterize_mesh, METH_VARARGS,
     "Z-buffer rasterize (verts, faces, colors, h, w) -> (image, depth)"},
    {"marching_tets", marching_tets, METH_VARARGS,
     "Marching tetrahedra (vol, level) -> (verts, faces)"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_native",
                                       "deep3dmap_tpu_torch native host ops", -1,
                                       methods};

}  // namespace

PyMODINIT_FUNC PyInit__native(void) {
  import_array();
  return PyModule_Create(&moduledef);
}
