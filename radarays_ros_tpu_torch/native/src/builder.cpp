// Host scene builder of radarays_ros_tpu_torch, in C++ (the port's own copy
// of radarays_ros_tpu/native/src/builder.cpp, rewritten where the port's
// tables differ).
//
// Every function here is the native twin of a NumPy function of the port
// and produces the same bytes: the SAH leaf ordering and the median split
// (geom/scene.py:_median_split_order_sah, _median_split_order), the chunk
// AABBs, the plane equations (_triangle_planes), the two device tables
// (edge_coefficients, fetch_rows) and the OBJ reader (geom/mesh.py:
// _load_obj). Floating-point results follow NumPy's float32 operation order
// exactly; the library is built with -ffp-contract=off so that no product
// and sum fuse into one FMA. Parallel loops write disjoint outputs and each
// value is computed by one thread in one order, so no result depends on
// the OpenMP thread count.
//
// A plain C ABI, bound with ctypes by native/builder.py, which also builds
// this file at first use.

#include <algorithm>
#include <array>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <string>
#include <vector>

extern "C" {

// Version of the bytes this builder produces. Bump on any change that
// alters them, together with native/builder.py:BUILDER_VERSION (the NumPy
// build's, which must stay equal): it is folded into the scene-cache key.
int64_t rr_builder_version(void) { return 1; }

}  // extern "C"

namespace {

// --------------------------------------------------------- SAH ordering

struct Sah {
  const float* lo;   // (n, 3) per-triangle AABB minima
  const float* hi;   // (n, 3) maxima
  int64_t tc;        // leaf (chunk) size
  int64_t* ax[3];    // the triangle ids of each node, sorted by each axis
  uint8_t* flag;     // per triangle: in the left child of the node at work
};

// Nodes this large spawn their left child as a task of its own.
constexpr int64_t kTaskMin = 1 << 15;

// One node of the presorted full-sweep SAH build over the id range
// [b, e) of the three axis orders, then its children. At every node all
// 3 axes x all tc-multiple split positions h are scored by
// SA(left) * h + SA(right) * (m - h), the child boxes from prefix and
// suffix min/max scans of the per-triangle AABBs in the axis order; the
// f32 surface areas and the f64 cost in NumPy's order, the first minimum
// of an axis (np.argmin) and the first axis among equal costs. The scans
// keep only the values at the split positions: a running min/max is exact
// whatever it stores. Children inherit each axis order by a stable
// partition on the left-child flag.
void sah_node(const Sah& s, int64_t b, int64_t e) {
  const int64_t m = e - b;
  if (m <= s.tc) return;
  const int64_t n_pos = m / s.tc - 1;
  std::vector<float> pre(6 * n_pos), suf(6 * n_pos);
  double best_cost = 0.0;
  int64_t best_h = -1;
  int best_ax = 0;
  for (int a = 0; a < 3; ++a) {
    const int64_t* ids = s.ax[a] + b;
    float run[6];
    for (int64_t i = 0; i < m; ++i) {          // prefix: [0, h)
      const float* l3 = s.lo + ids[i] * 3;
      const float* h3 = s.hi + ids[i] * 3;
      for (int k = 0; k < 3; ++k) {
        run[k] = i ? std::min(run[k], l3[k]) : l3[k];
        run[3 + k] = i ? std::max(run[3 + k], h3[k]) : h3[k];
      }
      const int64_t p = (i + 1) / s.tc;
      if ((i + 1) % s.tc == 0 && p <= n_pos)
        std::copy(run, run + 6, &pre[6 * (p - 1)]);
    }
    for (int64_t i = m - 1; i >= s.tc; --i) {  // suffix: [h, m)
      const float* l3 = s.lo + ids[i] * 3;
      const float* h3 = s.hi + ids[i] * 3;
      for (int k = 0; k < 3; ++k) {
        run[k] = i < m - 1 ? std::min(run[k], l3[k]) : l3[k];
        run[3 + k] = i < m - 1 ? std::max(run[3 + k], h3[k]) : h3[k];
      }
      if (i % s.tc == 0) std::copy(run, run + 6, &suf[6 * (i / s.tc - 1)]);
    }
    int64_t ax_h = -1;
    double ax_cost = 0.0;
    for (int64_t p = 1; p <= n_pos; ++p) {
      const int64_t h = p * s.tc;
      const float* L = &pre[6 * (p - 1)];
      const float* R = &suf[6 * (p - 1)];
      const float dl0 = L[3] - L[0], dl1 = L[4] - L[1], dl2 = L[5] - L[2];
      const float dr0 = R[3] - R[0], dr1 = R[4] - R[1], dr2 = R[5] - R[2];
      const float sa_l = dl0 * dl1 + dl1 * dl2 + dl2 * dl0;
      const float sa_r = dr0 * dr1 + dr1 * dr2 + dr2 * dr0;
      const double cost = static_cast<double>(sa_l) * static_cast<double>(h)
          + static_cast<double>(sa_r) * static_cast<double>(m - h);
      if (ax_h < 0 || cost < ax_cost) {
        ax_cost = cost;
        ax_h = h;
      }
    }
    if (best_h < 0 || ax_cost < best_cost) {
      best_cost = ax_cost;
      best_h = ax_h;
      best_ax = a;
    }
  }
  for (int64_t i = 0; i < best_h; ++i) s.flag[s.ax[best_ax][b + i]] = 1;
  std::vector<int64_t> right(m - best_h);
  for (int a = 0; a < 3; ++a) {
    int64_t* ids = s.ax[a] + b;
    int64_t w = 0, r = 0;
    for (int64_t i = 0; i < m; ++i) {
      const int64_t id = ids[i];
      if (s.flag[id]) ids[w++] = id;   // w <= i: in place
      else right[r++] = id;
    }
    std::copy(right.begin(), right.end(), ids + best_h);
  }
  for (int64_t i = 0; i < best_h; ++i) s.flag[s.ax[best_ax][b + i]] = 0;
  pre = std::vector<float>();
  suf = std::vector<float>();
  right = std::vector<int64_t>();
  // the children own disjoint id ranges and disjoint triangles (flags)
#pragma omp task if (m >= kTaskMin) firstprivate(b, best_h) shared(s)
  sah_node(s, b, b + best_h);
  sah_node(s, b + best_h, e);
}

}  // namespace

extern "C" {

// SAH leaf ordering of n triangles (n % chunk_size == 0) from their
// centroids and AABBs, (n, 3) f32 each: out (n,) i64 is the permutation of
// geom/scene.py:_median_split_order_sah, leaf after leaf in its DFS order
// (each node's range of the axis-0 order holds its leaves left to right).
void rr_sah_split_order(const float* centers, const float* tri_lo,
                        const float* tri_hi, int64_t n, int64_t chunk_size,
                        int64_t* out) {
  if (n <= 0) return;
  std::vector<int64_t> ax[3];
#pragma omp parallel for schedule(static, 1)
  for (int a = 0; a < 3; ++a) {   // np.argsort(kind="stable") per axis
    ax[a].resize(n);
    std::iota(ax[a].begin(), ax[a].end(), int64_t{0});
    std::stable_sort(ax[a].begin(), ax[a].end(), [&](int64_t x, int64_t y) {
      return centers[x * 3 + a] < centers[y * 3 + a];
    });
  }
  std::vector<uint8_t> flag(n, 0);
  const Sah s{tri_lo, tri_hi, chunk_size,
              {ax[0].data(), ax[1].data(), ax[2].data()}, flag.data()};
#pragma omp parallel
#pragma omp single
  sah_node(s, 0, n);
  std::copy(ax[0].begin(), ax[0].end(), out);
}

// Longest-axis median split into leaves of chunk_size (n % chunk_size ==
// 0), the ordering of RADARAYS_ORDER_VARIANT=median: the contract of
// geom/scene.py:_median_split_order (the same leaves' quality; nth_element
// and np.argpartition may place centroid ties on either side of a split).
void rr_median_split_order(const float* centers, int64_t n,
                           int64_t chunk_size, int64_t* out) {
  if (n <= 0) return;
  std::iota(out, out + n, int64_t{0});
  struct Range { int64_t lo, hi; };
  std::vector<Range> stack{{0, n}};
  while (!stack.empty()) {
    const Range r = stack.back();
    stack.pop_back();
    const int64_t len = r.hi - r.lo;
    if (len <= chunk_size) continue;
    float mn[3], mx[3];
    for (int k = 0; k < 3; ++k) mn[k] = mx[k] = centers[out[r.lo] * 3 + k];
    for (int64_t i = r.lo + 1; i < r.hi; ++i) {
      const float* c = centers + out[i] * 3;
      for (int k = 0; k < 3; ++k) {
        mn[k] = std::min(mn[k], c[k]);
        mx[k] = std::max(mx[k], c[k]);
      }
    }
    int ax = 0;
    for (int k = 1; k < 3; ++k)
      if (mx[k] - mn[k] > mx[ax] - mn[ax]) ax = k;
    int64_t half = ((len / 2) / chunk_size) * chunk_size;
    if (half == 0) half = chunk_size;
    std::nth_element(out + r.lo, out + r.lo + half, out + r.hi,
                     [&](int64_t a, int64_t b) {
                       return centers[a * 3 + ax] < centers[b * 3 + ax];
                     });
    stack.push_back({r.lo + half, r.hi});
    stack.push_back({r.lo, r.lo + half});
  }
}

// Chunk AABBs: verts (C * chunk, 3, 3) f32 -> lo, hi (C, 3), the min and
// max over each chunk's 3 * chunk vertices.
void rr_chunk_aabbs(const float* verts, int64_t n_chunks, int64_t chunk,
                    float* lo_out, float* hi_out) {
#pragma omp parallel for schedule(static)
  for (int64_t c = 0; c < n_chunks; ++c) {
    const float* base = verts + c * chunk * 9;
    float lo[3] = {base[0], base[1], base[2]};
    float hi[3] = {base[0], base[1], base[2]};
    for (int64_t t = 1; t < chunk * 3; ++t) {
      for (int k = 0; k < 3; ++k) {
        const float v = base[t * 3 + k];
        lo[k] = std::min(lo[k], v);
        hi[k] = std::max(hi[k], v);
      }
    }
    std::copy(lo, lo + 3, lo_out + c * 3);
    std::copy(hi, hi + 3, hi_out + c * 3);
  }
}

}  // extern "C"

namespace {

// np.cross of two 3-vectors: each product rounded, then the difference
inline void cross(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// v / np.maximum(np.linalg.norm(v), 1e-30) in f32: the norm is
// sqrtf((x*x + y*y) + z*z), NumPy's order over an axis of 3; np.maximum
// keeps a NaN
inline void unit(float* v) {
  const float norm = std::sqrt((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]);
  const float den = (std::isnan(norm) || norm >= 1e-30f) ? norm : 1e-30f;
  for (int k = 0; k < 3; ++k) v[k] = v[k] / den;
}

// -np.sum(a * b) over an axis of 3: NumPy adds the products in order to
// its identity +0, so that a sum of -0 terms is +0
inline float neg_dot(const float* a, const float* b) {
  return -(((0.0f + a[0] * b[0]) + a[1] * b[1]) + a[2] * b[2]);
}

}  // namespace

extern "C" {

// The plane equations of geom/scene.py:_triangle_planes: per triangle the
// unit normal n = unit(e1 x e2) (normals_out, (n, 3)) and 4 rows of
// planes_o (4n, 4): [n | -n.v0], then per edge (a, b) in (v0, v1), (v1, v2),
// (v2, v0) the unit edge plane m = unit(n x (b - a)) with offset -m.a.
void rr_triangle_planes(const float* verts, int64_t n, float* normals_out,
                        float* planes_o_out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const float* v = verts + i * 9;
    const float* p[3] = {v, v + 3, v + 6};
    float e1[3], e2[3], nrm[3];
    for (int k = 0; k < 3; ++k) {
      e1[k] = p[1][k] - p[0][k];
      e2[k] = p[2][k] - p[0][k];
    }
    cross(e1, e2, nrm);
    unit(nrm);
    std::copy(nrm, nrm + 3, normals_out + i * 3);
    float* po = planes_o_out + i * 16;
    std::copy(nrm, nrm + 3, po);
    po[3] = neg_dot(nrm, p[0]);
    for (int e = 0; e < 3; ++e) {
      const float* a = p[e];
      const float* b = p[(e + 1) % 3];
      const float ab[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
      float m[3];
      cross(nrm, ab, m);
      unit(m);
      float* row = po + 4 * (e + 1);
      std::copy(m, m + 3, row);
      row[3] = neg_dot(m, a);
    }
  }
}

// geom/scene.py:edge_coefficients: planes_o (4T, 4) -> out (T, 22) f32
// [n (3), c, A_0..A_2 (9), B_0..B_2 (9)] with A_k = m_k x n and
// B_k = c_k n - c m_k (each product rounded, then the difference).
void rr_edge_coefficients(const float* planes_o, int64_t n_tris,
                          float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t t = 0; t < n_tris; ++t) {
    const float* p = planes_o + t * 16;
    const float* n = p;
    const float c = p[3];
    float* q = out + t * 22;
    std::copy(n, n + 3, q);
    q[3] = c;
    for (int k = 0; k < 3; ++k) {
      const float* m = p + 4 * (k + 1);
      cross(m, n, q + 4 + 3 * k);
      for (int j = 0; j < 3; ++j) q[13 + 3 * k + j] = m[3] * n[j] - c * m[j];
    }
  }
}

// geom/scene.py:fetch_rows: out (T, 16) f32 winner records [v0, v1 - v0,
// v2 - v0, normal, the int32 object id's bits, 0, 0, 0].
void rr_fetch_rows(const float* verts, const float* normals,
                   const int32_t* obj_ids, int64_t n_tris, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t t = 0; t < n_tris; ++t) {
    const float* v = verts + t * 9;
    float* r = out + t * 16;
    for (int k = 0; k < 3; ++k) {
      r[k] = v[k];
      r[3 + k] = v[3 + k] - v[k];
      r[6 + k] = v[6 + k] - v[k];
      r[9 + k] = normals[t * 3 + k];
    }
    std::memcpy(r + 12, obj_ids + t, 4);
    r[13] = r[14] = r[15] = 0.0f;
  }
}

}  // extern "C"

// ---------------------------------------------------------------- OBJ
//
// The reader of geom/mesh.py:_load_obj, statement by statement. A line ends
// at '\n', '\r' or "\r\n" (Python's universal newlines) and splits on
// whitespace as str.split() does for ASCII text. "v x y z ..." appends a
// vertex (each coordinate parsed to a double, then rounded to f32, as
// float() and np.asarray(..., np.float32) do); "o"/"g" opens an object
// named by its first token (object_<k> without one); "f i j k ..." appends
// the fan (i, j, k), (i, k, l), ... of the first '/'-field of each token,
// an index i > 0 meaning vertex i - 1 and i <= 0 the vertex count so far
// plus i; faces before any o/g belong to object 0. Everything else is
// skipped. Indices are resolved after the whole file is read.
//
// Two calls: rr_obj_count(path, &tris, &objects, &names_len, &err_line)
// then rr_obj_parse(path, verts (T, 3, 3) f32, obj_ids (T,) i32, names
// (names_len bytes, each name followed by '\n'), tris_cap, names_cap).
// Both return 0, or 1 (the file cannot be opened), 2 (a malformed
// statement, its line in err_line; or an index out of range, err_line 0),
// 3 (the file changed between the calls).

namespace {

inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\v' || c == '\f' ||
         (c >= '\x1c' && c <= '\x1f');
}

bool parse_double(const std::string& tok, double* out) {
  if (tok.empty() || tok.find_first_of("xX") != std::string::npos)
    return false;                      // float() takes no hex literal
  char* end = nullptr;
  errno = 0;
  *out = std::strtod(tok.c_str(), &end);
  return end == tok.c_str() + tok.size();
}

bool parse_int(const std::string& tok, int64_t* out) {
  if (tok.empty()) return false;
  char* end = nullptr;
  errno = 0;
  const long long v = std::strtoll(tok.c_str(), &end, 10);
  if (errno == ERANGE || end != tok.c_str() + tok.size()) return false;
  *out = v;
  return true;
}

struct ObjScan {
  std::vector<std::array<float, 3>> verts;
  std::vector<int64_t> corners;      // 3 vertex indices a triangle
  std::vector<int32_t> tri_obj;
  std::vector<std::string> names;
  int64_t err_line = 0;

  // one statement; false if it is malformed
  bool statement(const std::vector<std::string>& t, int32_t* cur) {
    if (t.empty()) return true;
    if (t[0] == "v") {
      double x, y, z;
      if (t.size() < 4 || !parse_double(t[1], &x) ||
          !parse_double(t[2], &y) || !parse_double(t[3], &z))
        return false;
      verts.push_back({static_cast<float>(x), static_cast<float>(y),
                       static_cast<float>(z)});
    } else if (t[0] == "o" || t[0] == "g") {
      names.push_back(t.size() > 1 ? t[1]
                                   : "object_" + std::to_string(names.size()));
      *cur = static_cast<int32_t>(names.size()) - 1;
    } else if (t[0] == "f") {
      std::vector<int64_t> idx;
      for (size_t k = 1; k < t.size(); ++k) {
        int64_t i;
        if (!parse_int(t[k].substr(0, t[k].find('/')), &i)) return false;
        idx.push_back(i > 0 ? i - 1
                            : static_cast<int64_t>(verts.size()) + i);
      }
      for (size_t k = 1; k + 1 < idx.size(); ++k) {
        corners.insert(corners.end(), {idx[0], idx[k], idx[k + 1]});
        tri_obj.push_back(*cur);
      }
    }
    return true;
  }

  int parse(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    int32_t cur = 0;
    int64_t line_no = 0;
    std::vector<std::string> toks;
    std::string tok;
    bool ok = true, after_cr = false;
    auto end_line = [&]() {
      if (!tok.empty()) toks.push_back(std::move(tok));
      tok.clear();
      ++line_no;
      if (ok && !statement(toks, &cur)) {
        ok = false;
        err_line = line_no;
      }
      toks.clear();
    };
    std::vector<char> buf(1 << 16);
    size_t got;
    bool pending = false;               // characters since the last line end
    while (ok && (got = std::fread(buf.data(), 1, buf.size(), f)) > 0) {
      for (size_t i = 0; i < got; ++i) {
        const char c = buf[i];
        if (c == '\n' && after_cr) {   // the '\n' of "\r\n"
          after_cr = false;
          continue;
        }
        after_cr = c == '\r';
        if (c == '\n' || c == '\r') {
          end_line();
          pending = false;
        } else {
          pending = true;
          if (is_space(c)) {
            if (!tok.empty()) toks.push_back(std::move(tok));
            tok.clear();
          } else {
            tok.push_back(c);
          }
        }
      }
    }
    if (ok && pending) end_line();
    std::fclose(f);
    if (!ok) return 2;
    for (const int64_t i : corners)
      if (i < 0 || i >= static_cast<int64_t>(verts.size())) return 2;
    return 0;
  }

  int64_t names_len() const {
    int64_t len = 0;
    for (const auto& n : names) len += static_cast<int64_t>(n.size()) + 1;
    return len;
  }
};

}  // namespace

extern "C" {

int rr_obj_count(const char* path, int64_t* n_tris, int64_t* n_objects,
                 int64_t* names_len, int64_t* err_line) {
  ObjScan scan;
  const int rc = scan.parse(path);
  *err_line = scan.err_line;
  if (rc) return rc;
  *n_tris = static_cast<int64_t>(scan.tri_obj.size());
  *n_objects = static_cast<int64_t>(scan.names.size());
  *names_len = scan.names_len();
  return 0;
}

int rr_obj_parse(const char* path, float* verts_out, int32_t* obj_ids_out,
                 char* names_out, int64_t tris_cap, int64_t names_cap) {
  ObjScan scan;
  const int rc = scan.parse(path);
  if (rc) return rc;
  const int64_t T = static_cast<int64_t>(scan.tri_obj.size());
  if (T != tris_cap || scan.names_len() != names_cap) return 3;
  for (int64_t t = 0; t < T; ++t) {
    for (int k = 0; k < 3; ++k) {
      const auto& v = scan.verts[static_cast<size_t>(scan.corners[t * 3 + k])];
      std::copy(v.begin(), v.end(), verts_out + (t * 3 + k) * 3);
    }
    obj_ids_out[t] = scan.tri_obj[static_cast<size_t>(t)];
  }
  for (const auto& n : scan.names) {
    std::memcpy(names_out, n.data(), n.size());
    names_out += n.size();
    *names_out++ = '\n';
  }
  return 0;
}

}  // extern "C"
