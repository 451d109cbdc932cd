// Native host runtime for the TPU path tracer: SAH BVH builder + OBJ loader.
//
// TPU-native equivalent of the reference's C++ host components:
//   * BVH build: replaces the external madmann91/bvh SweepSahBuilder used by
//     the OpenCL reference's src/BVH/bvh.cpp:43-108, but emits a DFS-threaded
//     (skip-link) node layout for the stackless device traversal in
//     ops/intersect.py instead of the child-pointer layout of
//     include/BVH/bvh.h:24-30.
//   * OBJ import: replaces the Assimp path of
//     the OpenCL reference's src/Models/model_loader.cpp:16-431 with a direct
//     triangle-soup parser + area-weighted smooth normals (the reference's
//     aiProcessPreset_TargetRealtime_Quality post-process does the same).
//
// Exposed as a C ABI consumed via ctypes (runtime/native.py).  The Python
// implementations in scene/bvh_build.py and scene/obj.py are the reference
// semantics; this file is the fast path and must stay behaviorally
// equivalent (tests/test_native.py enforces it).

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdlib>
#include <limits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <numeric>
#include <sstream>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;

constexpr int kLeafSize = 4;        // must match scene/bvh_build.py LEAF_SIZE
constexpr double kTraversalCost = 1.0;
constexpr double kIntersectCost = 1.0;

struct Vec3 {
  float x = 0, y = 0, z = 0;
  Vec3() = default;
  Vec3(float a, float b, float c) : x(a), y(b), z(c) {}
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
  Vec3 min(const Vec3& o) const {
    return {std::min(x, o.x), std::min(y, o.y), std::min(z, o.z)};
  }
  Vec3 max(const Vec3& o) const {
    return {std::max(x, o.x), std::max(y, o.y), std::max(z, o.z)};
  }
};

struct BVHHandle {
  std::vector<float> bmin, bmax;      // [M*3]
  std::vector<int32_t> miss, first, count;  // [M]
  std::vector<int64_t> order;         // [T] new position -> original triangle
};

double half_area(const Vec3& lo, const Vec3& hi) {
  double dx = std::max(0.0f, hi.x - lo.x);
  double dy = std::max(0.0f, hi.y - lo.y);
  double dz = std::max(0.0f, hi.z - lo.z);
  return dx * dy + dy * dz + dz * dx;  // x2 applied by both sides equally
}

struct SplitResult {
  bool valid = false;
  int axis = -1;
  int64_t mid = -1;  // left child gets [begin, begin+mid)
};

// Full-sweep SAH over all 3 axes; mirrors scene/bvh_build.py:_find_split.
SplitResult find_split(const std::vector<Vec3>& lo, const std::vector<Vec3>& hi,
                       const std::vector<Vec3>& centers,
                       std::vector<int64_t>& order, int64_t begin, int64_t end,
                       std::vector<int64_t>& scratch_idx,
                       std::vector<Vec3>& scratch_box) {
  const int64_t count = end - begin;
  SplitResult best;
  if (count <= 2) return best;

  double best_cost = std::numeric_limits<double>::infinity();
  scratch_idx.resize(count);
  // prefix mins/maxs and suffix mins/maxs (2*count boxes)
  scratch_box.resize(4 * count);
  Vec3* pmin = scratch_box.data();
  Vec3* pmax = pmin + count;
  Vec3* smin = pmax + count;
  Vec3* smax = smin + count;

  for (int axis = 0; axis < 3; ++axis) {
    std::iota(scratch_idx.begin(), scratch_idx.end(), int64_t{0});
    std::stable_sort(scratch_idx.begin(), scratch_idx.end(),
                     [&](int64_t a, int64_t b) {
                       return centers[order[begin + a]][axis] <
                              centers[order[begin + b]][axis];
                     });
    for (int64_t i = 0; i < count; ++i) {
      const int64_t tri = order[begin + scratch_idx[i]];
      pmin[i] = i ? pmin[i - 1].min(lo[tri]) : lo[tri];
      pmax[i] = i ? pmax[i - 1].max(hi[tri]) : hi[tri];
    }
    for (int64_t i = count - 1; i >= 0; --i) {
      const int64_t tri = order[begin + scratch_idx[i]];
      smin[i] = (i + 1 < count) ? smin[i + 1].min(lo[tri]) : lo[tri];
      smax[i] = (i + 1 < count) ? smax[i + 1].max(hi[tri]) : hi[tri];
    }
    for (int64_t j = 1; j < count; ++j) {
      const double la = 2.0 * half_area(pmin[j - 1], pmax[j - 1]);
      const double ra = 2.0 * half_area(smin[j], smax[j]);
      const double cost = la * double(j) + ra * double(count - j);
      if (cost < best_cost) {
        best_cost = cost;
        best.axis = axis;
        best.mid = j;
      }
    }
  }

  // leaf-vs-split decision, unnormalized cost / whole surface area
  Vec3 wmin = lo[order[begin]], wmax = hi[order[begin]];
  for (int64_t i = begin + 1; i < end; ++i) {
    wmin = wmin.min(lo[order[i]]);
    wmax = wmax.max(hi[order[i]]);
  }
  const double whole_area = 2.0 * half_area(wmin, wmax);
  const double leaf_cost = kIntersectCost * double(count);
  const double split_cost =
      kTraversalCost + best_cost / std::max(whole_area, 1e-20);
  if (count <= kLeafSize && split_cost >= leaf_cost) return best;  // leaf

  // commit: stable-sort the segment along the winning axis
  std::iota(scratch_idx.begin(), scratch_idx.end(), int64_t{0});
  std::stable_sort(scratch_idx.begin(), scratch_idx.end(),
                   [&](int64_t a, int64_t b) {
                     return centers[order[begin + a]][best.axis] <
                            centers[order[begin + b]][best.axis];
                   });
  std::vector<int64_t> seg(count);
  for (int64_t i = 0; i < count; ++i) seg[i] = order[begin + scratch_idx[i]];
  std::copy(seg.begin(), seg.end(), order.begin() + begin);
  best.valid = true;
  return best;
}

}  // namespace

extern "C" {

const char* prt_last_error() { return g_last_error.c_str(); }

// tri_verts: [n_tris, 3 vertices, 3 floats] row-major.
void* prt_bvh_build(const float* tri_verts, int64_t n_tris) {
  if (n_tris <= 0) {
    g_last_error = "prt_bvh_build: n_tris must be > 0";
    return nullptr;
  }
  std::vector<Vec3> lo(n_tris), hi(n_tris), centers(n_tris);
  for (int64_t t = 0; t < n_tris; ++t) {
    const float* v = tri_verts + t * 9;
    Vec3 a{v[0], v[1], v[2]}, b{v[3], v[4], v[5]}, c{v[6], v[7], v[8]};
    lo[t] = a.min(b).min(c);
    hi[t] = a.max(b).max(c);
    centers[t] = {0.5f * (lo[t].x + hi[t].x), 0.5f * (lo[t].y + hi[t].y),
                  0.5f * (lo[t].z + hi[t].z)};
  }

  auto* h = new BVHHandle();
  h->order.resize(n_tris);
  std::iota(h->order.begin(), h->order.end(), int64_t{0});

  std::vector<int64_t> scratch_idx;
  std::vector<Vec3> scratch_box;
  // preorder emission: push right first so left pops first
  std::vector<std::pair<int64_t, int64_t>> stack;
  stack.emplace_back(0, n_tris);
  while (!stack.empty()) {
    auto [begin, end] = stack.back();
    stack.pop_back();
    Vec3 bmin = lo[h->order[begin]], bmax = hi[h->order[begin]];
    for (int64_t i = begin + 1; i < end; ++i) {
      bmin = bmin.min(lo[h->order[i]]);
      bmax = bmax.max(hi[h->order[i]]);
    }
    h->bmin.insert(h->bmin.end(), {bmin.x, bmin.y, bmin.z});
    h->bmax.insert(h->bmax.end(), {bmax.x, bmax.y, bmax.z});

    SplitResult s = find_split(lo, hi, centers, h->order, begin, end,
                               scratch_idx, scratch_box);
    if (!s.valid) {
      h->first.push_back(int32_t(begin));
      h->count.push_back(int32_t(end - begin));
    } else {
      h->first.push_back(0);
      h->count.push_back(0);
      stack.emplace_back(begin + s.mid, end);  // right
      stack.emplace_back(begin, begin + s.mid);  // left (pops first)
    }
  }

  // thread the preorder tree with miss (skip) links
  const int64_t m = int64_t(h->count.size());
  std::vector<int64_t> subtree_end(m);
  for (int64_t i = m - 1; i >= 0; --i) {
    if (h->count[i] > 0) {
      subtree_end[i] = i + 1;
    } else {
      const int64_t left = i + 1;
      const int64_t right = subtree_end[left];
      subtree_end[i] = subtree_end[right];
    }
  }
  h->miss.assign(m, int32_t(m));
  std::vector<std::pair<int64_t, int64_t>> mstack{{0, m}};
  while (!mstack.empty()) {
    auto [i, link] = mstack.back();
    mstack.pop_back();
    h->miss[i] = int32_t(link);
    if (h->count[i] == 0) {
      const int64_t left = i + 1;
      const int64_t right = subtree_end[left];
      mstack.emplace_back(left, right);
      mstack.emplace_back(right, link);
    }
  }
  return h;
}

int64_t prt_bvh_n_nodes(void* handle) {
  return int64_t(static_cast<BVHHandle*>(handle)->count.size());
}

void prt_bvh_export(void* handle, float* bmin, float* bmax, int32_t* miss,
                    int32_t* first, int32_t* count, int64_t* order) {
  auto* h = static_cast<BVHHandle*>(handle);
  std::memcpy(bmin, h->bmin.data(), h->bmin.size() * sizeof(float));
  std::memcpy(bmax, h->bmax.data(), h->bmax.size() * sizeof(float));
  std::memcpy(miss, h->miss.data(), h->miss.size() * sizeof(int32_t));
  std::memcpy(first, h->first.data(), h->first.size() * sizeof(int32_t));
  std::memcpy(count, h->count.data(), h->count.size() * sizeof(int32_t));
  std::memcpy(order, h->order.data(), h->order.size() * sizeof(int64_t));
}

void prt_bvh_free(void* handle) { delete static_cast<BVHHandle*>(handle); }

// ---------------------------------------------------------------------------
// OBJ loader
// ---------------------------------------------------------------------------

struct MeshHandle {
  std::vector<float> verts;    // [T*9]
  std::vector<float> normals;  // [T*9]
};

void* prt_obj_load(const char* path) {
  std::ifstream in(path);
  if (!in) {
    g_last_error = std::string("prt_obj_load: cannot open ") + path;
    return nullptr;
  }
  std::vector<Vec3> positions, vnormals;
  struct Corner { int64_t vi, ni; };
  std::vector<std::array<Corner, 3>> faces;

  std::string line;
  std::vector<Corner> poly;
  while (std::getline(in, line)) {
    if (line.rfind("v ", 0) == 0) {
      float a, b, c;
      if (std::sscanf(line.c_str() + 2, "%f %f %f", &a, &b, &c) == 3)
        positions.push_back({a, b, c});
    } else if (line.rfind("vn ", 0) == 0) {
      float a, b, c;
      if (std::sscanf(line.c_str() + 3, "%f %f %f", &a, &b, &c) == 3)
        vnormals.push_back({a, b, c});
    } else if (line.rfind("f ", 0) == 0) {
      poly.clear();
      std::istringstream ss(line.substr(2));
      std::string tok;
      while (ss >> tok) {
        // forms: v | v/vt | v//vn | v/vt/vn  (1-based; negative = relative)
        int64_t vi = 0, ni = 0;
        const size_t s1 = tok.find('/');
        if (s1 == std::string::npos) {
          vi = std::strtoll(tok.c_str(), nullptr, 10);
        } else {
          vi = std::strtoll(tok.substr(0, s1).c_str(), nullptr, 10);
          const size_t s2 = tok.find('/', s1 + 1);
          if (s2 != std::string::npos && s2 + 1 < tok.size())
            ni = std::strtoll(tok.c_str() + s2 + 1, nullptr, 10);
        }
        poly.push_back({vi, ni});
      }
      for (size_t k = 1; k + 1 < poly.size(); ++k)  // fan triangulation
        faces.push_back({poly[0], poly[k], poly[k + 1]});
    }
  }
  const int64_t nv = int64_t(positions.size());
  const int64_t nn = int64_t(vnormals.size());
  const int64_t nt = int64_t(faces.size());
  if (nt == 0 || nv == 0) {
    g_last_error = std::string("prt_obj_load: no triangles in ") + path;
    return nullptr;
  }
  auto resolve = [](int64_t i, int64_t n) { return i > 0 ? i - 1 : n + i; };

  auto* h = new MeshHandle();
  h->verts.resize(nt * 9);
  h->normals.resize(nt * 9);
  std::vector<int64_t> tri_vi(nt * 3), tri_ni(nt * 3);
  bool all_have_normals = nn > 0;
  for (int64_t f = 0; f < nt; ++f) {
    for (int c = 0; c < 3; ++c) {
      const auto& corner = faces[f][c];
      const int64_t vi = resolve(corner.vi, nv);
      if (vi < 0 || vi >= nv) {
        g_last_error = "prt_obj_load: vertex index out of range";
        delete h;
        return nullptr;
      }
      tri_vi[f * 3 + c] = vi;
      h->verts[f * 9 + c * 3 + 0] = positions[vi].x;
      h->verts[f * 9 + c * 3 + 1] = positions[vi].y;
      h->verts[f * 9 + c * 3 + 2] = positions[vi].z;
      const int64_t ni = corner.ni ? resolve(corner.ni, nn) : -1;
      tri_ni[f * 3 + c] = ni;
      if (ni < 0) all_have_normals = false;
    }
  }

  if (all_have_normals) {
    for (int64_t f = 0; f < nt; ++f)
      for (int c = 0; c < 3; ++c) {
        const Vec3& n = vnormals[tri_ni[f * 3 + c]];
        h->normals[f * 9 + c * 3 + 0] = n.x;
        h->normals[f * 9 + c * 3 + 1] = n.y;
        h->normals[f * 9 + c * 3 + 2] = n.z;
      }
  } else {
    // area-weighted smooth normals over shared position indices
    std::vector<double> acc(nv * 3, 0.0);
    for (int64_t f = 0; f < nt; ++f) {
      const float* v = h->verts.data() + f * 9;
      const double e1x = v[3] - v[0], e1y = v[4] - v[1], e1z = v[5] - v[2];
      const double e2x = v[6] - v[0], e2y = v[7] - v[1], e2z = v[8] - v[2];
      const double fx = e1y * e2z - e1z * e2y;
      const double fy = e1z * e2x - e1x * e2z;
      const double fz = e1x * e2y - e1y * e2x;
      for (int c = 0; c < 3; ++c) {
        const int64_t vi = tri_vi[f * 3 + c];
        acc[vi * 3 + 0] += fx;
        acc[vi * 3 + 1] += fy;
        acc[vi * 3 + 2] += fz;
      }
    }
    for (int64_t v = 0; v < nv; ++v) {
      const double len = std::sqrt(acc[v * 3] * acc[v * 3] +
                                   acc[v * 3 + 1] * acc[v * 3 + 1] +
                                   acc[v * 3 + 2] * acc[v * 3 + 2]);
      const double inv = 1.0 / std::max(len, 1e-20);
      acc[v * 3] *= inv;
      acc[v * 3 + 1] *= inv;
      acc[v * 3 + 2] *= inv;
    }
    for (int64_t f = 0; f < nt; ++f)
      for (int c = 0; c < 3; ++c) {
        const int64_t vi = tri_vi[f * 3 + c];
        h->normals[f * 9 + c * 3 + 0] = float(acc[vi * 3 + 0]);
        h->normals[f * 9 + c * 3 + 1] = float(acc[vi * 3 + 1]);
        h->normals[f * 9 + c * 3 + 2] = float(acc[vi * 3 + 2]);
      }
  }

  // normalize defensively (matches scene/obj.py:72-74)
  for (int64_t i = 0; i < nt * 3; ++i) {
    float* n = h->normals.data() + i * 3;
    const float len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    const float inv = 1.0f / std::max(len, 1e-20f);
    n[0] *= inv;
    n[1] *= inv;
    n[2] *= inv;
  }
  return h;
}

int64_t prt_obj_n_tris(void* handle) {
  return int64_t(static_cast<MeshHandle*>(handle)->verts.size() / 9);
}

void prt_obj_export(void* handle, float* verts, float* normals) {
  auto* h = static_cast<MeshHandle*>(handle);
  std::memcpy(verts, h->verts.data(), h->verts.size() * sizeof(float));
  std::memcpy(normals, h->normals.data(), h->normals.size() * sizeof(float));
}

void prt_obj_free(void* handle) { delete static_cast<MeshHandle*>(handle); }

}  // extern "C"
